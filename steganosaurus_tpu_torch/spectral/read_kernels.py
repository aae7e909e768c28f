"""The extract's walk read and repetition decode (K5): the hand-written
Hopper kernel and its plain PyTorch version.

XLA fuses this stage of steganosaurus_tpu/parallel/batch.py:
corner_extract_fused_core (and of its soft-retry and channel-report twins)
for the TPU; run as eager torch it is some twenty launches after the
forward DFT: the gather ci[:, plane, y, x], the decision values, the
repetition reductions, the word packing and their copies, each through
HBM. csrc/corner_read_decode.cu replaces them: read_decode reads the walk
bins of the forward corner spectrum and writes the decoded rows, with no
(B, n) tensor in HBM.

For image b and walk slot s (a shared walk: (n,) int64 plane/y/x):

    d = (ci * cjd[s] - cr * sjd[s]) * ssa,  or  d = ci * ssa  (no jitter)

with ssa = sign(sin alpha) and cjd/sjd torch.cos and torch.sin of the
slots' jitter angles. The hard row holds the header's Rep-3 majorities
(over its first hdr_stream_bits slots, when there are any) then the
payload's Rep-7 majorities, or under the RS wire (payload_rep 1) its raw
bits, each section packed MSB first into int32 words (a trailing partial
group dropped, the last word zero-padded). The soft row has the same
layout from each group's sum of d taken left to right in f32 (soft="bf16":
each d rounded to bf16 first, as the fused pass does; soft="f32": the
retry pass's values), and under the RS wire the payload's sign bits then
each coded byte's confidence, min |d| over its 8 bits, as f32 bits: the
layout pipeline.batch._ExtractJob._soft_sections parses.

QIM reads (atan2 and cos, which the kernel would not match bit for bit
cheaply) and per-image (B, n) walks stay on the eager chain
(parallel/batch.py _walk_decisions); each call that takes it counts under
KERNEL_READ_EAGER, so a run can show that the main path never does.

The wrapper launches the kernel for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes
read_decode_plain only for CPU tensors. `LAUNCHES` counts the kernel's
launches under KERNEL_READ_DECODE, one per call that launches.
"""

from __future__ import annotations

import torch

from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.spectral import corner
from steganosaurus_tpu_torch.spectral.corner_kernels import (_check_rc,
                                                              _device, _need)

KERNEL_READ_DECODE = "corner_read_decode"
# calls of the eager read chain (QIM, per-image walks): not a kernel
KERNEL_READ_EAGER = "corner_read_eager"
LAUNCHES = {KERNEL_READ_DECODE: 0, KERNEL_READ_EAGER: 0}
HEADER_REP = 3
PAYLOAD_REPS = (7, 1)
SOFT_MODES = {None: 0, "bf16": 1, "f32": 2}
# csrc/corner_read_decode.cu: output words (warps) a block; grid.y takes
# as many interleaved image groups as give about GRID_FILL blocks an SM (at
# 4K: 2, which measured 18% faster than 1 and level with 4;
# tools/k5_ablation_torch.py)
WORDS_PER_BLOCK = 32
GRID_FILL = 2


def row_words(n: int, hdr_stream_bits: int, payload_rep: int,
              soft: bool = False) -> tuple[int, int, int]:
    """(header words, payload words, confidence words) of a row over n walk
    slots; the confidences (RS wire, soft rows only) are (n - hdr) / 8."""
    hw = -(-(hdr_stream_bits // HEADER_REP) // 32)
    pw = -(-((n - hdr_stream_bits) // payload_rep) // 32)
    cw = (n - hdr_stream_bits) // 8 if soft and payload_rep == 1 else 0
    return hw, pw, cw


def _left_sum(g: torch.Tensor) -> torch.Tensor:
    """(B, G, rep) -> (B, G): each group's sum taken left to right in its
    own dtype, one rounding an add."""
    s = g[..., 0]
    for k in range(1, g.shape[-1]):
        s = s + g[..., k]
    return s


def read_decode_plain(ci, plane, y, x, ssa: float, cr=None, cjd=None,
                      sjd=None, *, hdr_stream_bits: int, payload_rep: int,
                      hard: bool = True, soft: str | None = None):
    """(hard rows or None, soft rows or None) of read_decode, in torch ops:
    the gather, the decision values, the majorities (ops/ecc.rep_decode)
    and left-to-right sums, the packing (ops/bits.pack_bits_words)."""
    pl = plane.long()
    d = corner.decision_values(
        ci[:, pl, y.long(), x.long()], ssa,
        None if cjd is None else cr[:, pl, y.long(), x.long()], cjd, sjd)
    hdr = hdr_stream_bits
    sections = ([(slice(0, hdr), HEADER_REP)] if hdr else []) + \
        [(slice(hdr, None), payload_rep)]
    hard_rows = None
    if hard:
        bits = (d >= 0).to(torch.uint8)
        hard_rows = torch.cat([
            bit_ops.pack_bits_words(ecc.rep_decode(bits[:, s], r))
            for s, r in sections], dim=1)
    soft_rows = None
    if soft is not None:
        if soft not in ("bf16", "f32"):
            raise ValueError(f"read_decode_plain: soft must be None, 'bf16' "
                             f"or 'f32', got {soft!r}")
        v = d.to(torch.bfloat16).to(torch.float32) if soft == "bf16" else d
        outs = [bit_ops.pack_bits_words(_left_sum(ecc._groups(v[:, s], r))
                                        >= 0)
                for s, r in sections]
        if payload_rep == 1:
            pay = v[:, hdr:]
            conf = pay.abs().reshape(pay.shape[0], -1, 8).amin(-1)
            outs.append(conf.view(torch.int32))
        soft_rows = torch.cat(outs, dim=1)
    return hard_rows, soft_rows


def read_decode(ci, plane, y, x, ssa: float, cr=None, cjd=None, sjd=None, *,
                hdr_stream_bits: int, payload_rep: int, hard: bool = True,
                soft: str | None = None):
    """(hard rows (B, hw + pw) int32 or None, soft rows (B, hw + pw + cw)
    int32 or None) of the corner spectrum ci (B, 3, Ky, Kx) f32 read at the
    shared walk plane/y/x (n,) int64 (row_words gives hw, pw, cw): cr, cjd
    and sjd (n,) f32 under jitter, else None; ssa = sign(sin alpha); soft
    None, "bf16" or "f32". CUDA tensors launch csrc/corner_read_decode.cu
    on the current stream; CPU tensors take read_decode_plain."""
    name = KERNEL_READ_DECODE
    kind = _device(name, ci, (cr, plane, y, x, cjd, sjd))
    if payload_rep not in PAYLOAD_REPS:
        raise ValueError(f"{name}: payload_rep must be 7 or 1, got "
                         f"{payload_rep}")
    if soft not in SOFT_MODES:
        raise ValueError(f"{name}: soft must be None, 'bf16' or 'f32', got "
                         f"{soft!r}")
    if not hard and soft is None:
        raise ValueError(f"{name}: asked for no row")
    if (cjd is None) != (sjd is None) or (cjd is not None and cr is None):
        raise ValueError(f"{name}: jitter needs cr, cjd and sjd together")
    n = plane.shape[0]
    if plane.dim() != 1 or not 0 <= hdr_stream_bits <= n:
        raise ValueError(f"{name}: a shared (n,) walk with n >= "
                         f"hdr_stream_bits, got {tuple(plane.shape)} and "
                         f"{hdr_stream_bits}")
    if soft and payload_rep == 1 and (n - hdr_stream_bits) % 8:
        raise ValueError(f"{name}: the RS confidences need whole bytes, got "
                         f"{n - hdr_stream_bits} payload slots")
    if kind == "cpu":
        return read_decode_plain(ci, plane, y, x, ssa, cr, cjd, sjd,
                                 hdr_stream_bits=hdr_stream_bits,
                                 payload_rep=payload_rep, hard=hard,
                                 soft=soft)
    if ci.dim() != 4 or ci.shape[1] != 3:
        raise ValueError(f"{name}: ci must be (B, 3, Ky, Kx), got "
                         f"{tuple(ci.shape)}")
    _need(name, "ci", ci, torch.float32, ci.shape)
    for what, t in (("plane", plane), ("y", y), ("x", x)):
        _need(name, what, t, torch.int64, (n,))
    if cjd is not None:
        _need(name, "cr", cr, torch.float32, ci.shape)
        _need(name, "cjd", cjd, torch.float32, (n,))
        _need(name, "sjd", sjd, torch.float32, (n,))
    B, _, Ky, Kx = ci.shape
    hw, pw, cw = row_words(n, hdr_stream_bits, payload_rep, bool(soft))
    dev = ci.device
    hard_rows = (torch.empty((B, hw + pw), dtype=torch.int32, device=dev)
                 if hard else None)
    soft_rows = (torch.empty((B, hw + pw + cw), dtype=torch.int32,
                             device=dev) if soft else None)
    blocks = -(-hw // WORDS_PER_BLOCK) + -(-pw // WORDS_PER_BLOCK)
    if B == 0 or blocks == 0:
        return hard_rows, soft_rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = max(1, min(B, GRID_FILL * sms // blocks))
    from steganosaurus_tpu_torch import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.kernel_library().corner_read_decode(
            ci.data_ptr(), ptr(cr if cjd is not None else None),
            plane.data_ptr(), y.data_ptr(), x.data_ptr(), ptr(cjd), ptr(sjd),
            ptr(hard_rows), ptr(soft_rows), B, Ky, Kx, n, hdr_stream_bits,
            payload_rep, SOFT_MODES[soft], groups, float(ssa), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return hard_rows, soft_rows
