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

The kernel reads through a ReadPlan of the walk (read_plan: the slots
sorted by flat corner offset, cut into rows of at most ROW_SLOTS slots
within one tile of TILE floats, each row with its range and a mask of the
32-byte units its slots touch, each slot with its offset in its tile):
chunk by chunk of CHUNK_IMAGES images it streams each row's touched units
once into shared memory and writes each slot's d values as one sector of
an (n, CHUNK_IMAGES) scratch in L2, then decodes the rows from the scratch
in slot order. The pipeline caches a walk's plan in the walk's own cache
entry where the kernel will read it (pipeline/batch.py
_walk_indices_device, uses_plan) and hands it in as `plan=`; a call
without one builds one. Every build counts in PLANS_BUILT.

The wrapper launches the kernel for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes
read_decode_plain only for CPU tensors. `LAUNCHES` counts its launches
(one cooperative launch a call) under KERNEL_READ_DECODE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.spectral import corner
from steganosaurus_tpu_torch.spectral.corner_kernels import (_check_rc,
                                                              _device, _need)
from steganosaurus_tpu_torch.utils.spans import span

KERNEL_READ_DECODE = "corner_read_decode"
# calls of the eager read chain (QIM, per-image walks): not a kernel
KERNEL_READ_EAGER = "corner_read_eager"
LAUNCHES = {KERNEL_READ_DECODE: 0, KERNEL_READ_EAGER: 0}
# read plans built (read_plan): the warm main path builds none
PLANS_BUILT = 0
HEADER_REP = 3
PAYLOAD_REPS = (7, 1)
SOFT_MODES = {None: 0, "bf16": 1, "f32": 2}
# csrc/corner_read_decode.cu: floats of a plan tile (its TILE; a row's mask
# has a bit for each 32-byte unit of its tile), slots of a plan row at most
# (ROW_SLOTS), images of a chunk (its CHUNK: a slot's scratch entry)
TILE = 1024
MASK_WORDS = TILE // 8 // 32
ROW_SLOTS = 512
CHUNK_IMAGES = 8


class ReadPlan(NamedTuple):
    """The kernel's read plan of a shared walk over (3, Ky, Kx) corners:
    order (n,) int32 the slots sorted stably by flat offset (plane*Ky +
    y)*Kx + x; offs (n rounded up to even,) int16 each sorted slot's offset
    in its TILE-float tile (the pad 0); rows (R, 3 + MASK_WORDS) int32 the
    sorted list cut at each tile's edge and after every ROW_SLOTS slots of
    a tile: a row's tile index (its first float at index*TILE), its first
    and one past its last position in order, then the bits of the 32-byte
    units (8 floats) of the tile its slots touch, unit u at bit u % 32 of
    word u // 32."""
    order: torch.Tensor
    offs: torch.Tensor
    rows: torch.Tensor
    Ky: int
    Kx: int

    @property
    def nbytes(self) -> int:
        """Bytes of the plan's tensors: what the kernel reads of it."""
        return sum(t.numel() * t.element_size()
                   for t in (self.order, self.offs, self.rows))


def uses_plan(device: torch.device) -> bool:
    """Whether read_decode reads through a plan on `device`: on CUDA, where
    it launches the kernel; the CPU's plain version needs none."""
    return device.type == "cuda"


def read_plan(plane, y, x, Ky: int, Kx: int) -> ReadPlan:
    """The ReadPlan of the shared walk plane/y/x (n,) over (3, Ky, Kx)
    corners, in torch ops on the walk's device. Every slot keeps its own
    entry: a bin read by several slots (the bucket's tail padding repeats
    the last bin) appears once for each. Counted in PLANS_BUILT, and
    spanned as stt.read.plan_build (utils/spans.py)."""
    global PLANS_BUILT
    if plane.dim() != 1 or 3 * Ky * Kx > 2**31 - 1:
        raise ValueError(f"read_plan: a shared (n,) walk over corners of "
                         f"fewer than 2**31 floats, got {tuple(plane.shape)} "
                         f"and {Ky}x{Kx}")
    with span("stt.read.plan_build"):
        dev = plane.device
        flat = (plane.long() * Ky + y.long()) * Kx + x.long()
        offs, order = torch.sort(flat, stable=True)
        n = offs.numel()
        tile = offs // TILE
        inside = offs % TILE
        # a new row where the tile changes and after each ROW_SLOTS of a tile
        _, counts = torch.unique_consecutive(tile, return_counts=True)
        first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
        new = (torch.arange(n, device=dev) - first) % ROW_SLOTS == 0
        starts = torch.nonzero(new).flatten()
        ends = torch.cat([starts[1:], starts.new_full((min(n, 1),), n)])
        row = torch.cumsum(new, 0) - 1
        touched = torch.unique(row * (TILE // 8) + inside // 8)
        mask = torch.zeros(starts.numel() * MASK_WORDS, dtype=torch.int64,
                           device=dev).index_add_(
            0, touched // 32, torch.ones_like(touched) << touched % 32)
        mask = torch.where(mask >= 2**31, mask - 2**32, mask)
        rows = torch.cat([torch.stack([tile[starts], starts, ends], 1),
                          mask.view(-1, MASK_WORDS)], 1).to(torch.int32)
        PLANS_BUILT += 1
        return ReadPlan(order.to(torch.int32),
                        torch.nn.functional.pad(inside, (0, n % 2)).to(
                            torch.int16),
                        rows.contiguous(), Ky, Kx)


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
    return decode_rows(d, hdr_stream_bits, payload_rep, hard, soft)


def decode_rows(d: torch.Tensor, hdr_stream_bits: int, payload_rep: int,
                hard: bool = True, soft: str | None = None):
    """(hard rows or None, soft rows or None) of read_decode_plain from the
    walk's decision values d (B, n) f32."""
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
            raise ValueError(f"decode_rows: soft must be None, 'bf16' "
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
                soft: str | None = None, plan: ReadPlan | None = None):
    """(hard rows (B, hw + pw) int32 or None, soft rows (B, hw + pw + cw)
    int32 or None) of the corner spectrum ci (B, 3, Ky, Kx) f32 read at the
    shared walk plane/y/x (n,) int64 (row_words gives hw, pw, cw): cr, cjd
    and sjd (n,) f32 under jitter, else None; ssa = sign(sin alpha); soft
    None, "bf16" or "f32"; plan the walk's ReadPlan or None (one is then
    built). CUDA tensors launch csrc/corner_read_decode.cu on the current
    stream; CPU tensors take read_decode_plain, which needs no plan."""
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
    if B == 0 or hw + pw == 0:
        return hard_rows, soft_rows
    if plan is not None and ((plan.Ky, plan.Kx) != (Ky, Kx)
                             or plan.order.shape != (n,)
                             or plan.offs.shape != (n + n % 2,)
                             or plan.rows.device != dev):
        raise ValueError(f"{name}: a plan of {plan.order.shape[0]} slots "
                         f"over {plan.Ky}x{plan.Kx} corners on "
                         f"{plan.rows.device} for a {n}-slot walk over "
                         f"{Ky}x{Kx} on {dev}")
    if plan is None:
        plan = read_plan(plane, y, x, Ky, Kx)
    from steganosaurus_tpu_torch import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty((n, CHUNK_IMAGES), dtype=torch.float32,
                              device=dev)
        arrive = torch.zeros((1,), dtype=torch.int32, device=dev)
        rc = _build.kernel_library().corner_read_decode(
            ci.data_ptr(), ptr(cr if cjd is not None else None),
            plan.order.data_ptr(), plan.offs.data_ptr(), plan.rows.data_ptr(),
            ptr(cjd), ptr(sjd), scratch.data_ptr(), arrive.data_ptr(),
            ptr(hard_rows), ptr(soft_rows), B, Ky, Kx, n, plan.rows.shape[0],
            hdr_stream_bits, payload_rep, SOFT_MODES[soft], float(ssa),
            stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return hard_rows, soft_rows
