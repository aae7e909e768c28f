"""Batch device cores of the corner fast path (single device).

The port's twin of the corner half of steganosaurus_tpu/parallel/batch.py.
JAX builds each core as a cached jitted factory; here each is a plain
function that PyTorch runs eagerly on the device of its inputs, with the
static configuration passed as keyword arguments.

- corner_statics_core: the static slot map `pos` of a walk, and the cos/sin
  jitter maps `cjd`/`sjd` when Params.jitter != 0.
- _frame_from_words: stream words -> Rep-3/Rep-7 ECC frame bits (the
  equal-length path; unequal lengths upload host-built frames instead).
- corner_embed_core: forward corner DFT -> dense hard write -> write
  floor -> inverse corner DFT -> u8 stego.
- corner_extract_fused_core: forward corner DFT -> decision values at the
  walk bins -> Rep-3 header + Rep-7 payload words, hard and (optionally)
  matched-filter soft.
- corner_soft_extract_core: the soft-decision retry pass (f32 decision
  values, matched-filter combining).
- corner_raw_bits_core: the raw (pre-ECC) bits at the walk bins, for the
  channel report.

The JAX single-chip cores pack 32 images per i32 word before every bit
gather because TPU gathers pay a full HBM granule per row
(steganosaurus_tpu/parallel/batch.py:465-473); the port gathers per image
directly and has no batch packing.
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch import spectral
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.spectral import corner

HEADER_BITS = 304    # 38 header bytes
HEADER_REP = 3
PAYLOAD_REP = 7


def corner_statics_core(plane, y, x, Ky: int, Kx: int, bucket: int,
                        jit=None) -> tuple[torch.Tensor, ...]:
    """Static corner maps of a walk: (pos,), or (pos, cjd, sjd) when the
    walk's per-slot jitter angles `jit` are given (Params.jitter != 0).

    pos: (3, Ky, Kx) int64, the walk slot owning each corner bin, and
    `bucket` where no walk bin lives. cjd/sjd: (3, Ky, Kx) f32 cos/sin of
    the owning slot's jitter, 1 and 0 elsewhere. plane/y/x/jit: the walk's
    (bucket,) tensors, tail-padded by repeating the last real bin. The
    padded duplicates carry the frame's last bit and the last bin's jitter,
    so which of them the scatter keeps does not matter."""
    dev = plane.device
    idx = (plane, y, x)
    pos = torch.full((3, Ky, Kx), bucket, dtype=torch.int64, device=dev)
    pos.index_put_(idx, torch.arange(bucket, dtype=torch.int64, device=dev))
    if jit is None:
        return (pos,)
    cjd = torch.ones((3, Ky, Kx), dtype=torch.float32, device=dev)
    sjd = torch.zeros((3, Ky, Kx), dtype=torch.float32, device=dev)
    cjd.index_put_(idx, torch.cos(jit))
    sjd.index_put_(idx, torch.sin(jit))
    return pos, cjd, sjd


def statics_from_numpy(maps, device) -> tuple[torch.Tensor, ...]:
    """Carry static corner maps built elsewhere — e.g. the JAX package's
    _corner_statics_device maps pulled to numpy — into the port's tensors on
    `device`: integer maps (pos) become int64, float maps float32."""
    out = []
    for a in maps:
        a = np.asarray(a)
        dt = torch.int64 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        out.append(torch.tensor(a, dtype=dt, device=device))  # a copy
    return tuple(out)


def _frame_from_words(words: torch.Tensor, stream_bytes: int,
                      bucket: int) -> torch.Tensor:
    """(B, ceil(stream_bytes/4)) int32 big-endian words of header||ct||tag
    -> (B, bucket) u8 ECC frame bits: Rep-3 over the 304 header bits, Rep-7
    over the payload bits (reference frame layout, steganosaur.cpp:986-995),
    tail-padded by repeating each image's last bit."""
    nwords = -(-stream_bytes // 4)
    nmax = HEADER_BITS * HEADER_REP + (stream_bytes - 38) * 8 * PAYLOAD_REP
    bits = bit_ops.unpack_bits_words(words, nwords * 32)[:, :stream_bytes * 8]
    frame = torch.cat([ecc.rep_encode(bits[:, :HEADER_BITS], HEADER_REP),
                       ecc.rep_encode(bits[:, HEADER_BITS:], PAYLOAD_REP)],
                      dim=1)
    if bucket > nmax:
        frame = torch.cat(
            [frame, frame[:, -1:].expand(frame.shape[0], bucket - nmax)],
            dim=1)
    return frame


def _planes_u8(imgs: torch.Tensor, layout: str) -> torch.Tensor:
    """(B, 3, H, W) contiguous u8 view of the batch in either layout."""
    if layout == "nchw":
        return imgs.contiguous()
    return imgs.permute(0, 3, 1, 2).contiguous()


def _cos_sin(alpha: float):
    """cos/sin of alpha in f32, as 0-dim host tensors: they broadcast into
    device math as scalars, with no host-to-device copy."""
    a = torch.tensor(alpha, dtype=torch.float32)
    return torch.cos(a), torch.sin(a)


def corner_embed_core(imgs: torch.Tensor, frame: torch.Tensor, maps,
                      alpha: float, *, Ky: int, Kx: int, center: bool,
                      layout: str, floor: float) -> torch.Tensor:
    """Corner embed, single device: (imgs u8 in `layout`, frame (B, bucket)
    u8 ECC frame bits, maps (pos[, cjd, sjd]) from corner_statics_core) ->
    u8 stego in the same layout.

    Forward corner DFT -> each bin's frame bit through `pos` -> dense hard
    write_delta (jittered when the maps carry cjd/sjd) -> write floor
    (floor > 0) -> inverse corner DFT -> planes + delta -> floor(x + 0.5)
    clamped to [0, 255] (round half away from zero on the surviving range,
    as the reference; torch.round would round half to even)."""
    planes = _planes_u8(imgs, layout)
    B, _, H, W = planes.shape
    pos, jit_maps = maps[0], tuple(maps[1:])
    bucket = frame.shape[1]
    mode = corner.precision()
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    cr, ci = corner.fwd_corner(planes, center, Ky, Kx, tabs, mode)
    # sentinel column `bucket` (no walk bin) reads 0; the mask zeroes it
    table = torch.cat([frame, frame.new_zeros((B, 1))], dim=1)
    bit = table[:, pos.reshape(-1)].reshape(B, 3, Ky, Kx)
    sign = bit.to(torch.float32) * 2.0 - 1.0
    mask = (pos < bucket).to(torch.float32)
    dr, di = corner.write_delta(cr, ci, sign, mask, *_cos_sin(alpha),
                                *jit_maps)
    if floor:
        dr, di = corner.apply_write_floor(dr, di, cr, ci, floor,
                                          float(H) * float(W))
    del cr, ci, sign
    t = corner.ifft_corner_real(dr, di, H, W, tabs, mode)
    del dr, di
    t = spectral.apply_center(t, center)
    out = t.add_(planes).add_(0.5).floor_().clamp_(0.0, 255.0)
    out = out.to(torch.uint8)
    if layout != "nchw":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


def _decode_sections(raw: torch.Tensor, hdr_stream_bits: int) -> torch.Tensor:
    """(B, n) hard bits -> (B, words) int32: Rep-3 header words (when
    hdr_stream_bits) then Rep-7 payload words, MSB-first packed."""
    outs = []
    if hdr_stream_bits:
        outs.append(bit_ops.pack_bits_words(
            ecc.rep_decode(raw[:, :hdr_stream_bits], HEADER_REP)))
    outs.append(bit_ops.pack_bits_words(
        ecc.rep_decode(raw[:, hdr_stream_bits:], PAYLOAD_REP)))
    return torch.cat(outs, dim=1)


def _decode_sections_soft(d: torch.Tensor,
                          hdr_stream_bits: int) -> torch.Tensor:
    """Matched-filter twin of _decode_sections over decision values d."""
    outs = []
    if hdr_stream_bits:
        outs.append(bit_ops.pack_bits_words(
            ecc.rep_decode_soft(d[:, :hdr_stream_bits], HEADER_REP)))
    outs.append(bit_ops.pack_bits_words(
        ecc.rep_decode_soft(d[:, hdr_stream_bits:], PAYLOAD_REP)))
    return torch.cat(outs, dim=1)


def _walk_decisions(imgs: torch.Tensor, alpha: float, plane, y, x, *,
                    Ky: int, Kx: int, center: bool, layout: str,
                    jit=None) -> torch.Tensor:
    """(B, n) f32 decision values d at the walk bins plane/y/x (n,):
    forward corner DFT, then d = sign(sin a) * (Im C * cos jd - Re C *
    sin jd) (spectral/corner.py decision_values), jd the bins' jitter
    angles `jit` (n,). The JAX cores gather the same products from dense
    cos/sin jitter maps; each walk bin's map entry is cos/sin of its own
    slot's angle, so the values are the same. Without jitter (jit None) d
    needs Im C alone, and Re C is freed as soon as the DFT returns."""
    planes = _planes_u8(imgs, layout)
    _, _, H, W = planes.shape
    mode = corner.precision()
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    cr, ci = corner.fwd_corner(planes, center, Ky, Kx, tabs, mode)
    ssa = float(np.sign(np.sin(np.float32(alpha))))
    if jit is None:
        del cr
        return corner.decision_values(ci[:, plane, y, x], ssa)
    return corner.decision_values(ci[:, plane, y, x], ssa, cr[:, plane, y, x],
                                  torch.cos(jit), torch.sin(jit))


def corner_extract_fused_core(imgs: torch.Tensor, alpha: float, plane, y, x,
                              *, Ky: int, Kx: int, center: bool, layout: str,
                              hdr_stream_bits: int, with_soft: bool,
                              jit=None):
    """Corner extract: (imgs u8 in `layout`, walk plane/y/x (n,) and their
    jitter angles jit (n,) or None) -> (B, words) int32 decoded rows laid
    out [hdr words | payload words] (the header section, 10 words = 38
    bytes + 2 pad, only when hdr_stream_bits), or (hard, soft) rows when
    with_soft.

    The hard bit at a bin is d >= 0 (_walk_decisions). The soft rows
    combine each group's copies by the sum of d, with d rounded to bf16
    first, as the JAX core does before its gather."""
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit)
    hard = _decode_sections((d >= 0).to(torch.uint8), hdr_stream_bits)
    if not with_soft:
        return hard
    soft = _decode_sections_soft(d.to(torch.bfloat16).to(torch.float32),
                                 hdr_stream_bits)
    return hard, soft


def corner_soft_extract_core(imgs: torch.Tensor, alpha: float, plane, y, x,
                             *, Ky: int, Kx: int, center: bool, layout: str,
                             hdr_stream_bits: int, jit=None):
    """The soft-decision retry pass (JAX corner_soft_extract_core, shared
    walk, Rep-7): matched-filter decode of the Rep-3 header and Rep-7
    payload copies from f32 decision values (no bf16 rounding, unlike the
    fused pass's inline soft rows). Returns (B, words) int32 rows in the
    corner_extract_fused_core layout."""
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit)
    return _decode_sections_soft(d, hdr_stream_bits)


def corner_raw_bits_core(imgs: torch.Tensor, alpha: float, plane, y, x, *,
                         Ky: int, Kx: int, center: bool, layout: str,
                         jit=None) -> torch.Tensor:
    """Raw (pre-ECC) bits at the walk bins, packed MSB first into (B,
    ceil(n/32)) int32 words: the channel report's read (JAX
    corner_bits_core + corner_gather_raw_core, without the batch
    packing)."""
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit)
    return bit_ops.pack_bits_words((d >= 0).to(torch.uint8))
