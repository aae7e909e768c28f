"""The embed's dense corner write, write floor (K3) and u8 epilogue (K4e):
the hand-written Hopper kernels and their plain PyTorch versions.

XLA fuses these stages of steganosaurus_tpu/parallel/batch.py:
corner_embed_core for the TPU; run as eager torch they are some forty
launches, each a pass over the (B, 3, Ky, Kx) corner or the (B, 3, H, W)
image batch through HBM. Two CUDA sources replace them:

- csrc/corner_write_floor.cu (K3), two entry points:
  - write_floor: each corner bin's frame bit through the int32 slot map
    `pos`, the hard or soft write (corner.write_delta, jitter and amplitude
    maps optional) and, with a floor, the per-image boost
    (corner.apply_write_floor), in one call;
  - floor_only: the floor over a delta made elsewhere (the QIM write and
    the per-image-walk scatter, whose writes stay eager torch).
- csrc/corner_epilogue.cu (K4e), epilogue: the unscaled inverse DFT t ->
  t * f32(1/(H*W)), the centering sign, + planes, floor(x + 0.5), the clamp
  to [0, 255], u8, stored NCHW or NHWC.

Each wrapper launches its kernel for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes its plain
version only for CPU tensors. `LAUNCHES` counts each entry point's launches
under its own name, one per call that launches, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch import spectral
from steganosaurus_tpu_torch.spectral import corner

KERNEL_WRITE_FLOOR = "corner_write_floor"
KERNEL_FLOOR_ONLY = "corner_floor_only"
KERNEL_EPILOGUE = "corner_epilogue"
LAUNCHES = {KERNEL_WRITE_FLOOR: 0, KERNEL_FLOOR_ONLY: 0, KERNEL_EPILOGUE: 0}
# K3's reduction: THREADS threads a block, each summing PER_THREAD bins of
# one image (bins k*THREADS apart), so a block covers CHUNK bins
THREADS, PER_THREAD = 256, 16
CHUNK = THREADS * PER_THREAD


# --- plain versions ----------------------------------------------------------

def bit_signs(pos: torch.Tensor, frame: torch.Tensor):
    """(sign, mask) of a shared walk's corner: each bin's frame bit through
    `pos` as a +-1 sign (B, 3, Ky, Kx), and mask (3, Ky, Kx) 1.0 where a walk
    bin lives (pos < bucket). The sentinel slot `bucket` reads bit 0."""
    B, bucket = frame.shape
    table = torch.cat([frame, frame.new_zeros((B, 1))], dim=1)
    bit = table[:, pos.reshape(-1)].reshape(B, *pos.shape)
    sign = bit.to(torch.float32) * 2.0 - 1.0
    mask = (pos < bucket).to(torch.float32)
    return sign, mask


def write_floor_plain(cr, ci, pos, frame, cos_a, sin_a, cjd=None, sjd=None,
                      *, floor: float, img_pixels: float, soft: bool = False):
    """(dr, di, b): the bit lookup, corner.write_delta and, when `floor`,
    corner.apply_write_floor; b (B,) f32 is the floor's boost (None without
    a floor)."""
    sign, mask = bit_signs(pos, frame)
    dr, di = corner.write_delta(cr, ci, sign, mask, cos_a, sin_a, cjd, sjd,
                                soft=soft)
    del sign, mask
    if not floor:
        return dr, di, None
    return floor_only_plain(dr, di, cr, ci, floor=floor,
                            img_pixels=img_pixels)


def floor_only_plain(dr, di, cr, ci, *, floor: float, img_pixels: float):
    """(dr_b, di_b, b): corner.apply_write_floor over (dr, di), and its
    per-image boost b (B,) f32."""
    br, bi, b = corner.write_floor_boosted(dr, di, cr, ci, floor,
                                           img_pixels)
    return br, bi, b.reshape(-1)


def epilogue_plain(t, planes, center: bool, layout: str):
    """u8 stego in `layout` from t (B, 3, H, W) f32, the inverse corner DFT
    before its 1/(H*W) scale, and the u8 cover planes (B, 3, H, W): t scaled,
    centered, planes + t -> floor(x + 0.5) clamped to [0, 255] (round half
    away from zero on the surviving range, as the reference; torch.round
    would round half to even). t is left as it was."""
    H, W = t.shape[-2:]
    out = spectral.apply_center(t * (1.0 / (H * W)), center)
    out = out.add_(planes).add_(0.5).floor_().clamp_(0.0, 255.0)
    out = out.to(torch.uint8)
    if layout != "nchw":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


# --- the wrappers ------------------------------------------------------------

def _device(name: str, first: torch.Tensor, tensors) -> str:
    """"cpu" or "cuda" for the call: every tensor argument on first's
    device; any other device raises."""
    dev = first.device
    for t in tensors:
        if t is not None and isinstance(t, torch.Tensor) and t.dim() and \
                t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _need(name: str, what: str, t, dtype, shape) -> None:
    """Raise unless t is a contiguous tensor of `dtype` and `shape`."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _floor_scalars(floor: float, img_pixels: float):
    """(0.5*s, s, E*) in f32 as apply_write_floor rounds them: s =
    f32(1/img_pixels), E* = f32(1.5*floor^2)."""
    s = np.float32(1.0 / img_pixels)
    return float(np.float32(0.5) * s), float(s), float(np.float32(
        1.5 * floor ** 2))


def _scratch(B: int, N: int, dev):
    nblk = -(-N // CHUNK)
    return (nblk, torch.empty((B, nblk, 3), dtype=torch.float32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def write_floor(cr, ci, pos, frame, cos_a, sin_a, cjd=None, sjd=None, *,
                floor: float, img_pixels: float, soft: bool = False):
    """(dr, di, b): the dense corner write of a shared walk and, when
    `floor`, its write floor. cr/ci: (B, 3, Ky, Kx) f32 corner spectrum;
    pos: (3, Ky, Kx) int32 slot map (`bucket` where no walk bin lives);
    frame: (B, bucket) u8 frame bits; cos_a/sin_a: cos/sin(alpha) as f32
    0-dim host tensors, or (3, Ky, Kx) amplitude maps (Params.alpha_spread);
    cjd/sjd: (3, Ky, Kx) jitter maps or None. b: (B,) f32, the floor's
    per-image boost (None without a floor). CUDA tensors launch
    csrc/corner_write_floor.cu on the current stream; CPU tensors take
    write_floor_plain."""
    name = KERNEL_WRITE_FLOOR
    maps = isinstance(cos_a, torch.Tensor) and cos_a.dim() > 0
    kind = _device(name, cr, (ci, pos, frame, cjd, sjd, cos_a, sin_a))
    if kind == "cpu":
        return write_floor_plain(cr, ci, pos, frame, cos_a, sin_a, cjd, sjd,
                                 floor=floor, img_pixels=img_pixels,
                                 soft=soft)
    if cr.dim() != 4 or cr.shape[1] != 3:
        raise ValueError(f"{name}: the spectrum must be (B, 3, Ky, Kx), got "
                         f"{tuple(cr.shape)}")
    B, _, Ky, Kx = cr.shape
    _need(name, "cr", cr, torch.float32, cr.shape)
    _need(name, "ci", ci, torch.float32, cr.shape)
    _need(name, "pos", pos, torch.int32, (3, Ky, Kx))
    if frame.dim() != 2 or frame.shape[0] != B or frame.shape[1] < 1:
        raise ValueError(f"{name}: frame must be (B={B}, bucket), got "
                         f"{tuple(frame.shape)}")
    _need(name, "frame", frame, torch.uint8, frame.shape)
    if (cjd is None) != (sjd is None):
        raise ValueError(f"{name}: give both jitter maps or neither")
    for what, m in (("cjd", cjd), ("sjd", sjd)) + (
            (("cos_a", cos_a), ("sin_a", sin_a)) if maps else ()):
        if m is not None:
            _need(name, what, m, torch.float32, (3, Ky, Kx))
    if maps and not (isinstance(sin_a, torch.Tensor)
                     and sin_a.shape == cos_a.shape):
        raise ValueError(f"{name}: cos_a and sin_a must both be maps")
    ca, sa = (0.0, 0.0) if maps else (float(cos_a), float(sin_a))
    N = 3 * Ky * Kx
    dr = torch.empty_like(cr)
    di = torch.empty_like(ci)
    nblk, partials, boost = _scratch(B, N, cr.device)
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(cr.device):
        stream = torch.cuda.current_stream(cr.device).cuda_stream
        rc = _build.kernel_library().corner_write_floor(
            cr.data_ptr(), ci.data_ptr(), pos.data_ptr(), frame.data_ptr(),
            _ptr(cjd), _ptr(sjd), _ptr(cos_a if maps else None),
            _ptr(sin_a if maps else None), dr.data_ptr(), di.data_ptr(),
            partials.data_ptr(), boost.data_ptr(), B, N, nblk,
            frame.shape[1], ca, sa, int(bool(soft)),
            *_floor_scalars(floor, img_pixels), int(bool(floor)), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return dr, di, (boost if floor else None)


def floor_only(dr, di, cr, ci, *, floor: float, img_pixels: float):
    """(dr_b, di_b, b): the write floor over a given delta (dr, di) beside
    the spectrum (cr, ci), all (B, 3, Ky, Kx) f32; b (B,) f32. CUDA tensors
    launch csrc/corner_write_floor.cu's floor pass on the current stream;
    CPU tensors take floor_only_plain."""
    name = KERNEL_FLOOR_ONLY
    kind = _device(name, cr, (ci, dr, di))
    if kind == "cpu":
        return floor_only_plain(dr, di, cr, ci, floor=floor,
                                img_pixels=img_pixels)
    if cr.dim() != 4 or cr.shape[1] != 3:
        raise ValueError(f"{name}: the spectrum must be (B, 3, Ky, Kx), got "
                         f"{tuple(cr.shape)}")
    for what, t in (("dr", dr), ("di", di), ("cr", cr), ("ci", ci)):
        _need(name, what, t, torch.float32, cr.shape)
    B, _, Ky, Kx = cr.shape
    N = 3 * Ky * Kx
    out_r = torch.empty_like(dr)
    out_i = torch.empty_like(di)
    nblk, partials, boost = _scratch(B, N, cr.device)
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(cr.device):
        stream = torch.cuda.current_stream(cr.device).cuda_stream
        rc = _build.kernel_library().corner_floor_only(
            dr.data_ptr(), di.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), partials.data_ptr(),
            boost.data_ptr(), B, N, nblk,
            *_floor_scalars(floor, img_pixels), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return out_r, out_i, boost


def epilogue(t, planes, center: bool, layout: str):
    """u8 stego from t (B, 3, H, W) f32 — the inverse corner DFT before its
    1/(H*W) scale (corner.ifft_corner_real(..., scale=False)) — and the u8
    cover planes (B, 3, H, W): (B, 3, H, W) for layout "nchw", else
    (B, H, W, 3). CUDA tensors launch csrc/corner_epilogue.cu on the current
    stream; CPU tensors take epilogue_plain."""
    name = KERNEL_EPILOGUE
    kind = _device(name, t, (planes,))
    if kind == "cpu":
        return epilogue_plain(t, planes, center, layout)
    if t.dim() != 4 or t.shape[1] != 3:
        raise ValueError(f"{name}: t must be (B, 3, H, W), got "
                         f"{tuple(t.shape)}")
    _need(name, "t", t, torch.float32, t.shape)
    _need(name, "planes", planes, torch.uint8, t.shape)
    B, _, H, W = t.shape
    shape = (B, 3, H, W) if layout == "nchw" else (B, H, W, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=t.device)
    if out.numel() == 0:
        return out
    inv = float(np.float32(1.0 / (H * W)))
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _build.kernel_library().corner_epilogue(
            t.data_ptr(), planes.data_ptr(), out.data_ptr(), B, H, W, inv,
            int(bool(center)), int(layout != "nchw"), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return out
