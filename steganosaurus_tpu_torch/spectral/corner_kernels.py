"""Forward corner-DFT stage 1 (K1): the hand-written Hopper kernel and its
plain PyTorch version.

Replaces steganosaurus_tpu/spectral/corner_pallas.py:fwd_stage1. For every
plane and row, against both DFT tables:

    ar[..., h, k] = sum_w bf16(c(h,w) x[..., h, w]) * bf16(exr[k, w])
    ai[..., h, k] = sum_w bf16(c(h,w) x[..., h, w]) * bf16(exi[k, w])

with f32 accumulation, x the u8 image batch itself ((..., H, W), e.g. NCHW
(B, 3, H, W)) and c = (-1)^(h+w) when `center` is set, else 1.

One kernel for every width, csrc/corner_stage1_wgmma.cu: wgmma, one GEMM
over the concatenated table of stage1_tables (by TMA) with the centering
folded out of the A operand, the u8 image rows. A reaches shared memory
one of two ways, chosen by route_for:

- the TMA route (W % 16 == 0 and a 16-byte-aligned base: every grid the
  pipeline runs at 4K, 1080p, 512^2): TMA needs 16-byte row strides;
- the load route (any other W, or an unaligned view): the producer
  warpgroup loads the rows itself and writes the same bytes.

`fwd_stage1` launches one of them for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes
`fwd_stage1_plain` only for CPU tensors. `LAUNCHES` counts each route's
launches under its own name, one per launch and nowhere else, so a run can
show that the main path went through the kernel, and on which route.
"""

from __future__ import annotations

import functools

import torch

from steganosaurus_tpu_torch import spectral

KERNEL_TMA = "corner_stage1_wgmma"      # A by TMA
KERNEL_LDG = "corner_stage1_wgmma_ldg"  # A by the producer warpgroup's loads
LAUNCHES = {KERNEL_TMA: 0, KERNEL_LDG: 0}
BLOCK = 64  # the kernel's K block and the table's padding quantum


def route_for(W: int, data_ptr: int) -> str:
    """The route fwd_stage1 launches on CUDA for width-W images whose first
    byte is at address data_ptr."""
    return KERNEL_TMA if W % 16 == 0 and data_ptr % 16 == 0 else KERNEL_LDG


def fwd_stage1_plain(imgs_u8: torch.Tensor, exr: torch.Tensor,
                     exi: torch.Tensor, center: bool):
    """Plain version: round both operands through bf16, then an f32 matmul —
    exactly what JAX's _mm(..., "bf16") does on the CPU
    (steganosaurus_tpu/spectral/corner.py:_mm). Needs TF32 off on CUDA
    (runtime.configure_precision) to stay an f32 product there."""
    x = spectral.apply_center(imgs_u8.to(torch.float32), center)
    x = x.to(torch.bfloat16).to(torch.float32)
    H, W = x.shape[-2:]
    Kx = exr.shape[0]
    rows = x.reshape(-1, W)
    ar = rows @ exr.to(torch.bfloat16).to(torch.float32).T
    ai = rows @ exi.to(torch.bfloat16).to(torch.float32).T
    lead = x.shape[:-1]
    return ar.reshape(*lead, Kx), ai.reshape(*lead, Kx)


def _pad64(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


@functools.lru_cache(maxsize=8)
def k_order(Wp: int) -> torch.Tensor:
    """(Wp,) int64: the pixel column each logical K position of the wgmma
    kernel reads. Inside every 64-wide block, logical k = 16s + r (k16 step
    s, r in 0..15) is pixel 16q + 4s + e with q = (r % 8) // 2 and
    e = r % 2 + 2 (r // 8): the pixels a consumer thread puts in its wgmma
    A fragments are then 16 consecutive bytes of one row."""
    k = torch.arange(Wp)
    base, k = k - k % BLOCK, k % BLOCK
    s, r = k // 16, k % 16
    return base + 16 * ((r % 8) // 2) + 4 * s + r % 2 + 2 * (r // 8)


def stage1_tables(exr16: torch.Tensor, exi16: torch.Tensor):
    """(t, t_centered): the kernel's B operand, (2*Kxp, Wp) bf16 on
    the tables' device, Kxp = Kx and Wp = W rounded up to 64. Rows [0, Kx)
    hold exr, rows [Kxp, Kxp + Kx) exi, the rest zeros; columns past W are
    zeros; columns run in k_order. t_centered has (-1)^w folded in (a sign
    flip, exact in bf16): with the (-1)^h row sign that the kernel applies
    to its output it gives the centered product bit for bit."""
    Kx, W = exr16.shape
    Kxp, Wp = _pad64(Kx), _pad64(W)
    t = torch.zeros((2 * Kxp, Wp), dtype=torch.bfloat16, device=exr16.device)
    t[:Kx, :W] = exr16
    t[Kxp:Kxp + Kx, :W] = exi16
    sign = 1 - 2 * (torch.arange(Wp, device=t.device) % 2)
    tc = t * sign.to(torch.bfloat16)
    order = k_order(Wp).to(t.device)
    return t[:, order].contiguous(), tc[:, order].contiguous()


def _check(imgs_u8, exr, exi):
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() < 2:
        raise ValueError(f"fwd_stage1: images must be u8 (..., H, W), got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    W = imgs_u8.shape[-1]
    for name, t in (("exr", exr), ("exi", exi)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.shape[1] != W:
            raise ValueError(f"fwd_stage1: {name} must be bf16 (Kx, {W}), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != imgs_u8.device:
            raise ValueError(f"fwd_stage1: {name} on {t.device}, images on "
                             f"{imgs_u8.device}")
    if exr.shape != exi.shape:
        raise ValueError("fwd_stage1: exr and exi shapes differ")


def fwd_stage1(imgs_u8: torch.Tensor, exr_bf16: torch.Tensor,
               exi_bf16: torch.Tensor, center: bool, tables=None):
    """(..., H, W) u8 images, (Kx, W) bf16 tables -> ((..., H, Kx) ar, ai)
    f32. CUDA tensors launch the kernel on route_for(W, data_ptr) on the
    current stream; CPU tensors take fwd_stage1_plain; any other device
    raises. `tables` is stage1_tables(exr_bf16, exi_bf16), cached by the
    caller (corner.Tables); it is built here when not given."""
    _check(imgs_u8, exr_bf16, exi_bf16)
    dev = imgs_u8.device
    if dev.type == "cpu":
        return fwd_stage1_plain(imgs_u8, exr_bf16, exi_bf16, center)
    if dev.type != "cuda":
        raise ValueError(f"fwd_stage1: unsupported device {dev}")
    for name, t in (("images", imgs_u8), ("exr", exr_bf16), ("exi", exi_bf16)):
        if not t.is_contiguous():
            raise ValueError(f"fwd_stage1: {name} must be contiguous")
    Kx = exr_bf16.shape[0]
    lead = imgs_u8.shape[:-1]
    ar = torch.empty((*lead, Kx), dtype=torch.float32, device=dev)
    ai = torch.empty((*lead, Kx), dtype=torch.float32, device=dev)
    if imgs_u8.numel() == 0:
        return ar, ai
    if tables is None:
        tables = stage1_tables(exr_bf16, exi_bf16)
    _launch(imgs_u8, tables[1] if center else tables[0], ar, ai, Kx, center,
            route_for(imgs_u8.shape[-1], imgs_u8.data_ptr()))
    return ar, ai


def _launch(imgs_u8, t, ar, ai, Kx: int, center: bool, route: str) -> None:
    """csrc/corner_stage1_wgmma.cu on the current stream, A on `route`
    (KERNEL_TMA or KERNEL_LDG; the load route takes any input)."""
    from steganosaurus_tpu_torch import _build

    H, W = imgs_u8.shape[-2:]
    Kxp, Wp = _pad64(Kx), _pad64(W)
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != (2 * Kxp, Wp)
            or t.device != imgs_u8.device or not t.is_contiguous()):
        raise ValueError(f"fwd_stage1: the concatenated table must be a "
                         f"contiguous bf16 ({2 * Kxp}, {Wp}) on "
                         f"{imgs_u8.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if route not in LAUNCHES:
        raise ValueError(f"fwd_stage1: unknown route {route!r}")
    if route == KERNEL_TMA and route_for(W, imgs_u8.data_ptr()) != route:
        raise ValueError(f"fwd_stage1: the TMA route needs W % 16 == 0 and "
                         f"16-byte-aligned images (W={W})")
    P = imgs_u8.numel() // (H * W)
    with torch.cuda.device(imgs_u8.device):
        stream = torch.cuda.current_stream(imgs_u8.device).cuda_stream
        rc = _build.kernel_library().corner_stage1_wgmma(
            imgs_u8.data_ptr(), t.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            P, H, W, Kx, Kxp, Wp, int(bool(center)),
            int(route == KERNEL_TMA), stream)
    if rc != 0:
        raise RuntimeError(f"{route} launch failed: CUDA error {rc}")
    LAUNCHES[route] += 1
