"""Spectral engine (the port's twin of steganosaurus_tpu/spectral/__init__.py):
plane conversion, padding, the full-grid 2D FFT in the reference's sign,
medians and the cover hash features, plus the native-size grid rule and the
optional (-1)^(x+y) centering the corner path shares.

The full-grid transforms are torch.fft (cuFFT on the card, pocketfft on the
CPU) in the reference's sign convention; the JAX package's matmul DFT
(spectral/fft_mxu.py) and its implementation switch exist only because
XLA's FFT is slow on the TPU, and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch.ops import stats


def fft_dims(H: int, W: int) -> tuple[int, int]:
    """Spectral grid dims for an H x W image: the native size, no padding
    (see steganosaurus_tpu.spectral.fft_dims for why the reference's pow2
    padding is not reproduced)."""
    return H, W


def to_planes(img_u8):
    """(H, W, 3) u8 interleaved -> (3, H, W) planes (reference :383-386):
    float64 for a numpy image (the f64 NumpyBackend's input, as the JAX
    package's to_planes), float32 on the image's device for a tensor (u8
    values are exact in f32, which is what the JAX backend casts to)."""
    if isinstance(img_u8, torch.Tensor):
        if img_u8.dim() != 3 or img_u8.shape[2] != 3:
            raise ValueError(
                f"image must be (H, W, 3), got {tuple(img_u8.shape)}")
        return img_u8.permute(2, 0, 1).to(torch.float32)
    if img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {img_u8.shape}")
    return np.ascontiguousarray(img_u8.transpose(2, 0, 1)).astype(np.float64)


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) float -> (..., H, W, 3) u8: floor(x + 0.5) then clamp
    to [0, 255] — the reference's C `round` (half away from zero) on the
    range that survives the clamp; torch.round would round half to even."""
    q = torch.floor(planes + 0.5).clamp_(0.0, 255.0).to(torch.uint8)
    return q.movedim(-3, -1).contiguous()


def apply_center(planes: torch.Tensor, on: bool) -> torch.Tensor:
    """Optional (-1)^(x+y) spectrum centering (reference apply_center)."""
    if not on:
        return planes
    H, W = planes.shape[-2:]
    yy = torch.arange(H, device=planes.device)[:, None]
    xx = torch.arange(W, device=planes.device)[None, :]
    one = torch.ones((), dtype=planes.dtype, device=planes.device)
    return planes * torch.where((yy + xx) % 2 == 1, -one, one)


def pad_planes(planes: torch.Tensor, PH: int, PW: int) -> torch.Tensor:
    """Zero-pad (..., H, W) real planes into (..., PH, PW) (reference
    pad_to_fft :393-398)."""
    H, W = planes.shape[-2:]
    if (PH, PW) == (H, W):
        return planes
    return torch.nn.functional.pad(planes, (0, PW - W, 0, PH - H))


def fft2(planes: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Forward 2D FFT over the last two axes in the REFERENCE SIGN: its
    radix-2 kernel uses w = e^{+2 pi i/len} forward (steganosaur.cpp:347),
    the conjugate of torch.fft's, so for real planes conj(fft2(x)) is the
    reference spectrum."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    # conjugated in place: a batch's spectrum is held once, not twice
    return torch.fft.fft2(planes.to(real)).conj_physical_().to(dtype)


def ifft2_real(spectrum: torch.Tensor) -> torch.Tensor:
    """Inverse 2D FFT in the reference convention, real part: the reference
    inverse is conj(ifft(conj(F))), whose real part is real(ifft(conj(F)))."""
    return torch.fft.ifft2(torch.conj_physical(spectrum)).real


def median_abs(spectrum: torch.Tensor) -> torch.Tensor:
    """Upper median of |F| over each plane (reference median_abs,
    :404-409): the (n/2)-th order statistic of the n = PH*PW magnitudes."""
    mags = torch.abs(spectrum).reshape(*spectrum.shape[:-2], -1)
    return stats.median_upper(mags)


def cover_hash_features(spectrum: torch.Tensor) -> torch.Tensor:
    """Quantized low-frequency magnitudes for the cover hash: per plane the
    region x region top-left square of |F|, q = clamp(floor(log(1+mag)/2),
    0, 7), region = min(8, min(PH, PW)//8) (reference compute_cover_hash,
    steganosaur.cpp:415-444). Returns (3, region, region) u8; the host
    SHA-256 hashes the R||G||B bytes."""
    PH, PW = spectrum.shape[-2:]
    region = min(8, min(PH, PW) // 8)
    mags = torch.abs(spectrum[..., :region, :region])
    q = torch.clamp(torch.floor(torch.log1p(mags) / 2.0), 0.0, 7.0)
    return q.to(torch.uint8)
