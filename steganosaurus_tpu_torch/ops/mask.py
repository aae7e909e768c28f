"""Annulus/axis bin masks and capacity counting (the port's twin of
steganosaurus_tpu/ops/mask.py).

Reference quirk kept for parity of the "Message too large" boundary:
capacity applies the magnitude threshold that the walk itself ignores
(steganosaur.cpp:1004 vs :797-799).
"""

from __future__ import annotations

import numpy as np
import torch


def eligibility_mask(H: int, W: int, rmin: float, rmax: float,
                     device=None, f64: bool = False) -> torch.Tensor:
    """Boolean (H, W) plane: not on axis/DC/Nyquist and inside the annulus
    hypot(y, x) in [rmin, rmax] * min(H, W) (reference annulus_ok
    :771-774; not centered). The JAX package's exact test: the integer
    y^2 + x^2 cast to f32, against the squared Python-float radii rounded to
    f32 (JAX weak-types them to the array's f32), so the count equals JAX's.
    f64=True takes its f64 backend's test instead (NumpyBackend._capacity):
    hypot(y, x) in f64 against the radii themselves."""
    yy = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    axis = (yy == 0) | (xx == 0)
    if H % 2 == 0:
        axis = axis | (yy == H // 2)
    if W % 2 == 0:
        axis = axis | (xx == W // 2)
    if f64:
        r = torch.hypot(yy.to(torch.float64), xx.to(torch.float64))
        m = min(H, W)
        return (~axis) & (r >= rmin * m) & (r <= rmax * m)
    r2 = (yy * yy + xx * xx).to(torch.float32)
    rlo = float(np.float32(float(rmin * min(H, W)) ** 2))
    rhi = float(np.float32(float(rmax * min(H, W)) ** 2))
    return (~axis) & (r2 >= rlo) & (r2 <= rhi)


def capacity_bits(spectrum: torch.Tensor, thresholds: torch.Tensor,
                  rmin: float, rmax: float) -> torch.Tensor:
    """Usable bit capacity (reference count_plane :998-1008): per plane the
    bins passing the eligibility mask with |F| >= threshold, halved (a
    conjugate pair carries one bit), summed. A 0-dim int64 tensor on the
    spectrum's device (pulled only when the caller asks). A complex128
    spectrum takes the f64 backend's radius test."""
    H, W = spectrum.shape[-2:]
    mask = eligibility_mask(H, W, rmin, rmax, spectrum.device,
                            f64=spectrum.dtype == torch.complex128)
    magok = torch.abs(spectrum) >= thresholds[:, None, None]
    per_plane = (mask[None] & magok).sum(dim=(-2, -1)) // 2
    return per_plane.sum()
