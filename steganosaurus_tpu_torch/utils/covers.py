"""Synthetic covers with a known property, for the tests and chip_smoke.py.

numpy only: the card's machine and the CPU tests build the same bytes.
"""

from __future__ import annotations

import numpy as np


def midstep_cover(h: int, w: int, seed: int, noise: float = 10.0
                  ) -> np.ndarray:
    """An (h, w, 3) u8 cover whose 8x8 low-frequency magnitudes (the
    cover-hash features) sit in the middle of a quantization step, 20x
    above the noise floor: mid-grey plus uniform noise plus one cosine per
    feature bin, sized so floor(log1p|F|/2) has a margin of half a step
    either way. The embed then cannot move a feature across a step, so
    Params.cover_dependent_path round-trips; on a noise cover the embed
    often moves one and neither package's own round trip recovers."""
    rng = np.random.default_rng(seed)
    img = 128.0 + rng.uniform(-noise, noise, (h, w, 3))
    floor_mag = 20 * np.sqrt(h * w * noise ** 2 / 3)
    k = int(np.ceil((np.log(floor_mag) - 1) / 2))
    amp = 2 * (np.exp(2 * k + 1) - 1) / (h * w)
    r = min(8, min(h, w) // 8)
    # sum over (ky, kx) of amp cos(2 pi (ky y/h + kx x/w) + phase), as the
    # real part of Ey . C . Ex: one (h, r) x (r, r) x (r, w) product per
    # plane instead of r*r full-image cosines (seconds at 4K, not minutes)
    ey = np.exp(2j * np.pi * np.outer(np.arange(h), np.arange(r)) / h)
    ex = np.exp(2j * np.pi * np.outer(np.arange(r), np.arange(w)) / w)
    for c in range(3):
        coef = np.zeros((r, r), np.complex128)
        for ky in range(r):
            for kx in range(r):
                if ky or kx:
                    coef[ky, kx] = amp * np.exp(
                        1j * rng.uniform(0, 2 * np.pi))
        img[..., c] += (ey @ coef @ ex).real
    return np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8)
