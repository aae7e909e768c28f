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
    yy, xx = np.mgrid[:h, :w]
    img = 128.0 + rng.uniform(-noise, noise, (h, w, 3))
    floor_mag = 20 * np.sqrt(h * w * noise ** 2 / 3)
    k = int(np.ceil((np.log(floor_mag) - 1) / 2))
    amp = 2 * (np.exp(2 * k + 1) - 1) / (h * w)
    r = min(8, min(h, w) // 8)
    for c in range(3):
        for ky in range(r):
            for kx in range(r):
                if ky or kx:
                    img[..., c] += amp * np.cos(
                        2 * np.pi * (ky * yy / h + kx * xx / w)
                        + rng.uniform(0, 2 * np.pi))
    return np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8)
