"""Dithered phase QIM for payload bits (Params.qim).

The port's twin of steganosaurus_tpu/pipeline/qim.py, whose docstring has
the derivation. With level L in 2..15 and step Delta = 2*pi/L, payload bit
b at frame slot i is written by quantizing the bin's phase onto

    theta' = d_i + (k + b/2) * Delta,   k = round((theta - d_i)/Delta - b/2),

with the dither d_i uniform in [0, Delta) from a KS keystream keyed by
crypto.derive_qim_key(path_key); it reads back as bit = 1 iff
-cos(L * (theta - d_i)) >= 0, and -cos(L * (theta - d_i)) * |C| is the
soft-decision value. The header is never QIM-written and carries L in
FLAGS bits 4-7, so extraction finds the level in the header.

Built on the port's copies of the keystream and crypto modules; the
dithers are bit-equal to the JAX package's (tests/test_torch_wire.py).
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_tpu_torch import crypto, keystream
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline.errors import StegoError


def validate(params: Params) -> None:
    """Reject invalid or unsupported QIM parameter combinations."""
    L = params.qim
    if L == 0:
        return
    if not 2 <= L <= 15:
        raise StegoError(f"qim level must be 0 or 2..15, got {L}")
    if params.adaptive_alpha:
        raise StegoError("qim and adaptive_alpha are mutually exclusive "
                         "(QIM replaces the payload write rule)")
    if params.cover_dependent_path:
        raise StegoError("qim is not supported with cover_dependent_path")


def dither_angles(path_key: bytes, L: int, nbits: int) -> np.ndarray:
    """(nbits,) f32 keyed dither angles in [0, 2*pi/L), indexed by frame
    slot: the header slots' draws exist but are never used, so the shared
    walk's statics and the per-image walks share one slot-aligned array."""
    u = keystream.signed_unit_offsets(crypto.derive_qim_key(path_key), nbits)
    delta = 2.0 * math.pi / L
    return ((u.astype(np.float64) + 1.0) * 0.5 * delta).astype(np.float32)
