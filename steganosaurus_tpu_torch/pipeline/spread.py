"""Keyed per-bin randomized write amplitude (Params.alpha_spread).

The port's twin of steganosaurus_tpu/pipeline/spread.py, whose docstring
has the derivation: bin i is written at

    alpha_i = alpha * (1 + alpha_spread * v_i),   v_i in [0, 1),

with v_i drawn from a KS keystream keyed by
crypto.derive_alpha_spread_key(path_key). The spread is one-sided, so every
bin keeps at least the hard write's decode margin, and the read rule (the
sign of sin(alpha)) needs no knowledge of it. Built on the port's copies
of the keystream and crypto modules, so the amplitudes are bit-equal to the
JAX package's (tests/test_torch_wire.py).
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_tpu_torch import crypto, keystream
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline.errors import StegoError


def validate(params: Params) -> None:
    """Reject spreads that could flip sign(sin(alpha_i)) against
    sign(sin(alpha)): with the one-sided upward spread that needs
    0 < alpha and alpha * (1 + s) < pi."""
    s = params.alpha_spread
    if s == 0.0:
        return
    if s < 0.0:
        raise StegoError(f"alpha_spread must be >= 0, got {s}")
    a = params.alpha
    if not 0.0 < a * (1.0 + s) < math.pi:
        raise StegoError(
            f"alpha_spread={s} with alpha={a} leaves the (0, pi) sin-sign "
            f"band: need 0 < alpha and alpha*(1+s) < pi")


def spread_alphas(path_key: bytes, params: Params,
                  nbits: int) -> np.ndarray | None:
    """(nbits,) f32 per-slot write amplitudes in [alpha, alpha(1+s)), or
    None when the spread is off."""
    if params.alpha_spread == 0.0:
        return None
    validate(params)
    u = keystream.signed_unit_offsets(
        crypto.derive_alpha_spread_key(path_key), nbits)
    v = (u + 1.0) * 0.5  # [0, 1)
    return (params.alpha * (1.0 + params.alpha_spread * v)).astype(np.float32)
