"""Repetition ECC on tensors (the live codes of steganosaurus_tpu/ops/ecc.py:
Rep-3 for the header, Rep-7 for the payload). Every function works along
the LAST axis, so a (B, n) batch decodes in one call."""

from __future__ import annotations

import torch


def rep_encode(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat each bit n times (reference rep{3,7}_encode_bits): an expand
    and a copy, with no host sync on CUDA."""
    return bits.unsqueeze(-1).expand(*bits.shape, n).reshape(
        *bits.shape[:-1], -1)


def _groups(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., L) -> (..., L // n, n), dropping a trailing partial group (the
    reference iterates i + n <= size)."""
    m = (x.shape[-1] // n) * n
    return x[..., :m].reshape(*x.shape[:-1], -1, n)


def rep_decode(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Majority vote over groups of n: a bit is 1 when at least
    ceil((n+1)/2) copies are 1 (>= 2 of 3, >= 4 of 7, as the reference)."""
    s = _groups(bits, n).to(torch.int32).sum(-1)
    return (s >= (n + 1) // 2).to(torch.uint8)


def rep_decode_soft(values: torch.Tensor, n: int) -> torch.Tensor:
    """Matched-filter repetition decode: a bit is 1 when the sum of its n
    copies' decision values is >= 0 (ties -> 1, the hard rule's tie)."""
    return (_groups(values, n).sum(-1) >= 0).to(torch.uint8)
