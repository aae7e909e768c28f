"""Exact order statistics of non-negative floats (the port's twin of
steganosaurus_tpu/ops/stats.py).

The median the pipeline needs (reference median_abs, steganosaur.cpp:404-409)
is an exact k-th order statistic. The JAX package computes it by binary
search on the IEEE-754 bit pattern because sorting is slow on the TPU; the
port takes torch.kthvalue and keeps the bisection as its plain version,
which defines the answer (tests and chip_smoke.py hold the two equal).
"""

from __future__ import annotations

import torch


def kth_smallest_nonneg(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest (0-indexed) per row of non-negative floats, by
    bisection on the bit pattern: for non-negative IEEE floats the integer
    pattern is order-isomorphic to the value, so one masked count per bit
    recovers the element. vals: (..., N) float32/float64, all >= 0."""
    bits, idt = ((64, torch.int64) if vals.dtype == torch.float64
                 else (32, torch.int32))
    u = vals.contiguous().view(idt)
    r = torch.zeros(vals.shape[:-1], dtype=idt, device=vals.device)
    for bit in range(bits - 2, -1, -1):  # the sign bit is always 0
        cand = r | (1 << bit)
        cnt = (u < cand[..., None]).sum(-1)  # elements strictly below
        r = torch.where(cnt <= k, cand, r)
    return r.view(vals.dtype)


def median_upper(vals: torch.Tensor) -> torch.Tensor:
    """Upper median: the element at sorted index N//2 of each row (the
    reference takes nth_element at n/2). torch.kthvalue counts from 1."""
    n = vals.shape[-1]
    return torch.kthvalue(vals, n // 2 + 1, dim=-1).values
