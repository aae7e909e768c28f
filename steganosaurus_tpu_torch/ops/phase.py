"""Phase-domain embed/extract on the full spectrum as gather -> rotate ->
scatter (the port's twin of steganosaurus_tpu/ops/phase.py).

The walk guarantees every selected bin and its Hermitian mirror are distinct
and selected at most once (axis/Nyquist bins are rejected, visited marks both
of a pair), so the scatters are conflict-free. Where a caller pads index
arrays by repeating the last slot (the batch cores), the duplicates carry
identical values, so which write index_put_ keeps does not matter.

Every function takes one image's (3, PH, PW) complex spectrum and (n,)
index tensors on its device; the batch cores (parallel/batch.py) run the
same math over a leading batch axis on bins they gathered themselves
(write_values, read_phases_at, read_values_at).
"""

from __future__ import annotations

import math

import torch


def _real(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _cexp(mag: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """mag * e^{i theta} as a complex tensor of mag's precision."""
    return torch.complex(mag * torch.cos(theta), mag * torch.sin(theta))


def _scale(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A real scalar (or broadcastable) b times complex c, component-wise."""
    return torch.complex(b * c.real, b * c.imag)


def conj_indices(y: torch.Tensor, x: torch.Tensor, H: int, W: int):
    """Vectorized Hermitian mirror index (reference conj_idx, :370-372)."""
    cy = torch.where(y == 0, 0, H - y) % H
    cx = torch.where(x == 0, 0, W - x) % W
    return cy, cx


def _alpha_like(alpha, like: torch.Tensor) -> torch.Tensor:
    """alpha (a number, or a per-slot tensor on like's device) broadcast to
    like's shape in like's dtype; a number becomes a device fill, never a
    host-to-device copy."""
    if isinstance(alpha, torch.Tensor):
        return torch.broadcast_to(alpha.to(like.dtype), like.shape)
    return torch.full_like(like, alpha)


def adaptive_alpha(base_alpha, mag: torch.Tensor, median_mag, enabled: bool
                   ) -> torch.Tensor:
    """alpha * clamp(mag/median, 0.5, 2.0) when enabled (reference
    :704-710), else alpha broadcast to mag's shape (median_mag is not read
    then, and may be None)."""
    a = _alpha_like(base_alpha, mag)
    if not enabled:
        return a
    median_mag = median_mag.to(mag.dtype)
    scale = torch.clamp(mag / torch.clamp(median_mag, min=1e-12), 0.5, 2.0)
    return a * scale


WRITE_FLOOR_BMAX = 32.0  # boost clip; past this the config is hopeless anyway


def write_floor_boost(v: torch.Tensor, nv: torch.Tensor, wm: torch.Tensor,
                      img_pixels: float, floor: float) -> torch.Tensor:
    """Closed-form magnitude boost b (last-axis reduction) so a phase write
    survives u8 rounding (ops/phase.py write_floor_boost in the JAX package
    has the derivation): b solves 2*E(b) / (3*img_pixels^2) = floor^2 with
    E(b) = sum over the moved bins `wm` of |b*nv - v|^2 = A b^2 - 2 C b + V,
    the + root, clipped to [1, WRITE_FLOOR_BMAX]. Values are scaled by
    1/img_pixels BEFORE summing: raw C^2 overflows f32 on large covers.
    v/nv (..., n) complex, wm (..., n) bool; returns (...) real."""
    rd = _real(v.dtype)
    w = wm.to(rd)
    # 0-dim host tensors: exact in rd, and read as scalars by device ops
    s = torch.tensor(1.0 / img_pixels, dtype=rd)
    vr, vi = v.real * s, v.imag * s
    nr, ni = nv.real * s, nv.imag * s
    A = torch.sum(w * (nr * nr + ni * ni), dim=-1)
    C = torch.sum(w * (nr * vr + ni * vi), dim=-1)
    V = torch.sum(w * (vr * vr + vi * vi), dim=-1)
    e_star = torch.tensor(1.5 * floor ** 2, dtype=rd)
    disc = torch.clamp(C * C - A * (V - e_star), min=0.0)
    b = (C + torch.sqrt(disc)) / torch.clamp(A, min=1e-30)
    return torch.clamp(b, 1.0, WRITE_FLOOR_BMAX)


def _med_at(medians, plane, adaptive: bool):
    """The median at each bin's plane, or None where the rule does not
    read it (extraction computes medians only under adaptive_alpha)."""
    return medians[plane] if adaptive else None


def _valid_mask(shape, n_valid, device) -> torch.Tensor:
    """(..., n) bool: slot index < n_valid (all True when None). n_valid is
    an int or a (...,) tensor (per-image counts)."""
    n = shape[-1]
    k = torch.arange(n, device=device)
    if n_valid is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if isinstance(n_valid, torch.Tensor) and n_valid.dim():
        return torch.broadcast_to(k < n_valid[..., None], shape)
    return torch.broadcast_to(k < n_valid, shape)


def _soft_target(bits, a, phi, jit):
    """(valid, theta) of the minimal-energy write (ops/phase.py
    embed_phases soft=True): a bin whose phase already decodes with margin
    >= |sin a| is valid (left untouched); the rest move to the nearest
    point at distance a in the correct half-plane."""
    rd = a.dtype
    one = torch.ones((), dtype=rd, device=a.device)
    s = torch.where(bits.to(torch.bool), one, -one)
    sigma = torch.where(torch.sin(a) < 0, -one, one)
    valid = s * sigma * torch.sin(phi) >= torch.abs(torch.sin(a))
    tgt_sin = s * sigma * torch.abs(torch.sin(a))
    tgt_cos = torch.where(torch.cos(phi) < 0, -one, one) * torch.abs(
        torch.cos(a))
    return valid, torch.atan2(tgt_sin, tgt_cos) + jit


def write_values(v, bits, jitters, alpha, med_at, adaptive: bool,
                 soft: bool = False, floor: float = 0.0,
                 img_pixels: float = 0.0, n_valid=None, gain: float = 1.0):
    """The per-bin target values nv of embed_phases (before its scatter),
    over any leading batch axes: v (..., n) the gathered bins, bits/jitters
    (..., n) or (n,), alpha a scalar or (n,), med_at the medians at each
    bin's plane (same shape as v; None unless adaptive). Returns nv,
    complex like v."""
    rd = _real(v.dtype)
    mag = torch.clamp(torch.abs(v), min=1e-12).to(rd)
    a = adaptive_alpha(alpha, mag, med_at, adaptive)
    j = jitters.to(rd)
    if soft:
        phi = torch.angle(v).to(rd) - j
        valid, theta = _soft_target(bits, a, phi, j)
        nv = torch.where(valid, v, _cexp(mag, theta))
        moved = ~valid
    else:
        theta = torch.where(bits.to(torch.bool), a, -a) + j
        nv = _cexp(mag, theta)
        moved = None
    if floor:
        # Energy counts each MOVED bin once: soft-valid bins carry zero
        # delta, tail-pad slots duplicate the last real bin (n_valid is the
        # un-padded count). The boost applies to padded duplicates too, so
        # they scatter the same value as their real twin.
        wm = _valid_mask(v.shape, n_valid, v.device)
        if moved is not None:
            wm = wm & moved
        b = write_floor_boost(v, nv, wm, img_pixels, floor)[..., None]
        boosted = _scale(nv, b)
        nv = boosted if moved is None else torch.where(moved, boosted, nv)
    if gain != 1.0:
        nv = v + (nv - v) / gain
    return nv


def _scatter(spectrum, plane, y, x, v, nv, hermitian_half: bool):
    """spectrum with nv written at (plane, y, x) and conj(nv) at the mirror,
    or with hermitian_half only 2*nv - v at the primary bins: consumers
    take real(IFFT), which sees the effective spectrum
    (S + mirror(conj(S)))/2, so that is exactly nv at the bin and conj(nv)
    at its mirror."""
    out = spectrum.clone()
    if hermitian_half:
        out.index_put_((plane, y, x), 2.0 * nv - v)
        return out
    H, W = spectrum.shape[-2:]
    cy, cx = conj_indices(y, x, H, W)
    out.index_put_((plane, y, x), nv)
    out.index_put_((plane, cy, cx), torch.conj_physical(nv))
    return out


def embed_phases(spectrum, plane, y, x, bits, jitters, alpha, medians,
                 adaptive: bool, gain: float = 1.0,
                 hermitian_half: bool = False, soft: bool = False,
                 floor: float = 0.0, img_pixels: float = 0.0,
                 n_valid=None):
    """Write `bits` into the phases of the selected bins (reference
    write_bit_on_bin, :712-732): keep magnitude, set phase to (bit ? +a :
    -a) + jitter (a magnitude-adaptive under `adaptive`), mirror the
    conjugate bin. soft: the minimal-energy write; floor: the quantization
    write floor over the first n_valid slots; gain: crop retention
    pre-compensation; hermitian_half: the half scatter (see _scatter).

    spectrum: (3, PH, PW) complex. plane/y/x/bits: (n,) integer.
    jitters: (n,) float. alpha: scalar or (n,). medians: (3,) float, read
    only under `adaptive` (else it may be None)."""
    v = spectrum[plane, y, x]
    nv = write_values(v, bits, jitters, alpha, _med_at(medians, plane,
                                                       adaptive), adaptive,
                      soft=soft, floor=floor, img_pixels=img_pixels,
                      n_valid=n_valid, gain=gain)
    return _scatter(spectrum, plane, y, x, v, nv, hermitian_half)


def read_phases(spectrum, plane, y, x, jitters, alpha, medians,
                adaptive: bool) -> torch.Tensor:
    """Bits from bin phases (reference read_bit_from_bin, :734-746): 1 iff
    cos(th - j - a) >= cos(th - j + a), the circular-distance rule with
    ties -> 1. Returns (n,) u8."""
    return read_phases_at(spectrum[plane, y, x],
                          _med_at(medians, plane, adaptive), jitters, alpha,
                          adaptive)


def read_phases_at(v, med_at, jitters, alpha, adaptive: bool):
    """read_phases on gathered bins v (..., n) with med_at the medians at
    each bin's plane."""
    th = torch.angle(v)
    mag = torch.clamp(torch.abs(v), min=1e-12)
    a = adaptive_alpha(alpha, mag, med_at, adaptive)
    base = th - jitters.to(th.dtype)
    return (torch.cos(base - a) >= torch.cos(base + a)).to(torch.uint8)


def read_values(spectrum, plane, y, x, jitters, alpha, medians,
                adaptive: bool) -> torch.Tensor:
    """Per-bin decision values d = mag * sin(theta - jitter) * sign(sin a):
    sign(d) is read_phases' bit, |d| its confidence (the matched-filter
    weight of the soft decode)."""
    return read_values_at(spectrum[plane, y, x],
                          _med_at(medians, plane, adaptive), jitters, alpha,
                          adaptive)


def read_values_at(v, med_at, jitters, alpha, adaptive: bool):
    """read_values on gathered bins v (..., n)."""
    th = torch.angle(v)
    mag = torch.clamp(torch.abs(v), min=1e-12)
    a = adaptive_alpha(alpha, mag, med_at, adaptive)
    base = th - jitters.to(th.dtype)
    return mag * torch.sin(base) * torch.sign(torch.sin(a))


def _qim_theta(theta, dithers, bits, L: int):
    """The nearest point of the keyed lattice coset for `bits`:
    d + (round((theta - d)/Delta - b/2) + b/2) * Delta, Delta = 2 pi/L
    (round half to even, as jnp.round)."""
    rd = theta.dtype
    d = dithers.to(rd)
    delta = torch.tensor(2.0 * math.pi / L, dtype=rd)
    half_b = bits.to(rd) * 0.5
    q = (theta - d) / delta - half_b
    return d + (torch.round(q) + half_b) * delta


def embed_phases_qim(spectrum, plane, y, x, bits, dithers, L: int,
                     gain: float = 1.0, hermitian_half: bool = False,
                     floor: float = 0.0, img_pixels: float = 0.0,
                     n_valid=None):
    """Dithered phase-QIM write (Params.qim): keep magnitude, set phase to
    the nearest point of the keyed lattice coset for `bits`; floor, gain and
    the scatter as embed_phases. Payload-only: callers write the header
    with embed_phases."""
    rd = _real(spectrum.dtype)
    v = spectrum[plane, y, x]
    mag = torch.clamp(torch.abs(v), min=1e-12).to(rd)
    theta = _qim_theta(torch.angle(v).to(rd), dithers, bits, L)
    nv = _cexp(mag, theta)
    if floor:
        wm = _valid_mask(v.shape, n_valid, v.device)
        nv = _scale(nv, write_floor_boost(v, nv, wm, img_pixels, floor))
    if gain != 1.0:
        nv = v + (nv - v) / gain
    return _scatter(spectrum, plane, y, x, v, nv, hermitian_half)


def read_values_qim(spectrum, plane, y, x, dithers, L: int) -> torch.Tensor:
    """Per-bin QIM decision values d = -cos(L * (theta - dither)) * mag:
    +1 at bit-0 centroids, -1 at bit-1 centroids, scaled by magnitude."""
    v = spectrum[plane, y, x]
    rd = _real(spectrum.dtype)
    mag = torch.clamp(torch.abs(v), min=1e-12).to(rd)
    th = torch.angle(v).to(rd)
    return -torch.cos(L * (th - dithers.to(rd))) * mag


def read_phases_qim(spectrum, plane, y, x, dithers, L: int) -> torch.Tensor:
    """QIM nearest-coset bit read: 1 iff -cos(L*(theta - d)) >= 0."""
    return (read_values_qim(spectrum, plane, y, x, dithers, L) >= 0).to(
        torch.uint8)


def _coherent_common(spectrum, y, x):
    """All three planes at the (y, x) sites and their common-mode phase:
    the angle of the unweighted phasor resultant S = sum_c v_c/|v_c|
    (Params.coherent). Returns (v3 (3, n), mag3 (3, n), S (n,), theta (n,))."""
    rd = _real(spectrum.dtype)
    v3 = spectrum[:, y, x]
    mag3 = torch.clamp(torch.abs(v3), min=1e-12).to(rd)
    S = torch.sum(v3 / mag3, dim=0)
    return v3, mag3, S, torch.angle(S).to(rd)


def _coherent_finish(spectrum, y, x, v3, nv3, moved_sites, gain: float,
                     hermitian_half: bool, floor: float, img_pixels: float,
                     n_valid):
    """Coherent-write tail: write-floor boost (energy over all three planes
    of each moved site), gain pre-compensation, all-plane scatter with
    conjugate mirroring. moved_sites: (n,) bool or None (every site)."""
    if floor:
        wm = _valid_mask(y.shape, n_valid, y.device)
        if moved_sites is not None:
            wm = wm & moved_sites
        wm3 = torch.broadcast_to(wm[None, :], v3.shape).reshape(-1)
        b = write_floor_boost(v3.reshape(-1), nv3.reshape(-1), wm3,
                              img_pixels, floor)
        boosted = _scale(nv3, b)
        nv3 = (boosted if moved_sites is None
               else torch.where(moved_sites[None, :], boosted, nv3))
    if gain != 1.0:
        nv3 = v3 + (nv3 - v3) / gain
    out = spectrum.clone()
    if hermitian_half:
        out[:, y, x] = 2.0 * nv3 - v3
        return out
    H, W = spectrum.shape[-2:]
    cy, cx = conj_indices(y, x, H, W)
    out[:, y, x] = nv3
    out[:, cy, cx] = torch.conj_physical(nv3)
    return out


def _rotate(v3, delta):
    """v3 (3, n) rotated by the per-site angle delta (n,)."""
    return v3 * _cexp(torch.ones_like(delta), delta)[None, :]


def embed_phases_coherent(spectrum, y, x, bits, jitters, alpha,
                          gain: float = 1.0, hermitian_half: bool = False,
                          soft: bool = False, floor: float = 0.0,
                          img_pixels: float = 0.0, n_valid=None):
    """Channel-coherent phase write (Params.coherent): per site rotate ALL
    THREE planes by one common delta so the common-mode phase lands on
    (bit ? +a : -a) + jitter; magnitudes and every pairwise phase
    difference are preserved. soft: sites already decoding with margin are
    left untouched, the rest clamp to the margin boundary. alpha: scalar or
    (n,). Payload and header alike (the header is written by this rule in
    coherent mode)."""
    rd = _real(spectrum.dtype)
    v3, _mag3, _S, theta = _coherent_common(spectrum, y, x)
    a = _alpha_like(alpha, theta)
    j = jitters.to(rd)
    if soft:
        valid, tgt = _soft_target(bits, a, theta - j, j)
        delta = torch.where(valid, torch.zeros_like(tgt), tgt - theta)
        moved_sites = ~valid
    else:
        tgt = torch.where(bits.to(torch.bool), a, -a) + j
        delta = tgt - theta
        moved_sites = None
    nv3 = _rotate(v3, delta)
    return _coherent_finish(spectrum, y, x, v3, nv3, moved_sites, gain,
                            hermitian_half, floor, img_pixels, n_valid)


def embed_phases_coherent_qim(spectrum, y, x, bits, dithers, L: int,
                              gain: float = 1.0,
                              hermitian_half: bool = False,
                              floor: float = 0.0, img_pixels: float = 0.0,
                              n_valid=None):
    """Coherent + QIM: the common-mode phase is quantized to the keyed
    dithered lattice (embed_phases_qim's rule on angle(S)), then all three
    planes rotate by the common delta."""
    v3, _mag3, _S, theta = _coherent_common(spectrum, y, x)
    tgt = _qim_theta(theta, dithers, bits, L)
    nv3 = _rotate(v3, tgt - theta)
    return _coherent_finish(spectrum, y, x, v3, nv3, None, gain,
                            hermitian_half, floor, img_pixels, n_valid)


def read_values_coherent(spectrum, y, x, jitters, alpha) -> torch.Tensor:
    """Coherent decision values d = w * sin(theta - jitter) * sign(sin a)
    on the common-mode phase, weight w = |S| * mean magnitude."""
    rd = _real(spectrum.dtype)
    _v3, mag3, S, theta = _coherent_common(spectrum, y, x)
    ssa = torch.sign(torch.sin(torch.tensor(alpha, dtype=rd)))  # host 0-dim
    w = torch.abs(S).to(rd) * torch.mean(mag3, dim=0)
    base = theta - jitters.to(rd)
    return w * torch.sin(base) * ssa


def read_phases_coherent(spectrum, y, x, jitters, alpha) -> torch.Tensor:
    """Coherent bit read: the half-plane rule on the common-mode phase
    (ties -> 1)."""
    return (read_values_coherent(spectrum, y, x, jitters, alpha) >= 0).to(
        torch.uint8)


def read_values_coherent_qim(spectrum, y, x, dithers, L: int) -> torch.Tensor:
    """Coherent QIM decision values -cos(L*(theta - d)) * w on the
    common-mode phase (weight as read_values_coherent)."""
    rd = _real(spectrum.dtype)
    _v3, mag3, S, theta = _coherent_common(spectrum, y, x)
    w = torch.abs(S).to(rd) * torch.mean(mag3, dim=0)
    return -torch.cos(L * (theta - dithers.to(rd))) * w


def read_phases_coherent_qim(spectrum, y, x, dithers, L: int) -> torch.Tensor:
    """Coherent QIM nearest-coset read (ties -> 1)."""
    return (read_values_coherent_qim(spectrum, y, x, dithers, L) >= 0).to(
        torch.uint8)
