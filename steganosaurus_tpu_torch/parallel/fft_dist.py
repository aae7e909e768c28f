"""One image's spectrum sharded across a mesh axis (the port's twin of
steganosaurus_tpu/parallel/fft_dist.py).

    rows-sharded planes (3, PH/n, PW)
      -> row FFT on each shard (W complete there)
      -> all-to-all transpose: piece j of shard i goes to shard j
      -> column FFT on each shard (H complete there)
    = spectrum sharded along W (3, PH, PW/n)

The phase gather and scatter then run in the W-sharded layout: bin indices
are replicated, each shard writes only the bins in its W slab, and a bin's
value is read on its owning shard and summed over shards (every bin lives
on one shard, so the sum is the value). The global median of |F| is the
bit-pattern bisection of ops/stats.py with the count summed over shards
inside the loop. No shard holds the whole spectrum.

JAX runs these bodies under shard_map with lax.all_to_all and lax.psum; one
process drives every shard here, so the two collectives are explicit
copies between the shards' devices (peer copies on a multi-card host):
_all_to_all and _psum. Every shard's work is queued with its own card
current (parallel.batch.on_shards and Sharded.map). Transforms are
torch.fft (cuFFT on a card) in the reference's sign: the forward transform
is the conjugate of torch.fft's. Sharded tensors are parallel.batch.Sharded
along axis 1 (rows) or 2 (columns); a plain tensor or numpy array is split
on the way in.
"""

from __future__ import annotations

import torch

from steganosaurus_tpu_torch.ops import phase as phase_ops
from steganosaurus_tpu_torch.parallel.batch import (Mesh, Sharded, card,
                                                    on_shards, shard_batch)

ROWS, COLS = 1, 2  # the split axis of rows-sharded planes, W-sharded spectra


# --- collectives --------------------------------------------------------------

def _all_to_all(pieces: list[list[torch.Tensor]], mesh: Mesh):
    """pieces[i][j], shard i's piece for shard j -> recv[j][i] on device j
    (lax.all_to_all, untiled)."""
    n = mesh.size
    return [[pieces[i][j].to(mesh.devices[j], non_blocking=True)
             for i in range(n)] for j in range(n)]


def _psum(vals: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The sum over shards of vals[k], summed on the first device in shard
    order and copied back to every shard (lax.psum)."""
    d0 = mesh.devices[0]
    with card(d0):
        total = vals[0].to(d0, non_blocking=True)
        for v in vals[1:]:
            total = total + v.to(d0, non_blocking=True)
    return [total.to(d, non_blocking=True) for d in mesh.devices]


def _on(a, dev) -> torch.Tensor:
    """An index or value array (numpy, or a tensor on any device) on dev."""
    return torch.as_tensor(a).to(dev, non_blocking=True)


def _split(a, mesh: Mesh, axis: str, dim: int) -> Sharded:
    """`a` sharded along `dim` over the mesh axis `axis` (KeyError for an
    axis the mesh does not have, as JAX's mesh.shape[axis])."""
    if axis not in mesh.shape:
        raise KeyError(axis)
    return shard_batch(a, mesh, axis, dim)


def _check_split(size: int, n: int, what: str) -> int:
    """size // n; TypeError where n does not divide it, as the JAX body's
    reshape raises."""
    if size % n:
        raise TypeError(f"cannot reshape: {what} of {size} does not split "
                        f"into {n} pieces")
    return size // n


# --- transforms ---------------------------------------------------------------

def fft2_distributed(planes, mesh: Mesh, axis: str = "image") -> Sharded:
    """(3, PH, PW) real planes, rows sharded over `axis` (or a tensor to
    shard so) -> the reference-sign spectrum, complex64, sharded along W."""
    x = _split(planes, mesh, axis, ROWS)
    rows = x.map(lambda k, p: torch.fft.fft(p.to(torch.complex64),
                                            dim=-1)).parts
    wn = _check_split(rows[0].shape[-1], mesh.size, "a row")
    recv = _all_to_all([list(r.split(wn, dim=-1)) for r in rows], mesh)
    # received pieces stack along H in shard order
    return Sharded(on_shards(mesh.devices, lambda j: torch.fft.fft(
        torch.cat(recv[j], dim=1), dim=1).conj_physical_()), mesh, COLS)


def ifft2_real_distributed(spectrum, mesh: Mesh,
                           axis: str = "image") -> Sharded:
    """W-sharded (3, PH, PW) spectrum (or a tensor to shard so) -> real
    planes of the reference inverse, f32, rows sharded."""
    F = _split(spectrum, mesh, axis, COLS)
    cols = F.map(lambda k, p: torch.fft.ifft(torch.conj_physical(p),
                                             dim=1)).parts
    hn = _check_split(cols[0].shape[1], mesh.size, "a column")
    recv = _all_to_all([list(c.split(hn, dim=1)) for c in cols], mesh)
    # received W pieces arrive in shard order
    return Sharded(on_shards(mesh.devices, lambda j: torch.fft.ifft(
        torch.cat(recv[j], dim=2), dim=-1).real), mesh, ROWS)


# --- sharded phase ops ----------------------------------------------------------

def _median_parts(F: Sharded) -> list[torch.Tensor]:
    """Upper median of |F| per plane over the W-sharded spectrum, as a (3,)
    f32 tensor on every shard: the bisection of ops/stats.py
    (kth_smallest_nonneg) on the int32 bit patterns, k = n_total // 2, each
    bit's count summed over shards."""
    devs = F.mesh.devices
    u = on_shards(devs, lambda k: torch.abs(F.parts[k]).reshape(
        F.parts[k].shape[0], -1).contiguous().view(torch.int32))
    half = sum(x.shape[-1] for x in u) // 2
    r = on_shards(devs, lambda k: u[k].new_zeros(u[k].shape[0]))
    for bit in range(30, -1, -1):  # the sign bit is always 0
        cand = on_shards(devs, lambda k: r[k] | (1 << bit))
        cnt = _psum(on_shards(devs, lambda k: (
            u[k] < cand[k][:, None]).sum(-1)), F.mesh)
        r = on_shards(devs, lambda k: torch.where(cnt[k] <= half, cand[k],
                                                  r[k]))
    return [ri.view(torch.float32) for ri in r]


def _gather_parts(F: Sharded, plane, y, x) -> list[torch.Tensor]:
    """Values at bins (plane, y, x) on every shard: each shard reads its
    own bins (a clamped index, zero off its slab) and the sum over shards
    is the value."""
    def read(k):
        p, x0 = F.parts[k], F.offsets[k]
        wn = p.shape[-1]
        pl, yy, xx = (_on(t, p.device).long() for t in (plane, y, x))
        own = (xx >= x0) & (xx < x0 + wn)
        v = p[pl, yy, (xx - x0).clamp(0, wn - 1)]
        return torch.where(own, v, v.new_zeros(()))

    return _psum(on_shards(F.mesh.devices, read), F.mesh)


def _scatter_parts(F: Sharded, plane, y, x, nv: list[torch.Tensor]) -> Sharded:
    """F with nv[k] written at its bins and conj(nv[k]) at their Hermitian
    mirrors, each write on the shard that owns its column. An off-shard
    write goes to a sentinel slot past the shard's end and is dropped, never
    clamped onto a real bin (JAX's mode="drop"). The walk gives each bin
    and its mirror once, so the writes do not collide."""
    PH = F.parts[0].shape[-2]
    PW = F.shape[-1]

    def write(k, p):
        wn, x0 = p.shape[-1], F.offsets[k]
        pl, yy, xx = (_on(t, p.device).long() for t in (plane, y, x))
        v = nv[k].to(p.device, non_blocking=True)
        cy, cx = phase_ops.conj_indices(yy, xx, PH, PW)
        flat = torch.cat([p.reshape(-1), p.new_zeros(1)])
        for ry, rx, rv in ((yy, xx, v), (cy, cx, torch.conj_physical(v))):
            own = (rx >= x0) & (rx < x0 + wn)
            idx = (pl * PH + ry) * wn + (rx - x0)
            flat.index_put_((torch.where(own, idx, p.numel()),), rv)
        return flat[:-1].view(p.shape)

    return F.map(write)


def median_abs_distributed(spectrum, mesh: Mesh,
                           axis: str = "image") -> torch.Tensor:
    """(3,) f32 upper medians of |F| per plane of a W-sharded spectrum, on
    the mesh's first device: exactly the element ops/stats.py's bisection
    picks from the whole spectrum."""
    return _median_parts(_split(spectrum, mesh, axis, COLS))[0]


def gather_bins_distributed(spectrum, plane, y, x, mesh: Mesh,
                            axis: str = "image") -> torch.Tensor:
    """Spectrum values at (plane, y, x) of a W-sharded spectrum, on the
    mesh's first device."""
    return _gather_parts(_split(spectrum, mesh, axis, COLS), plane, y, x)[0]


def scatter_bins_distributed(spectrum, plane, y, x, nv, mesh: Mesh,
                             axis: str = "image") -> Sharded:
    """The W-sharded spectrum with nv at (plane, y, x) and conj(nv) at the
    Hermitian mirrors."""
    F = _split(spectrum, mesh, axis, COLS)
    nv = torch.as_tensor(nv)
    return _scatter_parts(F, plane, y, x, [nv] * mesh.size)


def embed_core_distributed(planes, plane, y, x, bits, jitters, alpha,
                           mesh: Mesh, *, adaptive: bool = False,
                           axis: str = "image", floor: float = 0.0,
                           img_pixels: float = 0.0) -> Sharded:
    """Single-image embed over a sharded spectrum: (3, PH, PW) f32 planes,
    rows sharded -> rows-sharded real (3, PH, PW) planes (cropping and u8
    rounding happen outside, where the true H, W are known). The write is
    ops/phase.write_values: magnitude kept, phase (bit ? +a : -a) + jitter,
    a magnitude-adaptive under `adaptive`; with `floor` the write floor
    boost over every bin (img_pixels the image's pixel count). The gathered
    values are the same on every shard after the sum, so each shard works
    out the same write values and boost: no further collective. The median
    is computed only under `adaptive`, the one rule that reads it (XLA drops
    it from the JAX graph otherwise)."""
    spec = fft2_distributed(planes, mesh, axis)
    med = _median_parts(spec) if adaptive else None
    v = _gather_parts(spec, plane, y, x)

    def write(k):
        dev = v[k].device
        pl = _on(plane, dev).long()
        return phase_ops.write_values(
            v[k], _on(bits, dev), _on(jitters, dev), alpha,
            med[k][pl] if adaptive else None, adaptive, floor=floor,
            img_pixels=img_pixels)

    spec2 = _scatter_parts(spec, plane, y, x, on_shards(mesh.devices, write))
    del spec
    return ifft2_real_distributed(spec2, mesh, axis)


def read_core_distributed(planes, plane, y, x, jitters, alpha, mesh: Mesh,
                          *, adaptive: bool = False,
                          axis: str = "image") -> torch.Tensor:
    """Single-image read over a sharded spectrum -> (n,) u8 raw bits on the
    mesh's first device, by ops/phase.read_phases_at (the median only
    under `adaptive`, as in embed_core_distributed)."""
    spec = fft2_distributed(planes, mesh, axis)
    med = _median_parts(spec)[0] if adaptive else None
    v = _gather_parts(spec, plane, y, x)[0]
    dev = v.device
    with card(dev):
        pl = _on(plane, dev).long()
        return phase_ops.read_phases_at(v, med[pl] if adaptive else None,
                                        _on(jitters, dev), alpha, adaptive)
