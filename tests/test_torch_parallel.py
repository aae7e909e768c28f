"""The port's parallel layer against the JAX package's, on the CPU.

The port runs on make_mesh(8, device="cpu"), eight logical shards of the
CPU; JAX on its eight virtual CPU devices (tests/conftest.py). Inputs are
made from numpy seeds. Mirrors tests/test_parallel.py and the mesh cases
of tests/test_batch.py:

- fft_dist: the sharded transforms, median, gather and scatter against the
  port's dense versions (the median, gather and scatter exactly) and
  against JAX's sharded versions (1e-5 of the largest magnitude); the
  sharded embed and read against JAX's;
- the batch axis: the full-grid cores on a Sharded batch equal to the
  unsharded call; embed_batch / extract_batch / the streams / the channel
  report under the mesh equal to the unsharded calls byte for byte, and
  stegos cross-decoding with JAX's mesh path both ways.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import steganosaurus_tpu_torch as stt
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.parallel import batch as jpbatch
from steganosaurus_tpu.parallel import fft_dist as jfd
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.pipeline import stream as jstream
from steganosaurus_tpu_torch import parallel, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import phase as phase_ops
from steganosaurus_tpu_torch.ops import stats
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.parallel import fft_dist as tfd
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.pipeline import stream as tstream
from steganosaurus_tpu_torch.spectral import corner as tcorner

torch.set_num_threads(2)

FAST = dict(pbkdf2_iter=500)
# The sharded transforms against the dense and the JAX ones: f32 FFTs that
# sum in other orders, within this fraction of the largest magnitude
FFT_REL = 1e-5
# Sharded embed, port against JAX: real planes of 0-255 covers after two
# f32 round trips through FFTs summing in other orders
DIST_PLANES_ATOL = 2e-3


def jp(p: Params) -> JParams:
    return JParams(**dataclasses.asdict(p))


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py forces 8 virtual CPU devices")
    return JMesh(np.asarray(jax.devices()[:8]), ("image",))


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh(8, axis="image", device="cpu")


def _rand_planes(rng, PH, PW):
    return rng.uniform(0, 255, (3, PH, PW)).astype(np.float32)


def _jrows(planes, jmesh):
    return jax.device_put(planes, NamedSharding(jmesh, P(None, "image",
                                                         None)))


def _jx(fn, jmesh, **static):
    """A JAX fft_dist function on `jmesh` under one jit, as its module
    says to compose them (an unjitted shard_map compiles on every call)."""
    return jax.jit(functools.partial(fn, mesh=jmesh, **static))


def _close(got, want, rel=FFT_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


# --- fft_dist ------------------------------------------------------------------

def test_fft2_distributed_matches_dense_and_jax(mesh8, jmesh8):
    rng = np.random.default_rng(0)
    planes = _rand_planes(rng, 64, 128)
    got = tfd.fft2_distributed(planes, mesh8)
    assert isinstance(got, pbatch.Sharded) and got.axis == 2
    assert [p.shape for p in got.parts] == [(3, 64, 16)] * 8
    _close(got, spectral.fft2(torch.from_numpy(planes)))
    _close(got, _jx(jfd.fft2_distributed, jmesh8)(_jrows(planes, jmesh8)))


def test_ifft2_real_distributed_matches_dense_and_jax(mesh8, jmesh8):
    rng = np.random.default_rng(1)
    planes = _rand_planes(rng, 128, 64)
    spec = tfd.fft2_distributed(planes, mesh8)
    back = tfd.ifft2_real_distributed(spec, mesh8)
    assert isinstance(back, pbatch.Sharded) and back.axis == 1
    np.testing.assert_allclose(np.asarray(back), planes, rtol=1e-4,
                               atol=5e-3)
    dense = np.asarray(spec)
    _close(back, spectral.ifft2_real(torch.from_numpy(dense)))
    jspec = _jx(jfd.fft2_distributed, jmesh8)(_jrows(planes, jmesh8))
    _close(tfd.ifft2_real_distributed(np.asarray(jspec), mesh8),
           _jx(jfd.ifft2_real_distributed, jmesh8)(jspec))


def test_median_abs_distributed_is_the_bisection_median(mesh8, jmesh8):
    rng = np.random.default_rng(2)
    planes = _rand_planes(rng, 64, 64)
    spec = tfd.fft2_distributed(planes, mesh8)
    got = tfd.median_abs_distributed(spec, mesh8)
    dense = torch.from_numpy(np.asarray(spec))
    mags = dense.abs().reshape(3, -1)
    want = stats.kth_smallest_nonneg(mags, mags.shape[-1] // 2)
    assert torch.equal(got, want)
    assert torch.equal(got, spectral.median_abs(dense))
    jspec = _jx(jfd.fft2_distributed, jmesh8)(_jrows(planes, jmesh8))
    _close(tfd.median_abs_distributed(np.asarray(jspec), mesh8),
           _jx(jfd.median_abs_distributed, jmesh8)(jspec))


def _bins(rng, PH, PW, n, lo=1):
    """Distinct off-axis bins in the lower-left quadrant (distinct from
    their mirrors)."""
    plane = rng.integers(0, 3, n).astype(np.int32)
    y = rng.integers(lo, PH // 2 - (lo > 1), n).astype(np.int32)
    x = rng.integers(lo, PW // 2 - (lo > 1), n).astype(np.int32)
    keep = sorted({(int(plane[i]), int(y[i]), int(x[i])): i
                   for i in range(n)}.values())
    return plane[keep], y[keep], x[keep]


def test_sharded_gather_scatter_match_dense_and_jax(mesh8, jmesh8):
    rng = np.random.default_rng(3)
    PH = PW = 64
    spec = spectral.fft2(torch.from_numpy(_rand_planes(rng, PH, PW)))
    plane, y, x = _bins(rng, PH, PW, 50)
    m = len(plane)
    nv = (rng.normal(size=m) + 1j * rng.normal(size=m)).astype(np.complex64)
    pl, yy, xx = (torch.from_numpy(a).long() for a in (plane, y, x))

    got = tfd.gather_bins_distributed(spec, plane, y, x, mesh8)
    assert torch.equal(got, spec[pl, yy, xx])
    out = tfd.scatter_bins_distributed(spec, plane, y, x, nv, mesh8)
    want = spec.clone()
    want[pl, yy, xx] = torch.from_numpy(nv)
    cy, cx = phase_ops.conj_indices(yy, xx, PH, PW)
    want[pl, cy, cx] = torch.from_numpy(nv).conj()
    assert torch.equal(torch.from_numpy(np.asarray(out)), want)

    jspec = jax.device_put(jnp.asarray(spec.numpy()),
                           NamedSharding(jmesh8, P(None, None, "image")))
    _close(got, _jx(jfd.gather_bins_distributed, jmesh8)(jspec, plane, y,
                                                         x))
    _close(out, _jx(jfd.scatter_bins_distributed, jmesh8)(jspec, plane, y,
                                                          x, nv))


def test_scatter_drops_off_shard_writes(mesh8):
    """A bin written on its owning shard leaves every other shard's slab
    untouched, including the column an off-shard index would clamp to."""
    spec = torch.zeros((3, 16, 64), dtype=torch.complex64)
    nv = np.asarray([1 + 2j], np.complex64)
    out = np.asarray(tfd.scatter_bins_distributed(
        spec, np.asarray([1]), np.asarray([3]), np.asarray([20]), nv, mesh8))
    assert np.count_nonzero(out) == 2
    assert out[1, 3, 20] == nv[0] and out[1, 13, 44] == np.conj(nv[0])


@pytest.mark.parametrize("floor,adaptive", [(0.0, False), (0.45, False),
                                            (0.0, True)])
def test_distributed_embed_read_matches_jax(mesh8, jmesh8, floor, adaptive):
    """Sharded embed -> u8 rounding -> sharded read: the raw bits come back
    (< 5% errors, JAX's bar), the port's planes are within
    DIST_PLANES_ATOL of JAX's sharded embed on the same bins, within the
    same tolerance of the port's dense full-grid embed, and each package
    reads the other's stego planes as it reads its own."""
    rng = np.random.default_rng(4)
    PH = PW = 128
    planes = np.clip(190 + rng.integers(-20, 21, (3, PH, PW)), 0,
                     255).astype(np.float32)
    plane, y, x = _bins(rng, PH, PW, 64, lo=8)
    m = len(plane)
    bits = rng.integers(0, 2, m).astype(np.uint8)
    jit = np.zeros(m, np.float32)
    kw = dict(adaptive=adaptive, floor=floor, img_pixels=float(PH * PW))

    out = tfd.embed_core_distributed(planes, plane, y, x, bits, jit, 0.5,
                                     mesh8, **kw)
    jout = _jx(jfd.embed_core_distributed, jmesh8, **kw)(
        _jrows(planes, jmesh8), plane, y, x, jnp.asarray(bits), jit,
        jnp.float32(0.5))
    np.testing.assert_allclose(np.asarray(out), np.asarray(jout), rtol=0,
                               atol=DIST_PLANES_ATOL)
    spec = spectral.fft2(torch.from_numpy(planes))
    dense = spectral.ifft2_real(phase_ops.embed_phases(
        spec, *(torch.from_numpy(a).long() for a in (plane, y, x)),
        torch.from_numpy(bits), torch.from_numpy(jit), 0.5,
        spectral.median_abs(spec), adaptive, floor=floor,
        img_pixels=float(PH * PW)))
    np.testing.assert_allclose(np.asarray(out), dense.numpy(), rtol=0,
                               atol=DIST_PLANES_ATOL)

    def u8(a):
        return np.clip(np.floor(np.asarray(a) + 0.5), 0, 255).astype(
            np.float32)

    jread = _jx(jfd.read_core_distributed, jmesh8, adaptive=adaptive)
    for stego in (u8(out), u8(jout)):
        got = tfd.read_core_distributed(stego, plane, y, x, jit, 0.5, mesh8,
                                        adaptive=adaptive).numpy()
        jgot = np.asarray(jread(_jrows(stego, jmesh8), plane, y, x, jit,
                                jnp.float32(0.5)))
        assert (got != bits).mean() < 0.05
        np.testing.assert_array_equal(got, jgot)


def test_fft_dist_size_errors_match_jax(mesh8, jmesh8):
    """Rows the mesh does not divide: ValueError (the sharding); columns
    it does not divide: TypeError (the body's reshape), in both."""
    for shape, exc in (((3, 60, 128), ValueError), ((3, 64, 100), TypeError)):
        planes = np.zeros(shape, np.float32)
        with pytest.raises(exc):
            jfd.fft2_distributed(planes, jmesh8)
        with pytest.raises(exc):
            tfd.fft2_distributed(planes, mesh8)
    with pytest.raises(KeyError):
        tfd.fft2_distributed(np.zeros((3, 64, 128), np.float32),
                             parallel.make_mesh(8, device="cpu"))


# --- the mesh and the batch-axis cores -------------------------------------------

def test_make_mesh():
    m = parallel.make_mesh(4, device="cpu")
    assert m.size == 4 and m.shape == {"batch": 4}
    assert m.axis_names == ("batch",)
    assert m == parallel.make_mesh(4, device="cpu") and len({m, m}) == 1
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(2, device="cuda")


def test_parallel_exports_the_jax_names():
    import steganosaurus_tpu.parallel as jparallel

    for name in ("make_mesh", "shard_batch", "batched_embed_core",
                 "batched_read_core", "fft2_distributed",
                 "ifft2_real_distributed"):
        assert hasattr(jparallel, name)
        assert getattr(parallel, name).__module__.startswith(
            "steganosaurus_tpu_torch.parallel.")


def test_shard_batch_round_trip_and_nondivisible_error():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (8, 5, 4, 3), dtype=np.uint8)
    s = parallel.shard_batch(a, parallel.make_mesh(4, device="cpu"))
    assert s.shape == a.shape and len(s.parts) == 4
    assert [s.locate(i) for i in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0),
                                                   (3, 1)]
    np.testing.assert_array_equal(np.asarray(s), a)
    with pytest.raises(ValueError):
        jpbatch.shard_batch(a[:6], jpbatch.make_mesh(8))
    with pytest.raises(ValueError):
        parallel.shard_batch(a[:6], parallel.make_mesh(8, device="cpu"))


def _rand_batch(rng, B, H, W, n, shared_idx):
    imgs = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    shp = (n,) if shared_idx else (B, n)
    plane = rng.integers(0, 3, shp).astype(np.int64)
    y = rng.integers(1, H // 2, shp).astype(np.int64)
    x = rng.integers(1, W // 2, shp).astype(np.int64)
    bits = rng.integers(0, 2, (B, n)).astype(np.uint8)
    jit = np.zeros(shp, np.float32)
    return imgs, plane, y, x, bits, jit


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("shared_idx", [True, False])
def test_batched_embed_matches_single(shared_idx):
    """The full-grid batch embed of B images equals B calls of one image
    each (JAX: batched_embed_core vs _embed_core)."""
    rng = np.random.default_rng(5)
    B, H, W, n = 4, 64, 64, 64
    imgs, plane, y, x, bits, jit = _rand_batch(rng, B, H, W, n, shared_idx)
    words = pbatch.bit_ops.pack_bits_words_host(bits)
    args = _t(imgs, plane, y, x, words, jit)
    got = pbatch.batched_embed_core(*args, 0.5, center=False)
    for b in range(B):
        one = [a[b:b + 1] if (i in (0, 4) or not shared_idx) else a
               for i, a in enumerate(args)]
        assert torch.equal(got[b:b + 1], pbatch.batched_embed_core(
            *one, 0.5, center=False))


@pytest.mark.parametrize("adaptive", [False, True])
def test_analyze_plus_gather_matches_full_read(adaptive):
    """batched_read_core == batched_analyze_core + gather + the phase rule,
    and its bits are JAX's batched_read_core's on the same inputs."""
    rng = np.random.default_rng(7)
    B, H, W, n = 3, 64, 64, 25
    imgs, plane, y, x, _, jit = _rand_batch(rng, B, H, W, n, True)
    ti, tp, ty, tx, tj = _t(imgs, plane, y, x, jit)
    got = pbatch.batched_read_core(ti, tp, ty, tx, tj, 0.5, center=False,
                                   adaptive=adaptive)
    spec, med = pbatch.batched_analyze_core(ti, center=False)
    want = phase_ops.read_phases_at(spec[:, tp, ty, tx], med[:, tp], tj,
                                    0.5, adaptive)
    assert got.dtype == torch.int32
    assert torch.equal(got, want.to(torch.int32))
    jgot = np.asarray(jpbatch.batched_read_core(H, W, False, adaptive)(
        imgs, plane.astype(np.int32), y.astype(np.int32),
        x.astype(np.int32), jit, jnp.float32(0.5)))
    np.testing.assert_array_equal(got.numpy(), jgot)


@pytest.mark.parametrize("shared_idx", [True, False])
def test_batched_cores_sharded_over_mesh(shared_idx):
    """batched_embed_core and batched_read_core on a Sharded batch return a
    Sharded equal to the unsharded call (per-row arguments given whole or
    sharded)."""
    rng = np.random.default_rng(6)
    mesh = parallel.make_mesh(8, device="cpu")
    B, H, W, n = 8, 64, 64, 32
    imgs, plane, y, x, bits, jit = _rand_batch(rng, B, H, W, n, shared_idx)
    words = pbatch.bit_ops.pack_bits_words_host(bits)
    ti, tp, ty, tx, tw, tj = _t(imgs, plane, y, x, words, jit)
    ref = pbatch.batched_embed_core(ti, tp, ty, tx, tw, tj, 0.5,
                                    center=False)
    s = parallel.shard_batch(imgs, mesh)
    got = parallel.batched_embed_core(s, tp, ty, tx,
                                      parallel.shard_batch(tw, mesh), tj,
                                      0.5, center=False)
    assert isinstance(got, pbatch.Sharded) and got.shape == (B, H, W, 3)
    np.testing.assert_array_equal(np.asarray(got), ref.numpy())
    rref = pbatch.batched_read_core(ti, tp, ty, tx, tj, 0.5, center=False,
                                    adaptive=True)
    rgot = parallel.batched_read_core(s, tp, ty, tx, tj, 0.5, center=False,
                                      adaptive=True)
    np.testing.assert_array_equal(np.asarray(rgot), rref.numpy())


# --- embed_batch / extract_batch under the mesh ----------------------------------

@pytest.fixture(scope="module")
def covers():
    rng = np.random.default_rng(21)
    base = np.linspace(170, 225, 128)
    imgs = base[None, None, :, None] + rng.integers(-12, 13, (8, 128, 128, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


SALTS = [bytes([3 * i + 2]) * 16 for i in range(8)]

MODES = {
    "default": Params(**FAST),
    "jitter": Params(jitter=0.2, **FAST),
    "piw+rs+qim": Params(per_image_walk=True, rs=True, qim=3, **FAST),
    "soft+spread+pad": Params(soft_write=True, alpha_spread=0.3,
                              pad_quantum=16, **FAST),
    "adaptive": Params(adaptive_alpha=True, **FAST),
    "piw+adaptive": Params(per_image_walk=True, adaptive_alpha=True, **FAST),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shards", [8, 2])
def test_mesh_embed_equals_unsharded(covers, mode, shards):
    """Every wire mode under the mesh writes the unsharded call's bytes,
    and reads back under the mesh (nchw too for the corner modes), with
    plain Params for the self-describing modes."""
    p = MODES[mode]
    mesh = parallel.make_mesh(shards, device="cpu")
    secrets = [bytes([60 + i]) * (9 + 3 * i) for i in range(8)]
    ref = stt.embed_batch(covers, secrets, password="pw", params=p,
                          salts=SALTS, device="cpu")
    res = stt.embed_batch(covers, secrets, password="pw", params=p,
                          salts=SALTS, mesh=mesh, device_resident=True)
    assert isinstance(res.stego, pbatch.Sharded)
    np.testing.assert_array_equal(np.asarray(res.stego), ref.stego)
    reader = p if p.adaptive_alpha or p.jitter else Params(**FAST)
    assert stt.extract_batch(res.stego, password="pw", params=reader,
                             mesh=mesh) == secrets
    if p.adaptive_alpha:
        return
    nchw = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    got = stt.embed_batch(nchw, secrets, password="pw", params=p,
                          salts=SALTS, mesh=mesh, layout="nchw")
    np.testing.assert_array_equal(got.stego.transpose(0, 2, 3, 1),
                                  ref.stego)


_JAX_MESH_STEGO: dict = {}


def _jax_mesh_stego(covers, p, secrets):
    key = (p, tuple(secrets))
    if key not in _JAX_MESH_STEGO:
        _JAX_MESH_STEGO[key] = np.asarray(jbatch.embed_batch(
            covers, secrets, password="pw", params=jp(p), salts=SALTS,
            mesh=jpbatch.make_mesh(8)).stego)
    return _JAX_MESH_STEGO[key]


@pytest.mark.parametrize("mode", ["default", "piw+rs+qim"])
def test_mesh_stegos_cross_decode_with_jax(covers, mode):
    """The port's mesh stego reads back under JAX's mesh, JAX's mesh stego
    under the port's, recovery 1.0 both ways; the two packages' stego bytes
    differ by +-1 only, on at most 0.1% of bytes (the default mode's bf16
    stages round in other places; counted and printed)."""
    p = MODES[mode]
    mesh = parallel.make_mesh(8, device="cpu")
    secrets = [f"mesh-{mode}-{i}".encode() for i in range(8)]
    ts = stt.embed_batch(covers, secrets, password="pw", params=p,
                         salts=SALTS, mesh=mesh).stego
    js = _jax_mesh_stego(covers, p, secrets)
    plain = Params(**FAST)
    assert jbatch.extract_batch(ts, password="pw", params=jp(plain),
                                mesh=jpbatch.make_mesh(8)) == secrets
    assert stt.extract_batch(js, password="pw", params=plain,
                             mesh=mesh) == secrets
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    print(f"{mode}: {n} of {diff.size} bytes differ from JAX's mesh stego")
    assert np.abs(diff).max() <= 1
    assert n <= 1e-3 * diff.size


def test_extract_dispatch_takes_sharded_tensor_and_numpy(covers):
    p = Params(**FAST)
    mesh = parallel.make_mesh(4, device="cpu")
    secrets = [bytes([i]) * 20 for i in range(8)]
    res = stt.embed_batch(covers, secrets, password="pw", params=p,
                          salts=SALTS, mesh=mesh, device_resident=True)
    for imgs in (res.stego, res.stego.gather("cpu"), np.asarray(res.stego)):
        job = stt.extract_dispatch(imgs, password="pw", params=p, mesh=mesh,
                                   clen_hint=20)
        assert job.finalize() == secrets
    # a Sharded batch brings its mesh
    assert stt.extract_batch(res.stego, password="pw", params=p) == secrets


def test_mesh_rows_failing_the_batch_read_go_to_extract_array():
    """A coherent stego and a plain cover in a sharded batch (256x256: a
    coherent bit takes a whole site): the coherent row is read by
    extract_array on its shard, the cover reads None."""
    rng = np.random.default_rng(22)
    base = np.linspace(160, 230, 256)
    covers = np.clip(base[None, None, :, None]
                     + rng.integers(-15, 16, (4, 256, 256, 3)), 0,
                     255).astype(np.uint8)
    p = Params(**FAST)
    mesh = parallel.make_mesh(2, device="cpu")
    secrets = [bytes([i + 1]) * 12 for i in range(4)]
    stego = stt.embed_batch(covers, secrets, password="pw", params=p,
                            salts=SALTS[:4], device="cpu").stego.copy()
    coh = stt.embed_array(covers[3], b"coherent row", password="pw",
                          params=p.replace(coherent=True), device="cpu",
                          salt=bytes([9]) * 16)
    stego[3] = coh.stego
    stego[1] = covers[1]
    got = stt.extract_batch(stego, password="pw", params=p, mesh=mesh)
    assert got == [secrets[0], None, secrets[2], b"coherent row"]


@pytest.mark.parametrize("shards,failed", [(8, (1, 4, 6)), (2, (3, 6))])
def test_mesh_verify_retry(covers, monkeypatch, shards, failed):
    """verify=True over the mesh re-embeds the failed rows on the mesh when
    the mesh size divides their count, else unsharded (JAX: 3 failures on 8
    devices); every image verifies and reads back."""
    p = Params(**FAST)
    mesh = parallel.make_mesh(shards, device="cpu")
    secrets = [f"vm{i}".encode() for i in range(8)]
    real_extract, real_embed = tbatch.extract_batch, tbatch.embed_batch
    calls = {"n": 0}
    sub_meshes = []

    def flaky_extract(*a, **kw):
        out = real_extract(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            out = list(out)
            for i in failed:
                out[i] = None
        return out

    def recording_embed(*a, **kw):
        sub_meshes.append(kw.get("mesh"))
        return real_embed(*a, **kw)

    monkeypatch.setattr(tbatch, "extract_batch", flaky_extract)
    monkeypatch.setattr(tbatch, "embed_batch", recording_embed)
    res = real_embed(covers, secrets, password="pw", params=p, mesh=mesh,
                     salts=SALTS, verify=True)
    monkeypatch.undo()
    assert res.verified == [True] * 8
    assert sub_meshes == [mesh if len(failed) % shards == 0 else None]
    assert [s != s0 for s, s0 in zip(res.salts, SALTS)] == [
        i in failed for i in range(8)]
    assert stt.extract_batch(res.stego, password="pw", params=p,
                             device="cpu") == secrets


def test_stream_over_mesh(covers):
    """embed_stream / extract_stream over an 8-shard mesh equal the
    unsharded per-batch calls (JAX test_stream_over_mesh), at depth 1 and
    2."""
    mesh = parallel.make_mesh(8, device="cpu")
    p = Params(**FAST)
    secrets = [bytes([60 + i]) * 9 for i in range(8)]
    ref = stt.embed_batch(covers, secrets, password="pw", params=p,
                          salts=SALTS, device="cpu")
    jouts = list(jstream.embed_stream(
        iter([(covers, secrets, SALTS)]), password="pw", params=jp(p),
        mesh=jpbatch.make_mesh(8), depth=1))
    for depth in (1, 2):
        batches = [(covers, secrets, SALTS)] * 2
        outs = list(tstream.embed_stream(iter(batches), password="pw",
                                         params=p, mesh=mesh, depth=depth))
        for res in outs:
            assert isinstance(res.stego, pbatch.Sharded)
            np.testing.assert_array_equal(np.asarray(res.stego), ref.stego)
        got = list(tstream.extract_stream(
            [r.stego for r in outs] + [np.asarray(jouts[0].stego)],
            password="pw", params=p, mesh=mesh, depth=depth))
        assert got == [secrets] * 3


def test_channel_report_over_mesh_equals_unsharded(covers):
    p = Params(jitter=0.2, **FAST)
    secrets = [bytes([80 + i]) * 11 for i in range(8)]
    res = stt.embed_batch(covers, secrets, password="pw", params=p,
                          salts=SALTS, device="cpu")
    ref = stt.channel_report(res.stego, secrets, SALTS, password="pw",
                             params=p, per_image=True, device="cpu")
    got = stt.channel_report(res.stego, secrets, SALTS, password="pw",
                             params=p, per_image=True,
                             mesh=parallel.make_mesh(4, device="cpu"))
    assert got == ref and got["payload_ber_post_ecc"] == 0.0


def test_mesh_nondivisible_batch_raises_like_jax(covers):
    p = Params(**FAST)
    secrets = [b"x"] * 6
    with pytest.raises(ValueError):
        jbatch.embed_batch(covers[:6], secrets, password="pw", params=jp(p),
                           mesh=jpbatch.make_mesh(8))
    with pytest.raises(ValueError):
        stt.embed_batch(covers[:6], secrets, password="pw", params=p,
                        mesh=parallel.make_mesh(8, device="cpu"))
    with pytest.raises(ValueError):
        stt.extract_batch(covers[:6], password="pw", params=p,
                          mesh=parallel.make_mesh(8, device="cpu"))


@pytest.mark.parametrize("mode", ["default", "adaptive", "fft_dist"])
def test_shard_work_runs_under_its_card(covers, monkeypatch, mode):
    """Every shard's device work is dispatched under parallel.batch.card of
    its own device: each FFT (torch.fft; cuFFT on a card) and each forward
    corner DFT (K1 on a card) of a round trip over a 2-shard mesh, and of
    fft_dist's sharded embed and read, finds the context of its input's
    device entered. On four H100s, FFTs queued outside it gave stale
    spectra."""
    entered = []
    real_card = pbatch.card

    @contextlib.contextmanager
    def card(dev):
        entered.append(torch.device(dev))
        try:
            with real_card(dev):
                yield
        finally:
            entered.pop()

    calls = []

    def watch(owner, name):
        real = getattr(owner, name)

        def run(x, *a, **k):
            calls.append(bool(entered) and entered[-1] == x.device)
            return real(x, *a, **k)

        monkeypatch.setattr(owner, name, run)

    monkeypatch.setattr(pbatch, "card", card)
    monkeypatch.setattr(tfd, "card", card)
    for name in ("fft", "ifft", "fft2", "ifft2"):
        watch(torch.fft, name)
    watch(tcorner, "fwd_corner")
    if mode == "fft_dist":
        mesh = parallel.make_mesh(2, axis="image", device="cpu")
        rng = np.random.default_rng(23)
        planes = torch.from_numpy(_rand_planes(rng, 64, 64))
        idx = [torch.from_numpy(rng.integers(0, n, 50)) for n in (3, 64, 64)]
        bits = torch.from_numpy(rng.integers(0, 2, 50).astype(np.uint8))
        jit = torch.zeros(50)
        out = tfd.embed_core_distributed(planes, *idx, bits, jit, 0.5, mesh,
                                         adaptive=True)
        tfd.read_core_distributed(out, *idx, jit, 0.5, mesh, adaptive=True)
    else:
        p = MODES[mode]
        mesh = parallel.make_mesh(2, device="cpu")
        secrets = [bytes([70 + i]) * 12 for i in range(8)]
        res = stt.embed_batch(covers, secrets, password="pw", params=p,
                              salts=SALTS, mesh=mesh, device_resident=True)
        assert stt.extract_batch(res.stego, password="pw", params=p,
                                 mesh=mesh) == secrets
    assert calls and all(calls), calls
    assert not entered
