"""The port's single-image path against the JAX package's, on the CPU.

- Components on identical numpy-seeded inputs: fft2 / ifft2_real within
  1e-5 of the spectrum's max magnitude; median_upper (torch.kthvalue and
  the bisection twin), eligibility_mask, capacity_bits and
  cover_hash_features exactly equal; every ops/phase write within
  PHASE_TOL of the spectrum's scale and every read's bits equal; the f64
  NumpyBackend copy equal to the original.
- embed_array / extract_array in every wire mode on 256x256 covers: stegos
  cross-decode both ways with recovery 1.0; with a fixed salt the stego
  bytes of the hard-write modes differ from JAX's by +-1 on at most
  MAX_DIFF_FRAC of the bytes. Threshold-rule modes (soft write, QIM) are
  bounded loosely (one bin on a threshold moves a plane by a ripple); the
  coherent modes are held to the hard bound before their refine passes,
  and only counted and loosely bounded after them.
- cover_dependent_path runs on a cover whose low-frequency features sit
  mid-step (the port's utils/covers.py:midstep_cover): on a noise cover
  the embed itself moves a feature across a quantization step and neither
  package's own round trip recovers (the mode's known fragility,
  tests/test_roundtrip.py).
- complex128: on the CPU both packages run the f64 host backend; the
  card's route, the f64 TorchBackend, is held here against that backend
  and against the JAX package.
- Header misses: at 84% of capacity both packages lose the same salts'
  headers, on their own stegos and each other's, and for the same reason
  (two slots of one Rep-3 group on weak cover bins).
- The soft-decision retry recovers a pinned margin case the hard pass
  loses (tests/test_soft_decode.py's cover and salt).
- The JAX package's StegoErrors are raised where it raises them.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from steganosaurus_tpu import spectral as jspectral
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.ops import mask as jmask
from steganosaurus_tpu.ops import phase as jphase
from steganosaurus_tpu.ops import stats as jstats
from steganosaurus_tpu.pipeline import device as jdevice
from steganosaurus_tpu.pipeline.embed import embed_array as jembed
from steganosaurus_tpu.pipeline.extract import extract_array as jextract
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch import spectral as tspectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import mask as tmask
from steganosaurus_tpu_torch.ops import phase as tphase
from steganosaurus_tpu_torch.ops import stats as tstats
from steganosaurus_tpu_torch.pipeline import device as tdevice
from steganosaurus_tpu_torch.utils.covers import midstep_cover

torch.set_num_threads(2)

H, W = 256, 256
MK = bytes(range(32))
SALT = bytes([7]) * 16
FAST = dict(pbkdf2_iter=500)
SECRET = b"single-image secret, 33 bytes ok"
FFT_TOL = 1e-5        # of max |F|
PHASE_TOL = 1e-5      # of max |F|, for the written spectra
MAX_DIFF_FRAC = 5e-3  # hard-write modes: bytes differing (all by +-1)
LOOSE_DIFF_FRAC = 0.05  # threshold modes
COHERENT_DIFF_FRAC = 0.25  # after the coherent refine passes
COHERENT_MAX_DIFF = 4


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))


def _cover(seed=3, amp=20):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(60, 200, W)[None, :, None]
    return np.clip(ramp + rng.integers(-amp, amp + 1, (H, W, 3)), 0,
                   255).astype(np.uint8)


# --- components -------------------------------------------------------------

def _planes(seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (3, 96, 160)).astype(np.float32)


def test_fft2_and_ifft2_real_match_jax():
    x = _planes()
    j = np.asarray(jspectral.fft2(x, impl="xla"))
    t = tspectral.fft2(torch.from_numpy(x)).numpy()
    scale = np.abs(j).max()
    assert t.dtype == np.complex64
    assert np.abs(t - j).max() <= FFT_TOL * scale
    back_j = np.asarray(jspectral.ifft2_real(j, impl="xla"))
    back_t = tspectral.ifft2_real(_t(j)).numpy()
    assert np.abs(back_t - back_j).max() <= FFT_TOL * np.abs(back_j).max()
    np.testing.assert_allclose(back_t, x, atol=1e-3)


def test_from_planes_rounds_half_away_from_zero():
    v = np.array([[-0.6, -0.5, 0.49, 0.5, 1.5, 2.5, 254.5, 255.6, 300.0]],
                 np.float32)
    planes = np.broadcast_to(v, (3, 1, 9)).copy()
    want = np.asarray(jspectral.from_planes(planes))
    got = tspectral.from_planes(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 0].tolist() == [0, 0, 0, 1, 2, 3, 255, 255, 255]


def test_to_planes_and_pad_match_jax():
    img = _cover()
    np.testing.assert_array_equal(tspectral.to_planes(img),
                                  jspectral.to_planes(img))
    t = tspectral.to_planes(torch.from_numpy(img))
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, H, W)
    x = _planes()
    np.testing.assert_array_equal(
        tspectral.pad_planes(torch.from_numpy(x), 100, 170).numpy(),
        np.asarray(jspectral.pad_planes(x, 100, 170)))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_median_upper_equal_to_jax(n):
    """The same f32 magnitudes: kthvalue, the bisection twin and JAX's
    bisection give the same element, bit for bit (ties and repeats
    included)."""
    rng = np.random.default_rng(n)
    vals = np.abs(rng.standard_normal((3, n)) * 1e4).astype(np.float32)
    vals[:, : n // 3] = vals[:, :1]  # repeats
    want = np.asarray(jstats.median_upper(vals))
    t = torch.from_numpy(vals)
    got = tstats.median_upper(t).numpy()
    twin = tstats.kth_smallest_nonneg(t, n // 2).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(twin.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        tstats.kth_smallest_nonneg(t.double(), n // 2).numpy(),
        np.sort(vals.astype(np.float64), axis=-1)[:, n // 2])


@pytest.mark.parametrize("hw,rmin,rmax", [((256, 256), 0.05, 0.45),
                                          ((384, 640), 0.05, 0.45),
                                          ((97, 203), 0.1, 0.3),
                                          ((1080, 1920), 0.05, 0.45)])
def test_eligibility_mask_equal_to_jax(hw, rmin, rmax):
    t = tmask.eligibility_mask(*hw, rmin, rmax).numpy()
    np.testing.assert_array_equal(t, np.asarray(jmask.eligibility_mask(
        *hw, rmin, rmax)))


def test_capacity_median_and_features_equal_on_one_spectrum():
    """On the JAX package's own spectrum of a cover: medians, capacity and
    cover-hash feature bytes equal exactly."""
    img = _cover()
    spec_j = np.asarray(jspectral.fft2(jspectral.to_planes(img).astype(
        np.float32), impl="xla"))
    spec_t = _t(spec_j)
    med_j = np.asarray(jspectral.median_abs(spec_j))
    # the medians of the same f32 magnitudes (the two libraries' complex
    # abs may differ in the last ulp, so both take JAX's)
    mags = np.abs(spec_j).reshape(3, -1)
    np.testing.assert_array_equal(
        tstats.median_upper(torch.from_numpy(mags)).numpy(), med_j)
    med_t = tspectral.median_abs(spec_t).numpy()
    np.testing.assert_allclose(med_t, med_j, rtol=1e-6)
    thr = (0.01 * med_j).astype(np.float32)
    assert int(tmask.capacity_bits(spec_t, torch.from_numpy(thr), 0.05,
                                   0.45)) == int(jmask.capacity_bits(
                                       spec_j, thr, 0.05, 0.45))
    np.testing.assert_array_equal(
        tspectral.cover_hash_features(spec_t).numpy(),
        np.asarray(jspectral.cover_hash_features(spec_j)))


def test_cover_features_equal_through_each_fft():
    """Each package's own FFT of the same covers: the feature bytes agree
    (the cover-dependent walk keys on them across libraries)."""
    for img in (_cover(), midstep_cover(H, W, 1), midstep_cover(384, 640, 2)):
        p = Params()
        _, _, cap_t, ft = tdevice.TorchBackend("cpu").analyze(
            tspectral.to_planes(img), p)
        _, _, cap_j, fj = jdevice.JaxBackend().analyze(
            jspectral.to_planes(img), jp(p))
        np.testing.assert_array_equal(ft, fj)
        assert cap_t == cap_j


def _walk_bins(n, seed, plane_dim=True, Hh=96, Ww=160):
    """n distinct bins of the Hh x Ww grid with distinct mirrors, off the
    axes (what the walk guarantees), as int32 arrays; plane_dim=False keeps
    whole (y, x) sites distinct (the coherent walk's guarantee)."""
    rng = np.random.default_rng(seed)
    taken = set()
    out = []
    while len(out) < n:
        p, y, x = (int(rng.integers(0, 3)), int(rng.integers(1, Hh // 2)),
                   int(rng.integers(1, Ww)))
        if x == Ww // 2:
            continue
        cy, cx = (Hh - y) % Hh, (Ww - x) % Ww
        key = (p if plane_dim else 0, y, x)
        mir = (p if plane_dim else 0, cy, cx)
        if key in taken or mir in taken:
            continue
        taken |= {key, mir}
        out.append((p, y, x))
    a = np.asarray(out, np.int32)
    return a[:, 0], a[:, 1], a[:, 2]


def _spec():
    return np.asarray(jspectral.fft2(_planes(), impl="xla"))


def _t(a):
    return torch.from_numpy(np.array(a))


_j = jnp.asarray


@pytest.mark.parametrize("kw", [
    dict(), dict(soft=True), dict(floor=0.45), dict(soft=True, floor=0.45),
    dict(adaptive=True), dict(adaptive=True, floor=0.45),
    dict(hermitian_half=True, floor=0.45), dict(spread=True, soft=True)])
def test_embed_phases_matches_jax(kw):
    kw = dict(kw)
    adaptive = kw.pop("adaptive", False)
    spread = kw.pop("spread", False)
    spec = _spec()
    n = 700
    plane, y, x = _walk_bins(n, 11)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    jit = (rng.uniform(-0.3, 0.3, n)).astype(np.float32)
    alpha = (rng.uniform(0.5, 0.9, n).astype(np.float32) if spread
             else 0.5)
    med = np.asarray(jspectral.median_abs(spec))
    args = dict(kw, img_pixels=96.0 * 160, n_valid=n - 50)
    j = np.asarray(jphase.embed_phases(_j(spec), plane, y, x, bits, jit, alpha,
                                       med, adaptive, **args))
    t = tphase.embed_phases(_t(spec), _t(plane).long(), _t(y).long(),
                            _t(x).long(), _t(bits), _t(jit),
                            _t(alpha) if spread else alpha, _t(med),
                            adaptive, **args).numpy()
    scale = np.abs(spec).max()
    assert np.abs(t - j).max() <= PHASE_TOL * scale
    # the bits read back equal under both packages' read rules
    rj = np.asarray(jphase.read_phases(_j(j), plane, y, x, jit, 0.5, med,
                                       adaptive))
    rt = tphase.read_phases(_t(t), _t(plane).long(), _t(y).long(),
                            _t(x).long(), _t(jit), 0.5, _t(med),
                            adaptive).numpy()
    np.testing.assert_array_equal(rt, rj)


@pytest.mark.parametrize("L", [2, 5])
def test_qim_phases_match_jax(L):
    spec = _spec()
    n = 600
    plane, y, x = _walk_bins(n, 21)
    rng = np.random.default_rng(22)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    d = rng.uniform(0, 2 * np.pi / L, n).astype(np.float32)
    j = np.asarray(jphase.embed_phases_qim(_j(spec), plane, y, x, bits, d, L,
                                           floor=0.45, img_pixels=15360.0))
    pl, yy, xx = (_t(a).long() for a in (plane, y, x))
    t = tphase.embed_phases_qim(_t(spec), pl, yy, xx, _t(bits), _t(d), L,
                                floor=0.45, img_pixels=15360.0).numpy()
    scale = np.abs(spec).max()
    # a bin whose lattice coordinate sits on a half-step may round to the
    # other centroid of its coset in one package: count, do not forgive
    moved = np.abs(t - j) > PHASE_TOL * scale
    assert moved.sum() <= 2, moved.sum()
    for s in (j, t):
        vj = np.asarray(jphase.read_values_qim(_j(s), plane, y, x, d, L))
        vt = tphase.read_values_qim(_t(s), pl, yy, xx, _t(d), L).numpy()
        assert np.abs(vt - vj).max() <= PHASE_TOL * scale
        np.testing.assert_array_equal(
            tphase.read_phases_qim(_t(s), pl, yy, xx, _t(d), L).numpy(),
            np.asarray(jphase.read_phases_qim(_j(s), plane, y, x, d, L)))
        np.testing.assert_array_equal(
            tphase.read_phases_qim(_t(s), pl, yy, xx, _t(d), L).numpy(),
            bits)


@pytest.mark.parametrize("mode", ["hard", "soft", "qim", "hard_half"])
def test_coherent_phases_match_jax(mode):
    spec = _spec()
    n = 400
    _, y, x = _walk_bins(n, 31, plane_dim=False)
    rng = np.random.default_rng(32)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    jit = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    d = rng.uniform(0, 2 * np.pi / 4, n).astype(np.float32)
    kw = dict(floor=0.45, img_pixels=15360.0, n_valid=n - 20)
    yy, xx = _t(y).long(), _t(x).long()
    if mode == "qim":
        j = np.asarray(jphase.embed_phases_coherent_qim(
            _j(spec), y, x, bits, d, 4, **kw))
        t = tphase.embed_phases_coherent_qim(_t(spec), yy, xx, _t(bits),
                                             _t(d), 4, **kw).numpy()
    else:
        kw.update(soft=mode == "soft", hermitian_half=mode == "hard_half")
        j = np.asarray(jphase.embed_phases_coherent(_j(spec), y, x, bits, jit,
                                                    0.5, **kw))
        t = tphase.embed_phases_coherent(_t(spec), yy, xx, _t(bits),
                                         _t(jit), 0.5, **kw).numpy()
    scale = np.abs(spec).max()
    assert np.abs(t - j).max() <= PHASE_TOL * scale
    if mode == "hard_half":
        return
    for s in (j, t):
        if mode == "qim":
            vj = np.asarray(jphase.read_values_coherent_qim(_j(s), y, x, d, 4))
            vt = tphase.read_values_coherent_qim(_t(s), yy, xx, _t(d),
                                                 4).numpy()
            bt = tphase.read_phases_coherent_qim(_t(s), yy, xx, _t(d),
                                                 4).numpy()
        else:
            vj = np.asarray(jphase.read_values_coherent(_j(s), y, x, jit, 0.5))
            vt = tphase.read_values_coherent(_t(s), yy, xx, _t(jit),
                                             0.5).numpy()
            bt = tphase.read_phases_coherent(_t(s), yy, xx, _t(jit),
                                             0.5).numpy()
        assert np.abs(vt - vj).max() <= 3 * PHASE_TOL * scale
        np.testing.assert_array_equal(bt, (vj >= 0).astype(np.uint8))
        np.testing.assert_array_equal(bt, bits)


def test_read_values_and_helpers_match_jax():
    spec = _spec()
    n = 500
    plane, y, x = _walk_bins(n, 41)
    rng = np.random.default_rng(42)
    jit = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    med = np.asarray(jspectral.median_abs(spec))
    pl, yy, xx = (_t(a).long() for a in (plane, y, x))
    for adaptive in (False, True):
        vj = np.asarray(jphase.read_values(
            _j(spec), plane, y, x, jit, 0.5, med, adaptive))
        vt = tphase.read_values(_t(spec), pl, yy, xx, _t(jit), 0.5, _t(med),
                                adaptive).numpy()
        assert np.abs(vt - vj).max() <= PHASE_TOL * np.abs(spec).max()
        np.testing.assert_array_equal(
            tphase.read_phases(_t(spec), pl, yy, xx, _t(jit), 0.5, _t(med),
                               adaptive).numpy(),
            np.asarray(jphase.read_phases(_j(spec), plane, y, x, jit, 0.5, med,
                                          adaptive)))
    cy, cx = tphase.conj_indices(yy, xx, 96, 160)
    jy, jx = jphase.conj_indices(y, x, 96, 160)
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jx))
    v = spec[plane, y, x]
    nv = v * np.exp(1j * 0.3).astype(np.complex64)
    wm = np.arange(n) < n - 7
    bj = float(jphase.write_floor_boost(jnp.asarray(v), jnp.asarray(nv),
                                        jnp.asarray(wm), 15360.0, 0.45))
    bt = float(tphase.write_floor_boost(_t(v), _t(nv), _t(wm), 15360.0,
                                        0.45))
    assert abs(bt - bj) <= 1e-5 * bj


def test_numpy_backend_copy_equal_to_jax():
    """The port's f64 backend is the JAX package's, byte for byte: analyze,
    embed_apply in the plain, soft, QIM and coherent forms, and the reads."""
    img = _cover(seed=9)
    planes = jspectral.to_planes(img)
    tb, jb = tdevice.NumpyBackend(), jdevice.NumpyBackend()
    for p in (Params(), Params(soft_write=True, jitter=0.2),
              Params(qim=3), Params(coherent=True),
              Params(coherent=True, qim=4), Params(adaptive_alpha=True)):
        st, mt, ct, ft = tb.analyze(planes, p)
        sj, mj, cj, fj = jb.analyze(planes, jp(p))
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(mt, mj)
        assert ct == cj
        np.testing.assert_array_equal(ft, fj)
        n = 1500
        _, y, x = _walk_bins(n, 51, plane_dim=False, Hh=H, Ww=W)
        plane = (np.arange(n) % 3).astype(np.int32)
        rng = np.random.default_rng(52)
        bits = rng.integers(0, 2, n).astype(np.uint8)
        jit = rng.uniform(-0.2, 0.2, n)
        d = rng.uniform(0, 1, n).astype(np.float32)
        kw = dict(qim_dithers=d, hdr_bits=912)
        np.testing.assert_array_equal(
            tb.embed_apply(st, mt, (plane, y, x), bits, jit, 0.5, p, H, W,
                           **kw),
            jb.embed_apply(sj, mj, (plane, y, x), bits, jit, 0.5, jp(p), H, W,
                           **kw))
        for name, args in (
                ("read_bits", (st, mt, (plane, y, x), jit, 0.5)),
                ("read_values", (st, mt, (plane, y, x), jit, 0.5))):
            np.testing.assert_array_equal(getattr(tb, name)(*args, p),
                                          getattr(jb, name)(*args, jp(p)))
        for name, args in (("read_bits_qim", (st, (plane, y, x), d, 3)),
                           ("read_values_coherent", (st, (y, x), jit, 0.5)),
                           ("read_bits_coherent_qim", (st, (y, x), d, 4))):
            np.testing.assert_array_equal(getattr(tb, name)(*args),
                                          getattr(jb, name)(*args))


@pytest.mark.parametrize("rs", [False, True])
def test_frame_bits_equal_to_jax(rs):
    """The shared ECC frame (pipeline/frame.py) is the JAX single-image
    frame_bits, bit for bit, under Rep-7 and RS."""
    from steganosaurus_tpu.pipeline.embed import frame_bits as jframe
    from steganosaurus_tpu_torch.pipeline import embed as tembed

    rng = np.random.default_rng(61)
    hb, ct, tag = (bytes(rng.integers(0, 256, n, dtype=np.uint8))
                   for n in (38, 300, 16))
    want = np.asarray(jframe(hb, ct, tag, rs=rs))
    np.testing.assert_array_equal(tembed.frame_bits(hb, ct, tag, rs=rs),
                                  want)


F64_TOL = 1e-12  # of max |F|: two f64 FFT libraries


@pytest.mark.parametrize("p", [
    Params(), Params(soft_write=True, jitter=0.2), Params(qim=3),
    Params(coherent=True), Params(coherent=True, qim=4),
    Params(adaptive_alpha=True)], ids=lambda p: "_".join(
        k for k in ("soft_write", "qim", "coherent", "adaptive_alpha")
        if getattr(p, k)) or "default")
def test_f64_torch_backend_matches_the_numpy_backend(p):
    """The card's complex128 route, TorchBackend in complex128 (on the CPU
    here), against the f64 NumpyBackend on the same planes and bins: the
    spectra within F64_TOL, medians within 1e-12, capacity and features
    equal; each backend's stego read back by the other to the written
    bits, and the stegos within +-1 of each other (QIM: the torch split
    write boosts its header and payload slots to the floor apart, as the
    JAX device backend does, and the NumpyBackend jointly)."""
    img = _cover(seed=9)
    planes = tspectral.to_planes(img)
    tb = tdevice.TorchBackend("cpu", torch.complex128)
    nb = tdevice.NumpyBackend()
    st, mt, ct, ft = tb.analyze(planes, p)
    sn, mn, cn, fn = nb.analyze(planes, p)
    assert st.dtype == torch.complex128
    scale = np.abs(sn).max()
    assert np.abs(st.numpy() - sn).max() <= F64_TOL * scale
    np.testing.assert_allclose(mt.numpy(), mn, rtol=1e-12)
    assert ct == cn
    np.testing.assert_array_equal(ft, fn)
    n = 1500
    _, y, x = _walk_bins(n, 51, plane_dim=False, Hh=H, Ww=W)
    plane = (np.arange(n) % 3).astype(np.int32)
    rng = np.random.default_rng(52)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    jit = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    d = rng.uniform(0, 1, n)
    kw = dict(qim_dithers=d, hdr_bits=912)
    out_t = tb.embed_apply(st, mt, (plane, y, x), bits, jit, 0.5, p, H, W,
                           **kw).numpy()
    out_n = nb.embed_apply(sn, mn, (plane, y, x), bits, jit, 0.5, p, H, W,
                           **kw)
    diff = out_t.astype(np.int16) - out_n.astype(np.int16)
    assert np.abs(diff).max() <= 1
    if not p.qim or p.coherent:
        assert np.count_nonzero(diff) <= MAX_DIFF_FRAC * diff.size
    hdr, pay = slice(0, 912), slice(912, None)
    for be, out in ((tb, out_n), (nb, out_t)):
        spec, med, _, _ = be.analyze(tspectral.to_planes(out), p)
        if p.coherent:
            got = np.concatenate([
                be.read_bits_coherent(spec, (y[hdr], x[hdr]), jit[hdr], 0.5),
                be.read_bits_coherent_qim(spec, (y[pay], x[pay]), d[pay], 4)
                if p.qim else be.read_bits_coherent(
                    spec, (y[pay], x[pay]), jit[pay], 0.5)])
        elif p.qim:
            got = np.concatenate([
                be.read_bits(spec, med, (plane[hdr], y[hdr], x[hdr]),
                             jit[hdr], 0.5, p),
                be.read_bits_qim(spec, (plane[pay], y[pay], x[pay]), d[pay],
                                 3)])
        else:
            got = be.read_bits(spec, med, (plane, y, x), jit, 0.5, p)
        # a bin whose cover magnitude sits below the rounding noise cannot
        # hold its phase in either backend: the two agree on those too
        assert np.mean(got != bits) <= 0.01


@pytest.mark.parametrize("mode", ["default", "qim", "coherent"])
def test_complex128_card_route_cross_decodes_with_jax(mode, monkeypatch):
    """embed_array / extract_array under Params(fft_dtype="complex128")
    through the route a card takes (the f64 TorchBackend; forced onto the
    CPU here): recovery 1.0 both ways against the JAX package's f64
    backend, and stego bytes within +-1 of JAX's on at most MAX_DIFF_FRAC
    (the coherent refine passes: counted, COHERENT bounds)."""
    monkeypatch.setattr(
        tdevice, "_backend_on",
        lambda params, dev: tdevice.TorchBackend(dev, torch.complex128))
    base, kind = MODES[mode]
    p = base.replace(fft_dtype="complex128")
    cover = _cover()
    ts = stt.embed_array(cover, SECRET, password="pw", params=p, salt=SALT,
                         device="cpu").stego
    js = np.asarray(jembed(cover, SECRET, password="pw", params=jp(p),
                           salt=SALT).stego)
    assert stt.extract_array(ts, password="pw", params=p,
                             device="cpu") == SECRET
    assert stt.extract_array(js, password="pw", params=p,
                             device="cpu") == SECRET
    assert jextract(ts, password="pw", params=jp(p)) == SECRET
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    print(f"{mode} complex128: {n} of {diff.size} bytes differ")
    if kind == "coherent":
        assert np.abs(diff).max() <= COHERENT_MAX_DIFF
        assert n <= COHERENT_DIFF_FRAC * diff.size
    else:
        assert np.abs(diff).max() <= 1
        assert n <= MAX_DIFF_FRAC * diff.size


def test_extraction_skips_the_median_unless_adaptive(monkeypatch):
    """extract_array reads no median unless Params.adaptive_alpha (the
    exact median is most of a 4K extract's device time): analyze(lazy=True)
    leaves medians and capacity out, and a stego reads back with
    median_abs unavailable."""
    _, ts, _ = _pair("default")
    tb = tdevice.TorchBackend("cpu")
    planes = tspectral.to_planes(ts)
    _, med, cap, _ = tb.analyze(planes, Params(), lazy=True)
    assert med is None and cap is None
    _, med, cap, _ = tb.analyze(planes, Params(adaptive_alpha=True),
                                lazy=True)
    assert med.shape == (3,) and cap is None

    def no_median(spec):
        raise AssertionError("median computed")

    monkeypatch.setattr(tspectral, "median_abs", no_median)
    assert stt.extract_array(ts, password="pw", params=MODES["default"][0],
                             device="cpu") == SECRET


def test_single_image_scatter_indices_are_unique():
    """index_put_ agrees with jnp .at[].set only where no index repeats
    with another value: the port's single-image walks have exact lengths,
    so every written bin and every mirror is distinct."""
    from steganosaurus_tpu_torch import crypto, keystream

    pk = crypto.derive_path_key(None, MK)
    kw, kr, kg, kb = crypto.derive_turtle_keys(pk)
    plane, y, x, _ = keystream.turtle_expand(kw, (kr, kg, kb), H, W, 0.05,
                                             0.45, 0.7, 0.0, 5000)
    cy, cx = tphase.conj_indices(_t(y), _t(x), H, W)
    flat = np.concatenate([(plane * H + y) * W + x,
                           (plane * H + cy.numpy()) * W + cx.numpy()])
    assert np.unique(flat).size == flat.size


# --- embed_array / extract_array --------------------------------------------

MODES = {
    "default": (Params(**FAST), "hard"),
    "jitter": (Params(jitter=0.3, **FAST), "hard"),
    "soft_write": (Params(soft_write=True, **FAST), "loose"),
    "alpha_spread": (Params(alpha_spread=0.5, **FAST), "hard"),
    "qim": (Params(qim=3, **FAST), "loose"),
    "rs_pad": (Params(rs=True, pad_quantum=64, **FAST), "hard"),
    "per_image_walk": (Params(per_image_walk=True, **FAST), "hard"),
    "stealth": (Params.stealth(**FAST), "loose"),
    "coherent": (Params(coherent=True, **FAST), "coherent"),
    "coherent_qim": (Params(coherent=True, qim=4, **FAST), "coherent"),
    "adaptive_alpha": (Params(adaptive_alpha=True, **FAST), "hard"),
    "cover_dependent_path": (Params(cover_dependent_path=True, **FAST),
                             "hard"),
    "complex128": (Params(fft_dtype="complex128", **FAST), "exact"),
}
_CACHE: dict = {}


def _pair(mode):
    """(cover, port stego, JAX stego) under `mode`, fixed salt."""
    if mode not in _CACHE:
        p, _ = MODES[mode]
        cover = (midstep_cover(H, W, 1) if mode == "cover_dependent_path"
                 else _cover())
        t = stt.embed_array(cover, SECRET, password="pw", params=p, salt=SALT,
                            device="cpu")
        j = jembed(cover, SECRET, password="pw", params=jp(p), salt=SALT)
        assert t.written_bits == j.written_bits
        assert t.capacity_bits == j.capacity_bits
        assert t.payload_bytes == len(SECRET)
        _CACHE[mode] = (cover, t.stego, np.asarray(j.stego))
    return _CACHE[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_decode_both_ways(mode):
    p, _ = MODES[mode]
    _, ts, js = _pair(mode)
    assert isinstance(ts, np.ndarray) and ts.dtype == np.uint8
    assert ts.shape == (H, W, 3)
    assert stt.extract_array(ts, password="pw", params=p,
                             device="cpu") == SECRET
    assert jextract(ts, password="pw", params=jp(p)) == SECRET
    assert stt.extract_array(js, password="pw", params=p,
                             device="cpu") == SECRET


@pytest.mark.parametrize("mode", list(MODES))
def test_stego_bytes_match_jax(mode):
    """Fixed salt: +-1 on at most MAX_DIFF_FRAC of the bytes (hard-write
    modes), exactly equal under the shared f64 backend, at most
    LOOSE_DIFF_FRAC (by at most 2, a ripple plus the rounding) for the
    threshold modes. The coherent refine passes re-rotate near-cancelled
    sites (whose common-mode phase jumps with any noise) by large angles,
    so the two packages' last-bit differences grow pass by pass: counted
    and bounded by COHERENT_DIFF_FRAC and COHERENT_MAX_DIFF only, with the
    first pass held to the hard bound in
    test_coherent_first_pass_matches_jax."""
    _, kind = MODES[mode]
    _, ts, js = _pair(mode)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    print(f"{mode}: {n} of {diff.size} bytes differ, max {np.abs(diff).max()}")
    if kind == "exact":
        assert n == 0
    elif kind == "hard":
        assert np.abs(diff).max() <= 1
        assert n <= MAX_DIFF_FRAC * diff.size, n
    elif kind == "coherent":
        assert np.abs(diff).max() <= COHERENT_MAX_DIFF
        assert n <= COHERENT_DIFF_FRAC * diff.size, n
    else:
        assert np.abs(diff).max() <= 2
        assert n <= LOOSE_DIFF_FRAC * diff.size, n


@pytest.mark.parametrize("mode", ["coherent", "coherent_qim"])
def test_coherent_first_pass_matches_jax(mode, monkeypatch):
    """With the refine passes taken out of both packages, the coherent
    write itself (header and payload common-mode rotations, the floor
    boost over three planes) gives stego bytes within the hard-write
    bound of JAX's."""
    import importlib

    p, _ = MODES[mode]
    for name in ("steganosaurus_tpu.pipeline.embed",
                 "steganosaurus_tpu_torch.pipeline.embed"):
        monkeypatch.setattr(importlib.import_module(name),
                            "_refine_coherent",
                            lambda backend, stego, *a, **k: stego)
    cover = _cover()
    t = stt.embed_array(cover, SECRET, password="pw", params=p, salt=SALT,
                        device="cpu").stego
    j = np.asarray(jembed(cover, SECRET, password="pw", params=jp(p),
                          salt=SALT).stego)
    diff = t.astype(np.int16) - j.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= MAX_DIFF_FRAC * diff.size


def test_tensor_in_tensor_out_and_files(tmp_path):
    """A torch image runs on its own device and returns a tensor there;
    embed/extract go through PNG files (the port's encoder, byte-equal to
    the JAX package's)."""
    from steganosaurus_tpu.io import image as jimage

    cover = _cover(seed=4)
    res = stt.embed_array(torch.from_numpy(cover), SECRET, master_key=MK,
                          params=Params(**FAST), salt=SALT)
    assert isinstance(res.stego, torch.Tensor)
    assert res.stego.device.type == "cpu" and res.stego.dtype == torch.uint8
    assert stt.extract_array(res.stego, master_key=MK,
                             params=Params(**FAST)) == SECRET
    src = tmp_path / "cover.png"
    jimage.save_png(str(src), cover)
    out = tmp_path / "stego.png"
    r2 = stt.embed(str(src), str(out), SECRET.decode(), password="pw",
                   params=Params(**FAST), device="cpu")
    assert out.read_bytes() == jimage.encode_png(r2.stego)
    assert stt.extract(str(out), password="pw", params=Params(**FAST),
                       device="cpu") == SECRET
    assert jextract(jimage.load_rgb(str(out)), password="pw",
                    params=jp(Params(**FAST))) == SECRET


def test_soft_retry_recovers_the_margin_case():
    """tests/test_soft_decode.py's pinned case: full-range noise, a
    240-byte secret at the capacity edge, salt 4. The hard pass fails on
    the JAX package's stego and on the port's; the soft retry recovers
    both, in both packages."""
    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    hard = Params(soft_decode_fallback=False)
    salt = bytes([4]) * 16
    js = np.asarray(jembed(cover, secret, master_key=MK, params=jp(hard),
                           salt=salt).stego)
    ts = stt.embed_array(cover, secret, master_key=MK, params=hard, salt=salt,
                         device="cpu").stego
    for stego in (js, ts):
        with pytest.raises(stt.StegoError):
            stt.extract_array(stego, master_key=MK, params=hard, device="cpu")
        assert stt.extract_array(stego, master_key=MK, params=Params(),
                                 device="cpu") == secret
        assert jextract(stego, master_key=MK, params=JParams()) == secret


def test_header_margin_failure_matches_jax():
    """At 84% of capacity (1080p, 4 KB, jitter 0.3; chip_smoke.py 7b's
    cover and secret) one Rep-3 header group can keep two flipped copies:
    with salt 2 neither package's extract_array finds the magic (it has no
    soft header trial, in either package), on its own stego or the other
    package's; with salt 18 all read back. The port fails exactly where
    the JAX package fails."""
    rng = np.random.default_rng(41)
    base = np.linspace(140, 230, 1920)
    cover = np.clip(base[None, None, :, None]
                    + rng.integers(-25, 26, (2, 1080, 1920, 3)), 0,
                    255).astype(np.uint8)[1]
    secret = bytes(np.random.default_rng(7).integers(0, 256, 4096,
                                                     dtype=np.uint8))
    p = Params(jitter=0.3)

    def reads(extract, stego, **kw):
        try:
            return extract(stego, master_key=MK, **kw) == secret
        except Exception as e:  # noqa: BLE001 — both packages' StegoError
            assert "Magic not found" in str(e)
            return False

    for s, want in ((2, False), (18, True)):
        salt = bytes([s]) * 16
        ts = stt.embed_array(cover, secret, master_key=MK, params=p,
                             salt=salt, device="cpu").stego
        js = np.asarray(jembed(cover, secret, master_key=MK, params=jp(p),
                               salt=salt).stego)
        got = [reads(stt.extract_array, st, params=p, device="cpu")
               for st in (ts, js)]
        got += [reads(jextract, st, params=jp(p)) for st in (ts, js)]
        assert got == [want] * 4, (s, got)


def _header_miss_groups(stego, secret, key, salt, p):
    """Rep-3 header groups with two or more of their three slots read wrong
    off `stego` by the port's reader (the true header rebuilt from the key,
    the salt and the secret)."""
    from steganosaurus_tpu_torch import crypto, keystream
    from steganosaurus_tpu_torch.pipeline import frame, header

    h, w = stego.shape[:2]
    n = frame.HEADER_STREAM_BITS
    kw, kr, kg, kb = crypto.derive_turtle_keys(
        crypto.derive_path_key(None, key))
    walk = keystream.turtle_expand(kw, (kr, kg, kb), h, w, p.rmin, p.rmax,
                                   p.density, p.jitter, n)
    with crypto.derive_keys_vault(None, key, salt=salt,
                                  iters=p.pbkdf2_iter) as km:
        hb, ct, tag = header.seal_stream(secret, km, 0, p.pad_quantum)
    want = frame.frame_bits(hb + ct + tag)[:n]
    be = tdevice.TorchBackend("cpu")
    spec = be.analyze(tspectral.to_planes(stego), p, lazy=True)[0]
    err = be.read_bits(spec, None, walk[:3], walk[3], p.alpha, p) != want
    return np.flatnonzero(err.reshape(-1, 3).sum(axis=1) >= 2).tolist()


def test_header_miss_salts_match_jax():
    """chip_smoke.py 7a's mechanism on a 384x640 cover of its recipe (seed
    42 gradient + [-18, 18] noise) at its load, 84% of capacity: the header
    walk is keyed by the key alone, so every salt writes its header on the
    same bins, and under this key two slots of Rep-3 group 10 (a bit of
    the magic) sit on weak cover bins (|F| 317 and 618, against a u8
    rounding noise of 143 per bin and a median |F| of 4409). At salts
    2 and 3 both read wrong and extract_array finds no magic; the others
    read back. Both packages miss exactly those salts, on their own stegos
    and each other's, and group 10 is the one that fails in both
    packages' stegos."""
    h, w = 384, 640
    rng = np.random.default_rng(42)
    cover = np.clip(np.linspace(150, 235, w)[None, :, None]
                    + rng.integers(-18, 19, (h, w, 3)), 0,
                    255).astype(np.uint8)
    secret = bytes(np.random.default_rng(7).integers(0, 256, 485,
                                                     dtype=np.uint8))
    key = bytes([16]) * 32
    p = Params(pbkdf2_iter=500)

    def reads(extract, stego, **kw):
        try:
            return extract(stego, master_key=key, **kw) == secret
        except Exception as e:  # noqa: BLE001 — both packages' StegoError
            assert "Magic not found" in str(e)
            return False

    for s in range(6):
        salt = bytes([s]) * 16
        ts = stt.embed_array(cover, secret, master_key=key, params=p,
                             salt=salt, device="cpu").stego
        js = np.asarray(jembed(cover, secret, master_key=key, params=jp(p),
                               salt=salt).stego)
        want = s not in (2, 3)
        got = [reads(stt.extract_array, st, params=p, device="cpu")
               for st in (ts, js)]
        got += [reads(jextract, st, params=jp(p)) for st in (ts, js)]
        assert got == [want] * 4, (s, got)
        groups = [_header_miss_groups(st, secret, key, salt, p)
                  for st in (ts, js)]
        assert groups == [[] if want else [10]] * 2, (s, groups)


@pytest.mark.parametrize("kw,match", [
    (dict(coherent=True, adaptive_alpha=True), "mutually exclusive"),
    (dict(coherent=True, cover_dependent_path=True), "mutually exclusive"),
    (dict(per_image_walk=True, cover_dependent_path=True),
     "mutually exclusive"),
    (dict(qim=3, adaptive_alpha=True), "mutually exclusive"),
    (dict(qim=1), "qim level"),
    (dict(alpha_spread=-1.0), "alpha_spread"),
])
def test_embed_errors_like_jax(kw, match):
    p = Params(**FAST).replace(**kw)
    cover = _cover()
    with pytest.raises(stt.StegoError, match=match):
        stt.embed_array(cover, b"x", password="pw", params=p, device="cpu")
    with pytest.raises(Exception, match=match):
        jembed(cover, b"x", password="pw", params=jp(p))


def test_capacity_and_key_errors_like_jax():
    cover = _cover()
    p = Params(**FAST)
    big = b"x" * 400
    with pytest.raises(stt.StegoError, match="Message too large") as te:
        stt.embed_array(cover, big, password="pw", params=p, device="cpu")
    with pytest.raises(Exception, match="Message too large") as je:
        jembed(cover, big, password="pw", params=jp(p))
    assert str(te.value) == str(je.value)
    coh = Params(coherent=True, **FAST)
    with pytest.raises(stt.StegoError, match="Message too large"):
        stt.embed_array(cover, b"y" * 140, password="pw", params=coh,
                        device="cpu")
    with pytest.raises(ValueError):
        stt.embed_array(cover, b"x", params=p, device="cpu")
    _, ts, _ = _pair("default")
    with pytest.raises(stt.StegoError, match="Magic not found"):
        stt.extract_array(ts, password="wrong", params=p, device="cpu")
    with pytest.raises(stt.StegoError, match="Magic not found"):
        stt.extract_array(cover, password="pw", params=p, device="cpu")
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            stt.embed_array(cover, b"x", password="pw", params=p)
        with pytest.raises(RuntimeError, match="CUDA"):
            stt.extract_array(cover, password="pw", params=p)
