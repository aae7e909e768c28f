"""The corner DFT's precision modes (STEGANOSAURUS_MM_PRECISION) and the
forward stage-2 band width (STEGANOSAURUS_SPLIT_X0) in the port, against
the JAX package on the CPU.

256x384 covers (a Ky = Kx = 256 corner: the 64-column band is a real split),
B = 2, 96-byte secrets, a fixed master key and fixed salts, inputs made from
numpy seeds. On the CPU both packages compute HIGH as f32 products and bf16
as bf16-rounded operands with f32 products, so the spectra and inverse DFTs
agree to REL = 1e-5 of their scale (only the order of f32 sums differs), and
stego bytes differ by +-1 on at most MAX_DIFF_FRAC of the bytes. The JAX
package builds its batch cores once per shape and reads the mode when it
builds them: each test that sets a mode empties those caches before it runs
and after (the `mode` fixture).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import steganosaurus_tpu_torch as stt
from steganosaurus_tpu import spectral as jspectral
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.parallel import batch as jparallel
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.pipeline import device as jdevice
from steganosaurus_tpu.spectral import corner as jcorner
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel import batch as tpb
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.spectral import corner_kernels as ck
from steganosaurus_tpu_torch.spectral import write_kernels as wk

torch.set_num_threads(2)

H, W, B, SECRET = 256, 384, 2, 96
MK = bytes(range(32))
SALTS = [bytes([i]) * 16 for i in range(B)]
REL = 1e-5
MAX_DIFF_FRAC = 5e-3
MODES = ("mix_split", "mix_adaptive", "mix", "mix3", "mix2",
         "mix_conservative", "bf16", "high", "highest")
# the JAX tuple's values by the port's names for them
JAX_NAMES = {jax.lax.Precision.HIGH: "high",
             jax.lax.Precision.HIGHEST: "highest"}


def _clear_jax_cores():
    for module in (jparallel, jbatch, jdevice):
        for v in vars(module).values():
            if hasattr(v, "cache_clear"):
                v.cache_clear()


@pytest.fixture
def mode(monkeypatch):
    """set(name, x0=None): the precision mode (and SPLIT_X0) for both
    packages, the JAX batch cores rebuilt under it."""
    def set_mode(name, x0=None):
        monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", name)
        if x0 is None:
            monkeypatch.delenv("STEGANOSAURUS_SPLIT_X0", raising=False)
        else:
            monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", str(x0))
        _clear_jax_cores()

    yield set_mode
    _clear_jax_cores()


def _dims():
    return tcorner.corner_dims(H, W, Params().rmax)


def _covers(seed=21):
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 235, W)
    imgs = np.clip(base[None, None, :, None]
                   + rng.integers(-18, 19, (B, H, W, 3)), 0,
                   255).astype(np.uint8)
    return np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))


def _secrets(seed=22):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, SECRET, dtype=np.uint8))
            for _ in range(B)]


def _max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


# --- precision() ---------------------------------------------------------------

@pytest.mark.parametrize("name", MODES)
def test_precision_resolves_to_jax_stages(name, mode):
    """Each name resolves to the JAX tuple's stage precisions: JAX orders
    them stage 1, forward stage 2, the inverse's x-stage, its y-stage
    (ifft_corner_real reads precision[3] for the y-stage)."""
    mode(name)
    p = tcorner.precision()
    want = tuple(JAX_NAMES.get(v, v) for v in jcorner.precision())
    assert p.name == name
    assert (p.stage1, p.fwd2, p.inv_x, p.inv_y) == want
    assert tcorner.stages(name) == p == tcorner.stages(p)
    assert set(p[1:]) <= {*tcorner.STAGE_PRECISIONS, "split", "adaptive"}


def test_unknown_name_raises_where_jax_runs_highest(mode):
    mode("mixx")
    with pytest.raises(ValueError, match="mixx"):
        tcorner.precision()
    assert jcorner.precision() == (jax.lax.Precision.HIGHEST,) * 4
    with pytest.raises(ValueError):
        tcorner._stage("mixx", "inv_y")


def test_bf16_mode_warns_once(monkeypatch, capsys):
    monkeypatch.setattr(tcorner, "_warned_bf16", False)
    for _ in range(3):
        assert tcorner.resolve("bf16").fwd2 == "bf16"
    tcorner.resolve("mix")
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("steganosaurus_tpu_torch:")
    assert "break 4K/16KB payload recovery" in err[0]


@pytest.mark.parametrize("x0", ["0", "64", "100", "2048"])
def test_split_x0_reads_the_env(x0, monkeypatch):
    monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", x0)
    assert tcorner.split_x0() == jcorner.split_x0() == int(x0)
    monkeypatch.delenv("STEGANOSAURUS_SPLIT_X0")
    assert tcorner.split_x0() == tcorner.SPLIT_X0 == 64
    monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", "-1")
    with pytest.raises(ValueError):
        tcorner.split_x0()


# --- the corner DFTs against JAX's --------------------------------------------

@pytest.mark.parametrize("name", MODES)
def test_fwd_corner_matches_jax(name, mode):
    mode(name)
    imgs = _covers()
    center = name in ("mix", "mix2", "high")
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    cr, ci = tcorner.fwd_corner(torch.from_numpy(imgs), center, Ky, Kx,
                                tabs, tcorner.precision())
    planes = jspectral.apply_center(jnp.asarray(imgs, jnp.float32), center)
    jr, ji = jcorner.fwd_corner(planes, Ky, Kx,
                                jcorner.dft_tables_device(H, Ky, W, Kx),
                                jcorner.precision())
    scale = float(jnp.max(jnp.maximum(jnp.abs(jr), jnp.abs(ji))))
    assert cr.shape == (B, 3, Ky, Kx)
    assert _max_err(cr, jr) <= REL * scale
    assert _max_err(ci, ji) <= REL * scale


@pytest.mark.parametrize("name", MODES)
def test_ifft_corner_real_matches_jax(name, mode):
    mode(name)
    rng = np.random.default_rng(12)
    Ky, Kx = _dims()
    keep = rng.random((3, Ky, Kx)) < 0.3
    dr = (rng.normal(size=(B, 3, Ky, Kx)) * 2e4 * keep).astype(np.float32)
    di = (rng.normal(size=(B, 3, Ky, Kx)) * 2e4 * keep).astype(np.float32)
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    t = tcorner.ifft_corner_real(torch.from_numpy(dr), torch.from_numpy(di),
                                 H, W, tabs, tcorner.precision())
    jt = jcorner.ifft_corner_real(jnp.asarray(dr), jnp.asarray(di), H, W,
                                  jcorner.dft_tables_device(H, Ky, W, Kx),
                                  jcorner.precision())
    assert t.shape == (B, 3, H, W)
    assert _max_err(t, jt) <= REL * float(jnp.max(jnp.abs(jt)))


def _round_trip(name, mode, x0=None):
    """(torch stego, JAX stego, {(writer, reader): rows recovered}) under
    one mode."""
    mode(name, x0)
    imgs, secrets = _covers(), _secrets()
    ts = stt.embed_batch(imgs, secrets, master_key=MK, salts=SALTS,
                         layout="nchw", device="cpu").stego
    js = np.array(jbatch.embed_batch(imgs, secrets, master_key=MK,
                                     salts=SALTS, layout="nchw").stego)
    rows = {}
    for writer, stego in (("torch", ts), ("jax", js)):
        got = {"torch": stt.extract_batch(stego, master_key=MK,
                                          clen_hint=SECRET, layout="nchw",
                                          device="cpu"),
               "jax": jbatch.extract_batch(stego, master_key=MK,
                                           clen_hint=SECRET, layout="nchw")}
        for reader, out in got.items():
            rows[writer, reader] = [g == s for g, s in zip(out, secrets)]
    return ts, js, rows


@pytest.mark.parametrize("name", MODES)
def test_round_trip_cross_decodes_with_jax(name, mode):
    """torch embed -> JAX extract and JAX embed -> torch extract at fixed
    salts, stego bytes within +-1 on MAX_DIFF_FRAC of the bytes. bf16 is a
    measurement mode that may lose rows: there each package must recover
    the same rows of either stego."""
    ts, js, rows = _round_trip(name, mode)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= MAX_DIFF_FRAC * diff.size
    if name == "bf16":
        for writer in ("torch", "jax"):
            assert rows[writer, "torch"] == rows[writer, "jax"]
        assert rows["torch", "torch"] == rows["jax", "jax"]
    else:
        assert all(all(r) for r in rows.values()), rows


@pytest.mark.parametrize("name,x0", [("mix_split", 100), ("mix_split", 0),
                                     ("mix_split", 512),
                                     ("mix_adaptive", 100),
                                     ("mix_adaptive", 128)])
def test_split_x0_round_trip_matches_jax(name, x0, mode):
    """STEGANOSAURUS_SPLIT_X0 reaches both packages' band: the stegos agree
    within the byte bound and cross-decode."""
    ts, js, rows = _round_trip(name, mode, x0)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= MAX_DIFF_FRAC * diff.size
    assert all(all(r) for r in rows.values()), rows


@pytest.mark.parametrize("writer,reader", [
    ("mix_split", "mix_adaptive"), ("mix_adaptive", "mix_split"),
    ("mix", "mix_adaptive"), ("mix2", "highest"),
    ("mix_conservative", "mix_split"), ("high", "mix"),
    ("highest", "mix_conservative")])
def test_stego_of_one_mode_extracts_under_another(writer, reader, mode):
    """The read side changes only precision: a stego embedded under one mode
    extracts under another, in the port and in the JAX package."""
    mode(writer)
    imgs, secrets = _covers(31), _secrets(32)
    stego = stt.embed_batch(imgs, secrets, master_key=MK, salts=SALTS,
                            layout="nchw", device="cpu").stego
    mode(reader)
    assert stt.extract_batch(stego, master_key=MK, clen_hint=SECRET,
                             layout="nchw", device="cpu") == secrets
    assert jbatch.extract_batch(stego, master_key=MK, clen_hint=SECRET,
                                layout="nchw") == secrets


# --- forward stage 2's band --------------------------------------------------

def _stage2_inputs(seed=11, P=6):
    """Stage-1 output (P, H, Kx) of seeded image planes and the tables."""
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (P, H, W), dtype=np.uint8))
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    ar, ai = ck.fwd_stage1(imgs, tabs.exr16, tabs.exi16, False)
    return ar, ai, tabs


@pytest.mark.parametrize("x0", [0, 64, 128, 100, 256])
def test_split_fwd_y_band_semantics(x0, monkeypatch):
    """The twin of tests/test_spectral.py's: under mix_split the columns
    below X0 equal the all-high stage exactly and the rest the all-bf16
    stage exactly — a per-column selection between two numerics, never a
    third."""
    monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", str(x0))
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, H, W),
                                         dtype=np.uint8))
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    p = tcorner.resolve("mix_split")
    got = tcorner.fwd_corner(imgs, False, Ky, Kx, tabs, p)
    for fwd2, sl in (("high", slice(0, x0)), ("bf16", slice(x0, None))):
        want = tcorner.fwd_corner(imgs, False, Ky, Kx, tabs,
                                  p._replace(fwd2=fwd2))
        for g, w in zip(got, want):
            assert torch.equal(g[..., sl], w[..., sl])


def test_adaptive_band_edges_are_the_two_stages(monkeypatch):
    """Under mix_adaptive, X0 = 0 is the all-bf16 stage and X0 >= Kx the
    all-high stage, exactly (the JAX package raises at X0 = 0)."""
    ar, ai, tabs = _stage2_inputs()
    for x0, fwd2 in ((0, "bf16"), (256, "high"), (1000, "high")):
        monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", str(x0))
        got = tcorner._fwd_y(ar, ai, tabs, "adaptive")
        want = tcorner._fwd_y(ar, ai, tabs, fwd2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _exact(ar, ai, tabs, bf16=False):
    """The f64 stage-2 product of the f32 tables with the f32 stage 1, or
    (bf16) of their bf16 roundings: the exact sum of the bulk's products."""
    f64 = torch.float64
    t = (tabs.eyr16, tabs.eyi16) if bf16 else (tabs.eyr, tabs.eyi)
    eyr, eyi = (x.to(f64) for x in t)
    if bf16:
        ar, ai = ar.to(torch.bfloat16), ai.to(torch.bfloat16)
    a, b = ar.to(f64), ai.to(f64)
    return eyr @ a - eyi @ b, eyr @ b + eyi @ a


@pytest.mark.parametrize("width", [0, 64, 128, 256, 100])
def test_fwd_stage2_plain_at_any_band_width(width):
    """K2's spec at nb = 0, 1, 2 and Kx/64 groups and at a padded width
    (100 columns, padded to 128 with the last index repeated): the band
    columns within the three-term split's bound of the f64 product on their
    own scale, every other column within REL of the spectrum's scale of the
    exact (f64) sum of its bf16 products; the padding changes no value."""
    ar, ai, tabs = _stage2_inputs()
    P, _, X = ar.shape
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = tcorner.band_topk(energy, width)
    padded = ck.pad_band(idx)
    assert padded.shape == (P, -(-width // 64) * 64)
    if width % 64:
        assert torch.equal(padded[:, :width], idx)
        assert (padded[:, width:] == idx[:, -1:]).all()
    band = ck.stage2_band(ar, ai, padded) if width else None
    cr, ci = ck.fwd_stage2(ar, ai, ar16, ai16, padded, tabs, band)
    tr, ti = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6", (ar16, ai16))
    assert torch.equal(cr, tr) and torch.equal(ci, ti)
    if width:
        assert ck.band_error(cr, ci, ar, ai, idx, tabs) <= ck.SPLIT_REL[
            "bf16x6"]
    er, ei = _exact(ar, ai, tabs, bf16=True)
    scale = max(er.abs().max().item(), ei.abs().max().item())
    bulk = torch.ones((P, 1, X), dtype=torch.bool)
    bulk.scatter_(2, idx[:, None, :], False)
    bulk = bulk.expand(cr.shape)
    assert bool(bulk.any()) == (width < X)
    for c, e in ((cr, er), (ci, ei)):
        d = (c.double() - e)[bulk].abs()
        assert not d.numel() or d.max().item() <= REL * scale


def _route(ar, ai, tabs, X0, adaptive, monkeypatch):
    """_fwd_y_kernels on CPU tensors (each wrapper then takes its plain
    version), with each wrapper's calls recorded: (cr, ci, calls)."""
    calls = []
    for name in ("stage2_prep", "stage2_band", "fwd_stage2"):
        real = getattr(ck, name)

        def rec(*a, _real=real, _name=name):
            calls.append((_name, a))
            return _real(*a)

        monkeypatch.setattr(ck, name, rec)
    cr, ci = tcorner._fwd_y_kernels(ar, ai, tabs, X0, adaptive)
    return cr, ci, calls


@pytest.mark.parametrize("X0,adaptive", [(64, True), (64, False),
                                         (100, True), (100, False),
                                         (0, True), (256, False)])
def test_card_route_of_each_band(X0, adaptive, monkeypatch):
    """What the card runs for each band (corner._fwd_y_kernels): the prep
    wherever there is a bulk, the band pass wherever there is a band, and
    K2 once, on the band padded to 64 nb columns — the top-X0 energy
    columns, the static [0, X0), none (X0 = 0), or every column without
    the bulk (X0 >= Kx, no bf16 copies); its output within the split's
    bound of the CPU path's f32 band (_fwd_y_split)."""
    ar, ai, tabs = _stage2_inputs(P=3)
    P, _, X = ar.shape
    cr, ci, calls = _route(ar, ai, tabs, X0, adaptive, monkeypatch)
    names = [c[0] for c in calls]
    nb = -(-min(X0, X) // 64)
    want = (["stage2_prep"] if X0 < X else []) + (
        ["stage2_band"] if X0 else []) + ["fwd_stage2"]
    assert names == want
    args = calls[-1][1]
    idx = args[4]
    assert idx.shape == (P, 64 * nb) and idx.dtype == torch.int64
    assert (args[2] is None) == (X0 >= X) == (args[3] is None)
    assert (args[6] is None) == (X0 == 0)
    if X0 and not adaptive:
        want_idx = torch.arange(min(X0, X)).expand(P, -1)
        assert torch.equal(ck.pad_band(want_idx.contiguous()), idx)
    elif X0:
        energy = ck.stage2_prep_plain(ar, ai)[2]
        assert torch.equal(
            idx, ck.pad_band(tcorner.band_topk(energy, min(X0, X))))
    if X0 >= X:
        assert ck.band_error(cr, ci, ar, ai, idx, tabs) <= ck.SPLIT_REL[
            "bf16x6"]
    ref = tcorner._fwd_y_split(ar, ai, tabs, X0, adaptive)
    er, ei = _exact(ar, ai, tabs)
    scale = max(er.abs().max().item(), ei.abs().max().item())
    assert _max_err(cr, ref[0]) <= REL * scale
    assert _max_err(ci, ref[1]) <= REL * scale


# (K1 with the prep, the prep's reduce, the prep pass, band pass, K2) of one
# forward DFT on the card's route, by the precision of its stages
PREP_ROUTES = {
    "mix_adaptive": (1, 1, 0, 1, 1), "mix_split": (1, 0, 0, 1, 1),
    "mix": (0, 0, 0, 1, 1), "mix3": (0, 0, 0, 1, 1), "mix2": (0, 0, 0, 1, 1),
    "mix_conservative": (0, 0, 0, 1, 1), "bf16": (1, 0, 0, 0, 1),
    "high": (0, 0, 0, 1, 1), "highest": (0, 0, 0, 0, 0),
    # an f32 stage 1 before a band picked by energy: the prep pass
    "high stage 1, adaptive": (0, 0, 1, 1, 1)}


@pytest.mark.parametrize("route", list(PREP_ROUTES))
def test_k1_prep_routes_of_each_mode(route, monkeypatch):
    """Which modes take K1's prep, which the prep pass and which neither:
    fwd_corner on the card's route (corner._on_card made true, so CPU
    tensors take each wrapper's plain version), each wrapper counted into
    LAUNCHES as the card counts it. K1 writes the bf16 copies wherever
    stage 2 has a bulk and the energies too where they pick the band
    (corner.stage1_prep); the prep pass runs only after an f32 stage 1;
    neither where the band holds every column or stage 2 runs in f32. The
    spectrum equals that of the same route with the prep pass."""
    name, fwd2 = route, None
    if route == "high stage 1, adaptive":
        name, fwd2 = "mix_adaptive", "adaptive"
    p = tcorner.resolve(name)
    if fwd2:
        p = p._replace(stage1="high")
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.LAUNCHES, 0))

    def count(fn, key):
        def f(*a, **kw):
            ck.LAUNCHES[key] += 1
            return fn(*a, **kw)
        return f

    real_k1, real_y = ck.fwd_stage1, tcorner._fwd_y_kernels

    def k1(x, exr, exi, center, tables=None, prep=None):
        ck.LAUNCHES[ck.route_for(x.shape[-1], x.data_ptr())] += 1
        ck.LAUNCHES[ck.KERNEL_K1_PREP] += prep is not None
        return real_k1(x, exr, exi, center, tables, prep)

    monkeypatch.setattr(ck, "fwd_stage1", k1)
    for fn, key in (("stage2_prep", ck.KERNEL_PREP),
                    ("prep_reduce", ck.KERNEL_PREP_REDUCE),
                    ("stage2_band", ck.KERNEL_BAND),
                    ("fwd_stage2", ck.KERNEL_STAGE2)):
        monkeypatch.setattr(ck, fn, count(getattr(ck, fn), key))
    monkeypatch.setattr(tcorner, "_on_card", lambda t: True)
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    imgs = torch.from_numpy(_covers(23))
    got = tcorner.fwd_corner(imgs, True, Ky, Kx, tabs, p)
    k1 = int(p.stage1 == "bf16")
    k1_prep, reduce, prep, band, k2 = PREP_ROUTES[route]
    assert ck.LAUNCHES == {ck.KERNEL_TMA: k1, ck.KERNEL_LDG: 0,
                           ck.KERNEL_K1_PREP: k1_prep, ck.KERNEL_PREP: prep,
                           ck.KERNEL_PREP_REDUCE: reduce,
                           ck.KERNEL_BAND: band, ck.KERNEL_STAGE2: k2}
    if k1:
        assert (tcorner.stage1_prep(p.fwd2, Kx) is not None) == bool(k1_prep)
    if not k1_prep:
        return
    monkeypatch.setattr(tcorner, "_fwd_y_kernels",
                        lambda *a, prep=None: real_y(*a))
    want = tcorner.fwd_corner(imgs, True, Ky, Kx, tabs, p)
    assert ck.LAUNCHES[ck.KERNEL_PREP] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the embed's inverse per mode --------------------------------------------

@pytest.mark.parametrize("name", MODES)
def test_embed_core_routes_each_stage(name, mode, monkeypatch):
    """corner_embed_core under each mode: K1 where stage 1 is bf16 (else
    the f32 product), K3's bf16 operands where the inverse's y-stage is
    bf16, the y-stage through K6's wrapper in bf16 or the f32 chain, and
    the x-stage through K4's wrapper (bf16) or the f32 product and K4e."""
    mode(name)
    p = tcorner.precision()
    calls = []

    def rec(obj, attr, tag):
        real = getattr(obj, attr)

        def f(*a, **kw):
            calls.append(tag(a, kw))
            return real(*a, **kw)

        monkeypatch.setattr(obj, attr, f)

    rec(ck, "fwd_stage1", lambda a, kw: "K1")
    rec(wk, "write_floor",
        lambda a, kw: ("K3", kw.get("ifft_operands", False)))
    rec(wk, "ifft_y", lambda a, kw: "K6")
    rec(tcorner, "_ifft_y", lambda a, kw: ("y chain", a[3]))
    rec(wk, "ifft_epilogue", lambda a, kw: ("K4", a[0].dtype))
    rec(wk, "epilogue", lambda a, kw: "K4e")
    rng = np.random.default_rng(5)
    h, w, n = 128, 192, 1024
    Ky, Kx = tcorner.corner_dims(h, w, Params().rmax)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 3, h, w),
                                         dtype=np.uint8))
    flat = rng.choice(3 * Ky * Kx, n, replace=False)
    pos = [torch.from_numpy(a) for a in np.unravel_index(flat, (3, Ky, Kx))]
    maps = tpb.corner_statics_core(*pos, Ky, Kx, n)
    frame = torch.from_numpy(rng.integers(0, 2, (B, n), dtype=np.uint8))
    out = tpb.corner_embed_core(imgs, frame, maps, 0.5, Ky=Ky, Kx=Kx,
                                center=True, layout="nchw", floor=0.45)
    assert out.shape == imgs.shape and out.dtype == torch.uint8
    want = (["K1"] if p.stage1 == "bf16" else []) + [
        ("K3", p.inv_y == "bf16")]
    if p.inv_y == "bf16":   # K6's plain version runs the bf16 chain inside
        want += ["K6", ("y chain", "mix_adaptive")]
    else:
        want += [("y chain", p.inv_y)]
    want += [("K4", torch.bfloat16)] if p.inv_x == "bf16" else ["K4e"]
    assert calls == want


def test_default_mode_keeps_the_parent_numerics(mode):
    """mix_adaptive with SPLIT_X0 unset and set to 64 gives one stego, and
    forward stage 2 on the CPU is _fwd_y_split's f32 band of 64 columns."""
    imgs, secrets = _covers(41), _secrets(42)
    outs = []
    for x0 in (None, 64):
        mode("mix_adaptive", x0)
        outs.append(stt.embed_batch(imgs, secrets, master_key=MK,
                                    salts=SALTS, layout="nchw",
                                    device="cpu").stego)
    assert np.array_equal(*outs)
    ar, ai, tabs = _stage2_inputs(P=3)
    got = tcorner._fwd_y(ar, ai, tabs, "adaptive")
    want = tcorner._fwd_y_split(ar, ai, tabs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_jax_params_are_the_ports():
    """The round trips above pass no Params: both packages' defaults."""
    assert dataclasses.asdict(Params()) == dataclasses.asdict(JParams())


def test_band_ber_tool_takes_modes(monkeypatch):
    """tools/band_ber_torch.py --mode NAME (more than once): the names are
    parsed apart from OUT, an unknown name raises before any work, and
    without a card the tool refuses (exit 2)."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "band_ber_torch.py")
    spec = importlib.util.spec_from_file_location(path.stem, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool._args(["--mode", "mix", "out.txt", "--mode", "high"]) == (
        ["mix", "high"], ["out.txt"])
    with pytest.raises(ValueError, match="mixx"):
        tool.main(["--mode", "mixx"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--mode", "mix_split"]) == 2
