"""The port's corner wire modes against the JAX package: soft write, alpha
spread, dithered phase QIM, the RS payload, length padding and their
composition in Params.stealth() (per-image walks: tests/test_torch_piw.py).

- The keyed per-slot arrays (spread amplitudes, QIM dithers) are bit-equal.
- The dense write and read rules agree with the JAX functions on the same
  random corners to WRITE_TOL of the corner's scale (the two libraries
  round sqrt/atan2/cos and contract multiply-adds in other places, a few
  f32 ulps); the QIM write may also pick the other centroid of the same
  coset where the lattice coordinate sits on a half-step, and such bins
  are counted and bounded.
- The static maps equal JAX's.
- Every mode cross-decodes both ways with recovery 1.0 at 384x640, B=4,
  256 B; with fixed salts the stego bytes differ from JAX's by +-1 on at
  most MAX_DIFF_FRAC of the bytes (measured on the CPU: 0.01-0.05%). Under
  QIM one payload bin whose lattice coordinate sits on a half-step in one
  package can take the other centroid of its coset (the decoded bit is
  the same): its image-plane then moves by a low-frequency ripple, and
  ~4% of that plane's bytes differ by 1 (measured: one such plane of 12
  at this size). Such planes are counted and bounded.
- Extraction reads each image's mode from its header: a batch mixing
  every mode reads back in one call, a JAX coherent stego among them too
  (through the port's single-image extract_array).
- channel_report (RS, QIM) agrees with JAX's, and the soft retry pass
  recovers RS images through its per-coded-byte confidences.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from steganosaurus_tpu import crypto
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.pipeline import qim as jqim
from steganosaurus_tpu.pipeline import spread as jspread
from steganosaurus_tpu.spectral import corner as jcorner
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.parallel import batch as tpb
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.pipeline import qim as tqim
from steganosaurus_tpu_torch.pipeline import spread as tspread
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

MK = bytes(range(32))
H, W, B, SECRET = 384, 640, 4, 256
SALTS = [bytes([i + 90]) * 16 for i in range(B)]
MAX_DIFF_FRAC = 1e-3
RIPPLE_FRAC = 0.01    # a plane with more differing bytes took a half-step
MAX_RIPPLE_PLANES = 1
WRITE_TOL = 2e-6      # of max |C|, for the write deltas
VALUE_TOL = 4e-6      # of max |C|, for the decision values
RAW_TOL = 2e-4
FAST = dict(pbkdf2_iter=500)

MODES = {
    "soft_write": Params(soft_write=True, **FAST),
    "alpha_spread": Params(alpha_spread=0.5, **FAST),
    "qim": Params(qim=3, **FAST),
    "rs": Params(rs=True, **FAST),
    "pad_quantum": Params(pad_quantum=384, **FAST),
    "stealth": Params.stealth(**FAST),
    "stealth_shared": Params.stealth(per_image_walk=False, **FAST),
}


# --- keyed per-slot arrays --------------------------------------------------

@pytest.mark.parametrize("spread,alpha,nbits", [(1.0, 0.5, 9000),
                                                (0.5, 0.3, 4096),
                                                (0.0, 0.5, 100)])
def test_spread_alphas_bit_equal(spread, alpha, nbits):
    p = Params(alpha=alpha, alpha_spread=spread)
    pk = crypto.derive_path_key(None, MK)
    got = tspread.spread_alphas(pk, p, nbits)
    want = jspread.spread_alphas(pk, jp(p), nbits)
    if spread == 0.0:
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= alpha and got.max() < alpha * (1 + spread)


@pytest.mark.parametrize("L", [2, 3, 15])
def test_dither_angles_bit_equal(L):
    pk = crypto.derive_path_key("pw", None)
    got = tqim.dither_angles(pk, L, 5000)
    np.testing.assert_array_equal(got, jqim.dither_angles(pk, L, 5000))
    assert got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() < 2 * math.pi / L


@pytest.mark.parametrize("p,mods", [
    (Params(alpha_spread=-0.1), (tspread, jspread)),
    (Params(alpha=2.0, alpha_spread=1.0), (tspread, jspread)),
    (Params(qim=1), (tqim, jqim)), (Params(qim=16), (tqim, jqim))])
def test_invalid_modes_raise_like_jax(p, mods):
    port, jax_mod = mods
    with pytest.raises(stt.StegoError):
        port.validate(p)
    with pytest.raises(Exception, match="alpha_spread|qim"):
        jax_mod.validate(jp(p))


# --- dense write and read rules ----------------------------------------------

def _corners(seed=0, B_=2, K=96):
    rng = np.random.default_rng(seed)
    f = np.float32
    cr = (rng.normal(size=(B_, 3, K, K)) * 1e4).astype(f)
    ci = (rng.normal(size=(B_, 3, K, K)) * 1e4).astype(f)
    sign = (rng.integers(0, 2, (B_, 3, K, K)) * 2 - 1).astype(f)
    mask = (rng.random((3, K, K)) < 0.5).astype(f)
    qm = (mask * (rng.random((3, K, K)) < 0.7)).astype(f)
    jd = rng.uniform(-0.4, 0.4, (3, K, K)).astype(f)
    al = rng.uniform(0.5, 1.0, (3, K, K)).astype(f)
    dq = rng.uniform(0, 2 * math.pi / 3, (3, K, K)).astype(f)
    return dict(cr=cr, ci=ci, sign=sign, mask=mask, qm=qm,
                cjd=np.cos(jd), sjd=np.sin(jd), cad=np.cos(al),
                sad=np.sin(al), dq=dq)


def _args(c, jitter, spread):
    if spread:
        ca, sa = c["cad"], c["sad"]
    else:
        ca, sa = np.float32(math.cos(0.5)), np.float32(math.sin(0.5))
    jit = (c["cjd"], c["sjd"]) if jitter else (None, None)
    return ca, sa, jit


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _half_step(c, L=3):
    """Payload bins whose lattice coordinate q of write_delta_qim lies
    within 1e-4 of a half-step, computed in f64, for either bit."""
    theta = np.arctan2(c["ci"].astype(np.float64), c["cr"].astype(np.float64))
    delta = 2 * math.pi / L
    q = (theta - c["dq"]) / delta - (c["sign"] + 1.0) * 0.25
    return (np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-4) & (c["qm"] > 0)


@pytest.mark.parametrize("soft,jitter,spread",
                         list(itertools.product([False, True], repeat=3)))
def test_write_rules_match_jax(soft, jitter, spread):
    """write_delta (hard and soft) and write_delta_qim against JAX's with
    scalar or per-bin amplitudes and with or without jitter maps. The soft
    write's exact zeros (bins left untouched) coincide."""
    c = _corners()
    ca, sa, (cjd, sjd) = _args(c, jitter, spread)
    scale = max(np.abs(c["cr"]).max(), np.abs(c["ci"]).max())
    j = jcorner.write_delta(*(_j(c[k]) for k in ("cr", "ci", "sign",
                                                 "mask")),
                            _j(ca), _j(sa), _j(cjd), _j(sjd), soft=soft)
    t = tcorner.write_delta(*(_t(c[k]) for k in ("cr", "ci", "sign",
                                                 "mask")),
                            _t(ca), _t(sa), _t(cjd), _t(sjd), soft=soft)
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.numpy()
        assert np.abs(a - b).max() <= WRITE_TOL * scale
        assert np.mean((a == 0) != (b == 0)) <= 1e-4
    if soft:  # the soft write leaves some walk bins exactly untouched
        assert ((t[0].numpy() == 0) & (c["mask"] > 0)).any()
    jq = jcorner.write_delta_qim(*(_j(c[k]) for k in ("cr", "ci", "sign",
                                                      "mask", "qm")),
                                 _j(ca), _j(sa), _j(c["dq"]), 3, _j(cjd),
                                 _j(sjd), soft=soft)
    tq = tcorner.write_delta_qim(*(_t(c[k]) for k in ("cr", "ci", "sign",
                                                      "mask", "qm")),
                                 _t(ca), _t(sa), _t(c["dq"]), 3, _t(cjd),
                                 _t(sjd), soft=soft)
    half = _half_step(c)
    off = np.zeros(half.shape, bool)
    for a, b in zip(jq, tq):
        off |= np.abs(np.asarray(a) - b.numpy()) > WRITE_TOL * scale
    # a different centroid only where q sits on a half-step
    assert not (off & ~half).any(), int((off & ~half).sum())
    assert half.sum() <= 1e-3 * (c["qm"] > 0).sum() * c["cr"].shape[0]


@pytest.mark.parametrize("jitter", [False, True])
def test_qim_read_rules_match_jax(jitter):
    c = _corners(seed=3)
    _, _, (cjd, sjd) = _args(c, jitter, False)
    scale = max(np.abs(c["cr"]).max(), np.abs(c["ci"]).max())
    for ssa in (1.0, -1.0):
        args = ("cr", "ci")
        j = jcorner.decision_values_dense_qim(
            *(_j(c[k]) for k in args), ssa, _j(c["qm"]), _j(c["dq"]), 3,
            _j(cjd), _j(sjd))
        t = tcorner.decision_values_dense_qim(
            *(_t(c[k]) for k in args), ssa, _t(c["qm"]), _t(c["dq"]), 3,
            _t(cjd), _t(sjd))
        j, t = np.asarray(j), t.numpy()
        assert np.abs(j - t).max() <= VALUE_TOL * scale
        near = np.abs(j) <= VALUE_TOL * scale
        assert ((j >= 0) == (t >= 0))[~near].all()
        jb = np.asarray(jcorner.read_bits_dense_qim(
            *(_j(c[k]) for k in args), ssa, _j(c["qm"]), _j(c["dq"]), 3,
            _j(cjd), _j(sjd)))
        tb = tcorner.read_bits_dense_qim(
            *(_t(c[k]) for k in args), ssa, _t(c["qm"]), _t(c["dq"]), 3,
            _t(cjd), _t(sjd)).numpy()
        assert (jb == tb)[~near].all()
        assert ((tb == 1) == (t >= 0)).all()


def test_statics_maps_match_jax():
    """Under jitter, spread and QIM the static maps are (pos, cjd, sjd,
    cad, sad, dq, qm), equal to JAX's: integer and dither/mask maps
    exactly, the cos/sin maps to f32 rounding; the QIM map set follows
    Params.qim."""
    PH, PW = 384, 640
    Ky, Kx = tcorner.corner_dims(PH, PW, Params().rmax)
    nbits = 912 + (64 + 16) * 56
    bucket = -(-nbits // 4096) * 4096
    for L in (3, 5):
        params = Params(jitter=0.2, alpha_spread=0.7, qim=L)
        jmaps, jn = jbatch._corner_statics_device(
            None, MK, jp(params), PH, PW, nbits, bucket, Ky, Kx, None)
        maps, n = tbatch._corner_statics_device(
            None, MK, params, PH, PW, nbits, bucket, Ky, Kx,
            torch.device("cpu"))
        assert n == jn and len(maps) == len(jmaps) == 7
        want = tpb.statics_from_numpy([np.asarray(m) for m in jmaps], "cpu")
        for k, (got, ref) in enumerate(zip(maps, want)):
            exact = k in (0, 5, 6)
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=0 if exact else 1e-6)
        assert (maps[6] > 0).any() and (maps[6] == 0).any()
    # without spread and QIM: pos alone, as before
    (pos,), _ = tbatch._corner_statics_device(
        None, MK, Params(), PH, PW, nbits, bucket, Ky, Kx,
        torch.device("cpu"))
    torch.testing.assert_close(pos, maps[0], rtol=0, atol=0)


# --- round trips per mode ----------------------------------------------------

def _covers(n=B, h=H, w=W, seed=21):
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 235, w)
    return np.clip(base[None, None, :, None]
                   + rng.integers(-18, 19, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


def _secrets(n=B, size=SECRET, seed=5):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size - 3 * i, dtype=np.uint8))
            for i in range(n)]


_CACHE: dict = {}


def _stegos(mode):
    """(covers, secrets, torch stego, JAX stego) for one mode, made once."""
    if mode not in _CACHE:
        p = MODES[mode]
        covers, secrets = _covers(), _secrets()
        ts = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                             salts=SALTS, device="cpu").stego
        js = np.array(jbatch.embed_batch(covers, secrets, master_key=MK,
                                         params=jp(p), salts=SALTS).stego)
        _CACHE[mode] = (covers, secrets, ts, js)
    return _CACHE[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_torch_embed_jax_extract(mode):
    _, secrets, ts, _ = _stegos(mode)
    assert jbatch.extract_batch(ts, master_key=MK,
                                params=jp(MODES[mode])) == secrets


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_jax_embed_torch_extract(mode):
    """Hinted (the Params' own mode in the fused pass) and unhinted reads
    of the JAX package's stegos, and of the port's own."""
    _, secrets, ts, js = _stegos(mode)
    p = MODES[mode]
    hint = tbatch._wire_clen(max(len(s) for s in secrets), p)
    for stego in (js, ts):
        assert stt.extract_batch(stego, master_key=MK, params=p,
                                 device="cpu") == secrets
        assert stt.extract_batch(stego, master_key=MK, params=p,
                                 clen_hint=hint, device="cpu") == secrets


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_stego_bytes_match_jax(mode):
    """+-1 only; outside the planes a QIM half-step moved (none without
    QIM), at most MAX_DIFF_FRAC of the bytes differ."""
    _, _, ts, js = _stegos(mode)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    per_plane = np.mean(diff != 0, axis=(1, 2))              # (B, 3)
    ripple = per_plane > RIPPLE_FRAC
    assert ripple.sum() <= (MAX_RIPPLE_PLANES if MODES[mode].qim else 0), \
        per_plane
    n = int(np.count_nonzero(diff.transpose(0, 3, 1, 2)[~ripple]))
    assert n <= MAX_DIFF_FRAC * diff.size, (n, diff.size)


def test_written_bits_match_jax():
    """Frame lengths by FEC and padding: RS codes 255/223 of ct||tag,
    padding rounds clen up to the quantum."""
    covers, secrets = _covers(n=2), _secrets(n=2)
    for p in (MODES["rs"], MODES["pad_quantum"],
              Params(rs=True, pad_quantum=100, **FAST)):
        t = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                            salts=SALTS[:2], device="cpu")
        j = jbatch.embed_batch(covers, secrets, master_key=MK, params=jp(p),
                               salts=SALTS[:2])
        assert t.written_bits == j.written_bits


def test_mixed_mode_batch_in_one_call():
    """One image per jitter-0 mode, plus the default, each embedded alone
    by the port and by the JAX package: the port reads each stack in a
    single extract_batch call with default Params (no hint, then a hint
    sized for the default mode), as does the JAX package."""
    names = ["default", "soft_write", "alpha_spread", "qim", "rs",
             "pad_quantum", "rs_qim"]
    extra = {"default": Params(**FAST),
             "rs_qim": Params(rs=True, qim=4, pad_quantum=100, **FAST)}
    covers = _covers(n=len(names), seed=9)
    secrets = _secrets(n=len(names), size=200, seed=9)
    rows = {"torch": [], "jax": []}
    for i, name in enumerate(names):
        p = extra.get(name) or MODES[name]
        args = (covers[i:i + 1], secrets[i:i + 1])
        kw = dict(master_key=MK, params=p, salts=[bytes([i + 7]) * 16])
        rows["torch"].append(stt.embed_batch(*args, device="cpu", **kw)
                             .stego[0])
        rows["jax"].append(np.asarray(jbatch.embed_batch(*args, **kw)
                                      .stego)[0])
    for who, r in rows.items():
        stack = np.stack(r)
        assert stt.extract_batch(stack, master_key=MK, params=Params(**FAST),
                                 device="cpu") == secrets, who
        assert stt.extract_batch(stack, master_key=MK, params=Params(**FAST),
                                 clen_hint=200, device="cpu") == secrets, who
        assert jbatch.extract_batch(stack, master_key=MK,
                                    params=jp(Params(**FAST))) == secrets, who


def test_coherent_stego_reads_as_none():
    """A JAX coherent stego (single-image embed_array: the mode's header
    rides the coherent write, and FLAG_COHERENT marks it) among two
    shared-walk stegos: both packages read all three — their batch
    extracts hand the row, whose header fails both batch parses, to their
    single-image extract_array — so no row reads as None any more."""
    from steganosaurus_tpu.pipeline.embed import embed_array

    covers = _covers(n=3, h=256, w=256, seed=13)
    secrets = [b"plain-row", b"coherent-row", b"qim-row"]
    p = Params(**FAST)
    coh = np.asarray(embed_array(covers[1], secrets[1], master_key=MK,
                                 params=jp(Params(coherent=True, **FAST)),
                                 salt=bytes(16)).stego)
    plain = stt.embed_batch(covers[0:1], secrets[:1], master_key=MK,
                            params=p, device="cpu").stego[0]
    qim = stt.embed_batch(covers[2:3], secrets[2:], master_key=MK,
                          params=MODES["qim"], device="cpu").stego[0]
    stack = np.stack([plain, coh, qim])
    assert jbatch.extract_batch(stack, master_key=MK, params=jp(p)) == secrets
    assert stt.extract_batch(stack, master_key=MK, params=p,
                             device="cpu") == secrets


@pytest.mark.parametrize("mode", ["rs", "qim"])
def test_channel_report_modes_match_jax(mode):
    """channel_report under the RS payload (post-ECC BER through the RS
    decode) and under QIM (payload raw bits by the QIM rule) on the JAX
    package's stego: post-ECC equal (0), raw BER within RAW_TOL."""
    _, secrets, ts, js = _stegos(mode)
    p = MODES[mode]
    for stego in (js, ts):
        mine = stt.channel_report(stego, secrets, SALTS, master_key=MK,
                                  params=p, per_image=True, device="cpu")
        ref = jbatch.channel_report(stego, secrets, SALTS, master_key=MK,
                                    params=jp(p), per_image=True)
        assert set(mine) == set(ref)
        for k in ("header_ber_post_ecc", "payload_ber_post_ecc"):
            assert mine[k] == ref[k] == 0.0
        for k in ("header_ber_raw", "payload_ber_raw"):
            assert abs(mine[k] - ref[k]) <= RAW_TOL, (k, mine[k], ref[k])
    # read as another mode, the payload no longer decodes
    other = Params(**FAST) if mode == "qim" else Params(qim=3, **FAST)
    bad = stt.channel_report(ts, secrets, SALTS, master_key=MK,
                             params=other, device="cpu")
    assert bad["payload_ber_raw"] > 0.1


# --- the RS soft retry -------------------------------------------------------

def _rs_margin():
    """tests/test_rs_pipeline.py's RS margin workload: one 256x256
    full-range noise cover, 1200 B secrets, B=8, where the hard RS decode
    loses some images."""
    if "rs_margin" not in _CACHE:
        rng = np.random.default_rng(1)
        cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
        secret = bytes(rng.integers(0, 256, 1200, dtype=np.uint8))
        n = 8
        st = stt.embed_batch(np.stack([cover] * n), [secret] * n,
                             master_key=MK,
                             params=Params(rs=True,
                                           soft_decode_fallback=False),
                             salts=[bytes([i]) * 16 for i in range(n)],
                             device="cpu").stego
        _CACHE["rs_margin"] = (st, secret)
    return _CACHE["rs_margin"]


@pytest.mark.parametrize("inline", [True, False])
def test_rs_soft_recovers_through_confidences(monkeypatch, inline):
    """Only the inline soft rows (retry pass off), or only the retry pass
    (inline rows dropped): either recovers an RS image the hard decode
    loses, through the errors-and-erasures decode of its per-coded-byte
    confidences; only true secrets come back."""
    from steganosaurus_tpu_torch.ops import rs as rs_mod

    stego, secret = _rs_margin()
    hard = stt.extract_batch(stego, master_key=MK,
                             params=Params(rs=True,
                                           soft_decode_fallback=False),
                             device="cpu")
    n_hard = sum(g is None for g in hard)
    assert n_hard > 0, "the RS margin workload no longer fails hard"
    calls = []
    real_soft = rs_mod.rs_decode_interleaved_soft
    monkeypatch.setattr(rs_mod, "rs_decode_interleaved_soft",
                        lambda *a: calls.append(1) or real_soft(*a))
    if inline:
        monkeypatch.setattr(tbatch._ExtractJob, "_soft_retry_failed",
                            lambda self, headers, out: None)
    else:
        real = tbatch._ExtractJob._dispatch_pass

        def no_inline(self, *a, **kw):
            return real(self, *a, **kw)[0], None, None

        monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_pass", no_inline)
    got = stt.extract_batch(stego, master_key=MK, params=Params(rs=True),
                            device="cpu")
    assert sum(g is None for g in got) < n_hard
    assert calls
    for h, g in zip(hard, got):
        assert g is None or g == secret
        if h is not None:
            assert g == h


# --- the composition lattice (tests/test_wire_matrix.py) --------------------

AXES = {
    "per_image_walk": (False, True),
    "rs": (False, True),
    "qim": (0, 3),
    "pad_quantum": (0, 24),
    "alpha_spread": (0.0, 0.5),
    "soft_write": (False, True),
    "write_floor": (0.0, 0.45),
}
COMBOS = [dict(zip(AXES, vals)) for vals in itertools.product(*AXES.values())]


def test_full_wire_lattice():
    """All 128 compositions of tests/test_wire_matrix.py, each embedded
    alone by the port (one 128x128 noise cover, a short secret), then the
    whole stack read in ONE port extract_batch call — grouping, dispatch
    and decode must be right for every mode pair at once — and by the JAX
    package."""
    rng = np.random.default_rng(23)
    cover = rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    stegos, secrets = [], []
    for i, combo in enumerate(COMBOS):
        p = Params(pbkdf2_iter=100, **combo)
        secret = f"c{i:03d}".encode()
        stegos.append(stt.embed_batch(cover, [secret], password="pw",
                                      params=p, device="cpu").stego[0])
        secrets.append(secret)
    stack = np.stack(stegos)
    p = Params(pbkdf2_iter=100)
    got = stt.extract_batch(stack, password="pw", params=p, device="cpu")
    bad = [i for i, (g, s) in enumerate(zip(got, secrets)) if g != s]
    assert not bad, [COMBOS[i] for i in bad[:4]]
    assert jbatch.extract_batch(stack, password="pw", params=jp(p)) == secrets
