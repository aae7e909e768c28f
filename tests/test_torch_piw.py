"""The port's per-image walks (Params.per_image_walk) against the JAX
package: the walk arrays, embed and extract alone and composed with the
other wire modes, mixed batches, the walk prefetch and its stream, and the
soft retry's per-image group.

384x640 covers, B=4, 256 B secrets, fixed salts, on the CPU (the kernel
wrappers take their plain versions). Stegos cross-decode both ways with
recovery 1.0, and stego bytes differ from JAX's by +-1 on at most
MAX_DIFF_FRAC of the bytes, outside at most one image-plane a QIM
half-step moved (tests/test_torch_wire.py has the mechanism)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.pipeline import stream as tstream
from steganosaurus_tpu_torch import keystream
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

MK = bytes(range(32))
H, W, B, SECRET = 384, 640, 4, 256
SALTS = [bytes([i + 40]) * 16 for i in range(B)]
MAX_DIFF_FRAC = 1e-3
RIPPLE_FRAC = 0.01
FAST = dict(pbkdf2_iter=500, per_image_walk=True)

MODES = {
    "piw": Params(**FAST),
    "piw_jitter_soft": Params(jitter=0.3, soft_write=True, **FAST),
    "piw_spread": Params(alpha_spread=0.8, **FAST),
    "piw_qim": Params(qim=4, **FAST),
    "piw_rs": Params(rs=True, **FAST),
    "piw_rs_qim_pad": Params(rs=True, qim=3, pad_quantum=100,
                             alpha_spread=0.5, **FAST),
}


def _covers(n=B, h=H, w=W, seed=27):
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 235, w)
    return np.clip(base[None, None, :, None]
                   + rng.integers(-18, 19, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


def _secrets(n=B, size=SECRET, seed=6):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size - 5 * i, dtype=np.uint8))
            for i in range(n)]


@pytest.mark.parametrize("strict", [True, False])
def test_piw_walk_arrays_match_jax(strict):
    """Equal (plane, y, x, jitter) rows: the shared header prefix, each
    salt's payload walk, the tail pad. A need past the walk's capacity
    raises in both packages when strict, and pads the same way when not."""
    p = Params(jitter=0.2)
    PH, PW = 128, 128
    salts = [bytes([i]) * 16 for i in range(3)]
    needs = [912 + 700, 912 + 2000, 912 + 40]
    bucket = 4096
    if not strict:
        needs[1] = 912 + 30000   # beyond a 128x128 walk's capacity
        bucket = 32768
    got = tbatch._piw_walk_arrays(None, MK, p, PH, PW, salts, needs, bucket,
                                  strict=strict)
    want = jbatch._piw_walk_arrays(None, MK, p, PH, PW, salts, needs, bucket,
                                   strict=strict)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (3, bucket)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[1][0], got[1][2])  # walks differ by salt
    np.testing.assert_array_equal(got[0][:, :912], got[0][[0], :912]
                                  .repeat(3, 0))   # one header prefix
    if strict:
        needs[1] = 912 + 30000
        with pytest.raises(stt.StegoError, match="exhausted"):
            tbatch._piw_walk_arrays(None, MK, p, PH, PW, salts, needs,
                                    32768)


_CACHE: dict = {}


def _stegos(mode):
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
def test_piw_torch_embed_jax_extract(mode):
    _, secrets, ts, _ = _stegos(mode)
    assert jbatch.extract_batch(ts, master_key=MK,
                                params=jp(MODES[mode])) == secrets


@pytest.mark.parametrize("mode", list(MODES))
def test_piw_jax_embed_torch_extract(mode):
    _, secrets, ts, js = _stegos(mode)
    p = MODES[mode]
    for stego in (js, ts):
        assert stt.extract_batch(stego, master_key=MK, params=p,
                                 device="cpu") == secrets
        assert stt.extract_batch(
            stego, master_key=MK, params=p, device="cpu",
            clen_hint=tbatch._wire_clen(SECRET, p)) == secrets


@pytest.mark.parametrize("mode", list(MODES))
def test_piw_stego_bytes_match_jax(mode):
    _, _, ts, js = _stegos(mode)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    per_plane = np.mean(diff != 0, axis=(1, 2))
    ripple = per_plane > RIPPLE_FRAC
    assert ripple.sum() <= (1 if MODES[mode].qim else 0), per_plane
    n = int(np.count_nonzero(diff.transpose(0, 3, 1, 2)[~ripple]))
    assert n <= MAX_DIFF_FRAC * diff.size, (n, diff.size)


def test_piw_payloads_differ_per_image_and_nchw_device_resident():
    """Same secret and cover on every row: the per-image walks put the
    payload on other bins per salt, so the stego rows differ beyond the
    header; nchw in, a tensor out, and it reads back."""
    covers = _covers(n=2)
    covers[1] = covers[0]
    nchw = torch.from_numpy(np.ascontiguousarray(covers.transpose(0, 3, 1,
                                                                  2)))
    p = MODES["piw"]
    res = stt.embed_batch(nchw, [b"same secret"] * 2, master_key=MK,
                          params=p, salts=SALTS[:2], device_resident=True,
                          layout="nchw")
    assert isinstance(res.stego, torch.Tensor)
    assert res.stego.shape == nchw.shape
    assert not torch.equal(res.stego[0], res.stego[1])
    assert stt.extract_batch(res.stego, master_key=MK, params=p,
                             layout="nchw") == [b"same secret"] * 2


def test_mixed_shared_and_piw_batch():
    """Shared-walk and per-image-walk stegos (of several modes) in one
    stack, read by one port call under default Params, and by JAX."""
    covers = _covers(n=4, seed=31)
    secrets = _secrets(n=4, size=120, seed=31)
    modes = [Params(pbkdf2_iter=500), MODES["piw"], MODES["piw_qim"],
             Params(qim=4, rs=True, pbkdf2_iter=500)]
    rows = []
    for i, p in enumerate(modes):
        rows.append(stt.embed_batch(covers[i:i + 1], secrets[i:i + 1],
                                    master_key=MK, params=p,
                                    salts=[bytes([i + 3]) * 16],
                                    device="cpu").stego[0])
    stack = np.stack(rows)
    p0 = Params(pbkdf2_iter=500)
    assert stt.extract_batch(stack, master_key=MK, params=p0,
                             device="cpu") == secrets
    assert stt.extract_batch(stack, master_key=MK, params=MODES["piw"],
                             clen_hint=120, device="cpu") == secrets
    assert jbatch.extract_batch(stack, master_key=MK, params=jp(p0)) == secrets


def test_piw_verify_resalts(monkeypatch):
    """verify=True on per-image walks: a failure forced on the first
    read-back is re-embedded under a fresh salt (a fresh payload walk)."""
    covers = _covers(n=3, h=128, w=128)
    secrets = [b"v0", b"v1", b"v2"]
    p = Params(pbkdf2_iter=500, per_image_walk=True, qim=3)
    real = tbatch.extract_batch
    calls = {"n": 0}

    def flaky(*a, **kw):
        out = list(real(*a, **kw))
        calls["n"] += 1
        if calls["n"] == 1:
            out[2] = None
        return out

    monkeypatch.setattr(tbatch, "extract_batch", flaky)
    res = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                          salts=SALTS[:3], verify=True, device="cpu")
    monkeypatch.undo()
    assert calls["n"] == 2
    assert res.verified == [True] * 3
    assert res.salts[:2] == SALTS[:2] and res.salts[2] != SALTS[2]
    assert jbatch.extract_batch(res.stego, master_key=MK,
                                params=jp(p)) == secrets


def test_prefetch_piw_walks_feeds_embed(monkeypatch):
    """prefetch_piw_walks expands each salt's payload walk into the
    single-use cache under the embed's own need (padded clen, RS coding);
    embed_batch pops every entry instead of expanding, and its stego is
    the one a cold embed makes."""
    covers, secrets = _covers(n=2, h=128, w=128), [b"a" * 30, b"b" * 41]
    p = Params(pbkdf2_iter=500, per_image_walk=True, rs=True, pad_quantum=16)
    cold = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                           salts=SALTS[:2], device="cpu").stego
    tbatch._PIW_CACHE.clear()
    stt.prefetch_piw_walks(None, MK, p, 128, 128, SALTS[:2],
                           [len(s) for s in secrets])
    assert len(tbatch._PIW_CACHE) == 2
    calls = []
    real = keystream.turtle_expand_chained
    monkeypatch.setattr(keystream, "turtle_expand_chained",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    warm = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                           salts=SALTS[:2], device="cpu").stego
    assert calls == [] and len(tbatch._PIW_CACHE) == 0
    np.testing.assert_array_equal(warm, cold)
    # bad input is swallowed; the embed would raise it
    assert stt.prefetch_piw_walks(None, None, p, 128, 128, SALTS[:2],
                                  [1, 2]) is None


def test_prefetch_walk_expands_the_header_prefix_only():
    mk = bytes(range(7, 39))
    p = Params(per_image_walk=True, jitter=0.1)
    n_hdr = len(keystream._HDR_CACHE)
    n_walks = len(keystream._CACHE)
    assert stt.prefetch_walk(None, mk, p, 128, 128, [40]) is None
    assert len(keystream._HDR_CACHE) == n_hdr + 1
    assert len(keystream._CACHE) == n_walks


def test_embed_stream_piw_prefetch_matches_batches(monkeypatch):
    """A per-image-walk stream with fixed salts yields the per-batch
    embed_batch stegos byte for byte; the payload walks were expanded on
    prefetch threads; without salts the stream draws them up front and
    the stegos still read back (JAX package too). Every payload walk was
    expanded exactly once, on a prefetch thread, and embed_batch popped
    it: the cache is empty after the stream."""
    names: list[str] = []
    real = keystream.turtle_expand_chained

    def spy(*a, **k):
        names.append(threading.current_thread().name)
        return real(*a, **k)

    monkeypatch.setattr(keystream, "turtle_expand_chained", spy)
    covers = _covers(n=4, h=128, w=128, seed=2)
    secrets = [bytes([65 + i]) * (20 + i) for i in range(4)]
    salts = [bytes([i + 100]) * 16 for i in range(4)]
    p = Params(pbkdf2_iter=500, per_image_walk=True, qim=3,
               alpha_spread=0.5)
    batches = [(covers[k:k + 2], secrets[k:k + 2], salts[k:k + 2])
               for k in (0, 2)]
    tbatch._PIW_CACHE.clear()
    streamed = list(tstream.embed_stream(iter(batches), master_key=MK,
                                         params=p, depth=2, device="cpu"))
    assert len(names) == 4, names
    assert all(n.startswith("piw-prefetch") for n in names), names
    assert len(tbatch._PIW_CACHE) == 0
    for (imgs, secs, sl), res in zip(batches, streamed):
        ref = stt.embed_batch(imgs, secs, master_key=MK, params=p, salts=sl,
                              device="cpu")
        np.testing.assert_array_equal(res.stego.numpy(), ref.stego)
    drawn = list(tstream.embed_stream(
        iter([(covers[:2], secrets[:2])]), master_key=MK, params=p,
        device="cpu"))
    assert jbatch.extract_batch(drawn[0].stego.numpy(), master_key=MK,
                                params=jp(p)) == secrets[:2]
    got = list(tstream.extract_stream((r.stego for r in streamed),
                                      master_key=MK, params=p, depth=2,
                                      device="cpu"))
    assert got == [secrets[:2], secrets[2:]]


def test_channel_report_rejects_piw():
    covers, secrets = _covers(n=1, h=128, w=128), [b"x"]
    with pytest.raises(stt.StegoError, match="per_image_walk"):
        stt.channel_report(covers, secrets, SALTS[:1], master_key=MK,
                           params=MODES["piw"], device="cpu")


def _spy_soft_core(monkeypatch, rows):
    from steganosaurus_tpu_torch.parallel import batch as tpbatch

    real_core = tpbatch.corner_soft_extract_core

    def spy(imgs, alpha, plane, *a, **kw):
        rows.append((imgs.shape[0], plane.dim()))
        return real_core(imgs, alpha, plane, *a, **kw)

    monkeypatch.setattr(tpbatch, "corner_soft_extract_core", spy)


def test_piw_soft_retry_recovers_margin(monkeypatch):
    """The soft-decode margin workload (256x256 noise cover, 240 B, B=8) on
    per-image walks, with the inline soft rows dropped: the retry pass's
    per-image group (corner_soft_extract_core over exactly the failed rows
    whose header parsed) recovers more than the hard decode, only true
    secrets."""
    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    n = 8
    hard_p = Params(per_image_walk=True, soft_decode_fallback=False)
    stego = stt.embed_batch(np.stack([cover] * n), [secret] * n,
                            master_key=MK, params=hard_p,
                            salts=[bytes([i]) * 16 for i in range(n)],
                            device="cpu").stego
    hard = stt.extract_batch(stego, master_key=MK, params=hard_p,
                             device="cpu")
    n_hard = sum(g is None for g in hard)
    assert n_hard > 0, "the margin workload no longer fails hard"
    real = tbatch._ExtractJob._dispatch_pass
    monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_pass",
                        lambda self, *a, **k: (real(self, *a, **k)[0], None,
                                               None))
    rows = []
    _spy_soft_core(monkeypatch, rows)
    got = stt.extract_batch(stego, master_key=MK,
                            params=hard_p.replace(soft_decode_fallback=True),
                            device="cpu")
    # round 1 reads the failed rows whose header parsed, on their own walks
    assert rows and 0 < rows[0][0] <= n_hard and rows[0][1] == 2
    assert sum(g is None for g in got) < n_hard
    assert all(g is None or g == secret for g in got)


@pytest.mark.parametrize("qim,rs", [(0, False), (3, False), (3, True)])
def test_piw_soft_retry_reads_each_mode(monkeypatch, qim, rs):
    """With the per-image payload pass's rows lost (zeroed), every image
    fails the hard open, and the retry pass alone must read them all back
    on their own walks: the QIM rule from the shared slot-aligned dither,
    and RS through the per-coded-byte confidences."""
    covers, secrets = _covers(n=3, h=128, w=128), [b"r0" * 9, b"r1", b"r2"]
    p = Params(pbkdf2_iter=500, per_image_walk=True, qim=qim, rs=rs)
    stego = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                            salts=SALTS[:3], device="cpu").stego
    real = tbatch._ExtractJob._dispatch_piw_pass
    monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_piw_pass",
                        lambda self, *a, **k: [bytes(len(b)) for b in
                                               real(self, *a, **k)])
    rows = []
    _spy_soft_core(monkeypatch, rows)
    assert stt.extract_batch(stego, master_key=MK, params=p,
                             device="cpu") == secrets
    assert rows == [(3, 2)]
