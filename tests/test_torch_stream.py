"""The port's stream pipelining (pipeline/stream.py) against per-batch calls
and against the JAX package: the overlap is scheduling only, so streamed
stegos equal the per-batch stegos byte for byte, a key rotation mid-stream
decodes, and the JAX package reads the streamed stegos (ports of
tests/test_batch.py:255-277 and :490-550, 128x128 covers)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.pipeline import stream as tstream
from steganosaurus_tpu_torch import keystream
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

FAST = Params(pbkdf2_iter=500)
MK1, MK2 = bytes(range(32)), bytes(range(1, 33))


def _covers():
    rng = np.random.default_rng(21)
    base = np.linspace(170, 225, 128)
    imgs = base[None, None, :, None] + rng.integers(-12, 13, (6, 128, 128, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_stream_matches_batch(layout):
    covers = _covers()
    if layout == "nchw":
        covers = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    secrets = [bytes([i]) * (5 + i) for i in range(6)]
    salts = [bytes([i * 7]) * 16 for i in range(6)]
    batches = [(covers[k:k + 2], secrets[k:k + 2], salts[k:k + 2])
               for k in (0, 2, 4)]
    streamed = list(tstream.embed_stream(iter(batches), password="pw",
                                         params=FAST, depth=2, layout=layout,
                                         device="cpu"))
    assert len(streamed) == 3
    for (imgs, secs, sl), res in zip(batches, streamed):
        assert isinstance(res.stego, torch.Tensor)  # device-resident
        ref = stt.embed_batch(imgs, secs, password="pw", params=FAST,
                              salts=sl, layout=layout, device="cpu")
        np.testing.assert_array_equal(res.stego.numpy(), ref.stego)
        assert res.salts == sl
        assert jbatch.extract_batch(res.stego.numpy(), password="pw",
                                    params=jp(FAST), layout=layout) == secs
    got = list(tstream.extract_stream((r.stego for r in streamed),
                                      password="pw", params=FAST, depth=2,
                                      layout=layout, device="cpu"))
    assert [s for g in got for s in g] == secrets


def test_stream_key_rotation_prefetch(monkeypatch):
    """A per-batch master_key: results equal per-key embed_batch calls, and
    the new key's walk expansion runs on the worker thread."""
    names: list[str] = []
    real_expand = keystream.turtle_expand

    def spy(*a, **k):
        names.append(threading.current_thread().name)
        return real_expand(*a, **k)

    monkeypatch.setattr(keystream, "turtle_expand", spy)
    keystream._CACHE.clear()  # cold walks: both keys must expand
    covers = _covers()
    secrets = [b"rotate", b"keys!!"]
    salts = [bytes([40]) * 16, bytes([41]) * 16]
    batches = [(covers[:2], secrets, salts),
               (covers[2:4], secrets, salts, MK2),
               (covers[4:6], secrets, salts, MK2)]
    got = list(tstream.embed_stream(iter(batches), master_key=MK1,
                                    params=FAST, depth=2, device="cpu"))
    assert len(got) == 3
    assert any(n.startswith("walk-pf") for n in names), names
    for k, mk in ((0, MK1), (1, MK2)):
        ref = stt.embed_batch(covers[2 * k:2 * k + 2], secrets,
                              master_key=mk, params=FAST, salts=salts,
                              device="cpu")
        np.testing.assert_array_equal(got[k].stego.numpy(), ref.stego)
    assert stt.extract_batch(got[2].stego, master_key=MK2,
                             params=FAST) == secrets
    assert jbatch.extract_batch(got[2].stego.numpy(), master_key=MK2,
                                params=jp(FAST)) == secrets


def test_extract_stream_key_rotation():
    """extract_stream takes (stego, master_key) tuples; here on the JAX
    package's stegos."""
    covers = _covers()
    secrets = [b"stream-rot-a", b"stream-rot-b"]
    salts = [bytes([50]) * 16, bytes([51]) * 16]
    r1 = jbatch.embed_batch(covers[:2], secrets, master_key=MK1, params=jp(FAST),
                            salts=salts)
    r2 = jbatch.embed_batch(covers[2:4], secrets, master_key=MK2,
                            params=jp(FAST), salts=salts)
    got = list(tstream.extract_stream(
        iter([np.asarray(r1.stego), (np.asarray(r2.stego), MK2),
              np.asarray(r1.stego)]),
        master_key=MK1, params=FAST, clen_hint=12, depth=2, device="cpu"))
    assert got == [secrets, secrets, secrets]


def test_stream_verify_and_depth_one():
    """verify=True inside a stream, depth 1 (each batch waited for before
    the next is queued)."""
    covers = _covers()
    secrets = [b"sv%d" % i for i in range(6)]
    outs = list(tstream.embed_stream(
        iter([(covers[:3], secrets[:3]), (covers[3:], secrets[3:])]),
        password="pw", params=FAST, verify=True, depth=1, device="cpu"))
    assert [r.verified for r in outs] == [[True] * 3, [True] * 3]
    got = list(tstream.extract_stream((r.stego for r in outs),
                                      password="pw", params=FAST, depth=1,
                                      device="cpu"))
    assert got == [secrets[:3], secrets[3:]]


def test_load_rgb_batches(tmp_path):
    """Same-shape runs are stacked up to batch_size; a shape change
    flushes the stack."""
    from steganosaurus_tpu.io import image as image_io

    rng = np.random.default_rng(0)
    shapes = [(16, 24), (16, 24), (16, 24), (8, 8), (16, 24)]
    paths, imgs = [], []
    for k, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        p = tmp_path / f"img{k}.png"
        image_io.save_png(str(p), img)
        paths.append(str(p))
        imgs.append(img)
    out = list(stt.load_rgb_batches(paths, batch_size=2, threads=2))
    assert [len(ps) for ps, _ in out] == [2, 1, 1, 1]
    assert [ps for ps, _ in out] == [paths[:2], paths[2:3], paths[3:4],
                                     paths[4:]]
    np.testing.assert_array_equal(out[0][1], np.stack(imgs[:2]))
    np.testing.assert_array_equal(out[2][1], imgs[3][None])


def test_prefetch_walk_warms_the_host_cache_only(monkeypatch):
    """prefetch_walk expands the walk into keystream's (locked) host cache
    and leaves the port's device caches alone; bad input is swallowed."""
    from steganosaurus_tpu_torch.pipeline import batch as tbatch

    keystream._CACHE.clear()
    n_idx = len(tbatch._DEV_IDX_CACHE)
    n_statics = len(tbatch._CORNER_STATICS_CACHE)
    mk = bytes(range(5, 37))
    assert stt.prefetch_walk(None, mk, FAST, 128, 128, [40]) is None
    assert len(keystream._CACHE) == 1
    assert len(tbatch._DEV_IDX_CACHE) == n_idx
    assert len(tbatch._CORNER_STATICS_CACHE) == n_statics
    # the embed that follows finds the walk warm: no second expansion
    calls = []
    real = keystream._expand_raw
    monkeypatch.setattr(keystream, "_expand_raw",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = stt.embed_batch(_covers()[:1], [b"p" * 40], master_key=mk,
                          params=FAST, device="cpu")
    assert calls == []
    assert stt.extract_batch(res.stego, master_key=mk, params=FAST,
                             device="cpu") == [b"p" * 40]
    # neither key nor password: the error is left for the embed to raise
    assert stt.prefetch_walk(None, None, FAST, 128, 128, [40]) is None
