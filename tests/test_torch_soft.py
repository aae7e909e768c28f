"""The port's soft-decision recovery against the JAX package's, on the
margin workload of tests/test_soft_decode.py: a 256x256 full-range noise
cover, 240-byte secrets at the capacity edge, B=8, salts bytes([i])*16,
where the hard Rep-3/Rep-7 majority loses some images and matched-filter
combining (the inline soft sections of the fused pass, then the separate
f32 retry pass) recovers some of them. The workload sits on the decision
boundary by design, so the two packages' recovered sets may differ by one
image: the port's bf16 stages round in other places than XLA's."""

import dataclasses
import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.parallel import batch as tpbatch
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

MK = bytes(range(32))
HARD = Params(soft_decode_fallback=False)
SOFT = Params()
B = 8
SALTS = [bytes([i]) * 16 for i in range(B)]


def _workload():
    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    return np.stack([cover] * B), secret


_CACHE: dict = {}


def _stego(which):
    """The margin batch embedded by the port ("torch") or by the JAX
    package ("jax"), hard write."""
    if which not in _CACHE:
        covers, secret = _workload()
        if which == "torch":
            st = stt.embed_batch(covers, [secret] * B, master_key=MK,
                                 params=HARD, salts=SALTS,
                                 device="cpu").stego
        else:
            st = np.array(jbatch.embed_batch(covers, [secret] * B,
                                             master_key=MK, params=jp(HARD),
                                             salts=SALTS).stego)
        _CACHE[which] = (st, secret)
    return _CACHE[which]


def _extract(stego, params):
    return stt.extract_batch(stego, master_key=MK, params=params,
                             device="cpu")


def _n_failed(got):
    return sum(g is None for g in got)


def test_soft_recovers_more_than_hard():
    stego, secret = _stego("torch")
    hard = _extract(stego, HARD)
    soft = _extract(stego, SOFT)
    assert _n_failed(hard) > 0, "the margin workload no longer fails hard"
    assert _n_failed(soft) < _n_failed(hard)
    for h, s in zip(hard, soft):
        if s is not None:
            assert s == secret      # every recovered secret is the true one
        if h is not None:
            assert s == h           # no hard success changes


def test_inline_soft_then_retry_pass(monkeypatch):
    """tests/test_soft_decode.py:132-176 on the port: the inline soft
    sections recover strictly more than hard with the retry pass disabled;
    the full path recovers at least as many; the retry pass is called with
    exactly the images inline could not fix."""
    stego, secret = _stego("torch")
    n_hard = _n_failed(_extract(stego, HARD))
    n_full = _n_failed(_extract(stego, SOFT))
    monkeypatch.setattr(tbatch._ExtractJob, "_soft_retry_failed",
                        lambda self, headers, out: None)
    inline = _extract(stego, SOFT)
    n_inline = _n_failed(inline)
    assert n_inline < n_hard
    assert n_full <= n_inline
    assert all(g is None or g == secret for g in inline)
    seen = []
    monkeypatch.setattr(
        tbatch._ExtractJob, "_soft_retry_failed",
        lambda self, headers, out: seen.append(
            sum(h is not None and o is None for h, o in zip(headers, out))))
    _extract(stego, SOFT)
    assert seen == ([n_inline] if n_inline else [])


def test_retry_pass_alone_recovers(monkeypatch):
    """With the fused pass's inline soft rows dropped, only the separate
    retry pass (corner_soft_extract_core over exactly the failed rows) can
    recover: it must, and it must run on those rows only."""
    stego, secret = _stego("torch")
    hard = _extract(stego, HARD)
    n_hard = _n_failed(hard)
    real_dispatch = tbatch._ExtractJob._dispatch_pass
    real_core = tpbatch.corner_soft_extract_core
    rows = []

    def no_inline(self, *a, **kw):
        hard_rows, _, _ = real_dispatch(self, *a, **kw)
        return hard_rows, None, None

    def spy(imgs, *a, **kw):
        rows.append(imgs.shape[0])
        return real_core(imgs, *a, **kw)

    monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_pass", no_inline)
    monkeypatch.setattr(tpbatch, "corner_soft_extract_core", spy)
    got = _extract(stego, SOFT)
    assert _n_failed(got) < n_hard
    assert rows and rows[0] == n_hard  # round 1: the hard failures only
    for h, g in zip(hard, got):
        assert g is None or g == secret
        if h is not None:
            assert g == h


def test_recovered_sets_match_jax():
    """On the JAX package's stegos, each package's soft extract recovers
    only true secrets, and their recovered sets differ by at most one
    image (printed when they differ)."""
    stego, secret = _stego("jax")
    mine = _extract(stego, SOFT)
    ref = jbatch.extract_batch(stego, master_key=MK, params=jp(SOFT))
    for got in (mine, ref):
        assert all(g is None or g == secret for g in got)
    ok_mine = {i for i, g in enumerate(mine) if g is not None}
    ok_ref = {i for i, g in enumerate(ref) if g is not None}
    if ok_mine != ok_ref:
        print(f"recovered by the port only: {sorted(ok_mine - ok_ref)}, "
              f"by the JAX package only: {sorted(ok_ref - ok_mine)}")
    assert len(ok_mine ^ ok_ref) <= 1
    hard = _extract(stego, HARD)
    assert _n_failed(mine) <= _n_failed(hard)


@pytest.mark.parametrize("with_jitter", [False, True])
def test_soft_core_agrees_with_hard_on_clean_stegos(with_jitter):
    """On a clean channel the f32 retry core decodes exactly what the hard
    fused core decodes (the sign of each copy group's sum is its majority
    when no copy flips), with and without jitter."""
    from steganosaurus_tpu_torch.spectral import corner

    p = Params(jitter=0.2 if with_jitter else 0.0)
    rng = np.random.default_rng(4)
    covers = np.clip(np.linspace(160, 220, 128)[None, None, :, None]
                     + rng.integers(-10, 11, (2, 128, 128, 3)), 0,
                     255).astype(np.uint8)
    secrets = [b"clean-0", b"clean-1"]
    st = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                         salts=SALTS[:2], device="cpu").stego
    n = 912 + (7 + 16) * 56
    (pl, yy, xx, jj), _ = tbatch._walk_indices_device(
        None, MK, p, 128, 128, n, 0, 4096, torch.device("cpu"))
    jit = jj if with_jitter else None
    Ky, Kx = corner.corner_dims(128, 128, p.rmax)
    kw = dict(Ky=Ky, Kx=Kx, center=p.center, layout="nhwc",
              hdr_stream_bits=912, jit=jit)
    imgs = torch.from_numpy(st)
    hard = tpbatch.corner_extract_fused_core(imgs, p.alpha, pl, yy, xx,
                                             with_soft=False, **kw)
    soft = tpbatch.corner_soft_extract_core(imgs, p.alpha, pl, yy, xx, **kw)
    torch.testing.assert_close(soft, hard, rtol=0, atol=0)
