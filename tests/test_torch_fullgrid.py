"""The port's full-grid batch cores (Params.adaptive_alpha) and the batch
extraction of rows the batch readers cannot read, against the JAX package,
on the CPU.

- batched_analyze_core, batched_embed_core and batched_gather_decode_core
  on identical inputs: spectra within 1e-5 of their scale, stego bytes +-1
  on at most MAX_DIFF_FRAC of the bytes, decoded rows (hard and soft) equal.
- adaptive_alpha batches (nhwc; shared walk, alpha spread, per-image walks,
  soft write, RS) embed and extract, and cross-decode with the JAX package
  both ways with recovery 1.0; verify re-reads through the full-grid path.
- The inline soft rows of the full-grid read recover margin failures the
  hard decode loses (tests/test_soft_decode.py's adaptive batch workload).
- A mixed batch — the port's standard stegos, JAX-written coherent stegos
  (embed_array) and a plain cover — goes through extract_batch: every
  secret comes back and the cover reads as None, in either layout and from
  a tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.parallel import batch as jpb
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.pipeline.embed import embed_array as jembed
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import bits as tbits
from steganosaurus_tpu_torch.parallel import batch as tpb

torch.set_num_threads(2)

H, W, B = 256, 256, 4
MK = bytes(range(32))
FAST = dict(pbkdf2_iter=500)
SPEC_TOL = 1e-5
MAX_DIFF_FRAC = 5e-3


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))


def _covers(n=B, seed=17, amp=20):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(70, 190, W)[None, None, :, None]
    return np.clip(ramp + rng.integers(-amp, amp + 1, (n, H, W, 3)), 0,
                   255).astype(np.uint8)


def _secrets(n=B, seed=18, size=48):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size - i, dtype=np.uint8))
            for i in range(n)]


def _walk(n, seed, per_image=False):
    """A shared (n,) or per-image (B, n) set of distinct off-axis bins and
    jitter angles, int32/f32 host arrays."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B if per_image else 1):
        flat = rng.choice(3 * (H // 2 - 1) * (W // 2 - 1), n, replace=False)
        p, r = np.divmod(flat, (H // 2 - 1) * (W // 2 - 1))
        y, x = np.divmod(r, W // 2 - 1)
        rows.append((p, y + 1, x + 1))
    a = np.asarray(rows, np.int32)
    jit = rng.uniform(-0.2, 0.2, (len(rows), n)).astype(np.float32)
    if not per_image:
        return a[0, 0], a[0, 1], a[0, 2], jit[0]
    return a[:, 0], a[:, 1], a[:, 2], jit


# --- the cores ---------------------------------------------------------------

def test_batched_analyze_core_matches_jax():
    imgs = _covers()
    js, jm = jpb.batched_analyze_core(H, W, False)(imgs)
    ts, tm = tpb.batched_analyze_core(torch.from_numpy(imgs), center=False)
    js, jm = np.asarray(js), np.asarray(jm)
    assert ts.shape == (B, 3, H, W) and tm.shape == (B, 3)
    assert np.abs(ts.numpy() - js).max() <= SPEC_TOL * np.abs(js).max()
    # medians of two FFTs agree to the FFTs' own tolerance (the median of
    # identical magnitudes is exact: tests/test_torch_single.py)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=SPEC_TOL)


@pytest.mark.parametrize("per_image,soft,floor", [
    (False, False, 0.45), (False, True, 0.45), (True, False, 0.45),
    (False, False, 0.0)])
def test_batched_embed_core_matches_jax(per_image, soft, floor):
    imgs = _covers()
    n = 4096
    plane, y, x, jit = _walk(n, 5, per_image)
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (B, n)).astype(np.uint8)
    words = tbits.pack_bits_words_host(bits)
    n_valid = (np.full(B, n - 100, np.int32) if per_image
               else np.int32(n - 100))
    fn = jpb.batched_embed_core(H, W, False, True, None,
                                shared_idx=not per_image, bits_packed=True,
                                soft=soft, floor=floor)
    args = (imgs, plane, y, x, words, jit, np.float32(0.5))
    js = np.asarray(fn(*args, n_valid) if floor else fn(*args))
    t = torch.from_numpy
    ts = tpb.batched_embed_core(
        t(imgs), t(plane), t(y), t(x), t(words), t(jit), 0.5,
        (t(n_valid.astype(np.int64)) if per_image else int(n_valid))
        if floor else None,
        center=False, soft=soft, floor=floor).numpy()
    diff = ts.astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= MAX_DIFF_FRAC * diff.size


@pytest.mark.parametrize("with_soft,rep", [(False, 7), (True, 7), (True, 1)])
def test_batched_gather_decode_core_matches_jax(with_soft, rep):
    """On the JAX package's own spectra: equal hard rows and equal soft rows
    (RS confidences within SPEC_TOL of their largest: two libraries' sin and
    angle round differently where |d| is small)."""
    imgs = _covers()
    js, jm = jpb.batched_analyze_core(H, W, False)(imgs)
    n = 912 + 2048
    plane, y, x, jit = _walk(n, 7)
    core = jpb.batched_gather_decode_core(True, None, hdr_stream_bits=912,
                                          payload_rep=rep,
                                          with_soft=with_soft)
    want = core(js, jm, plane, y, x, jit, np.float32(0.5))
    t = torch.from_numpy
    got = tpb.batched_gather_decode_core(
        t(np.array(js)), t(np.array(jm)), t(plane), t(y), t(x), t(jit), 0.5,
        hdr_stream_bits=912, payload_rep=rep,
        with_soft=with_soft)
    if not with_soft:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    ws, gs = np.asarray(want[1]), got[1].numpy()
    nw = gs.shape[1] - (2048 // 8 if rep == 1 else 0)
    np.testing.assert_array_equal(gs[:, :nw], ws[:, :nw])
    if rep == 1:
        cw = ws[:, nw:].view(np.float32)
        np.testing.assert_allclose(gs[:, nw:].view(np.float32), cw, rtol=0,
                                   atol=SPEC_TOL * np.abs(cw).max())


# --- adaptive_alpha batches -------------------------------------------------

ADAPTIVE = {
    "shared": Params(adaptive_alpha=True, **FAST),
    "spread_jitter": Params(adaptive_alpha=True, alpha_spread=0.5,
                            jitter=0.2, **FAST),
    "per_image_walk": Params(adaptive_alpha=True, per_image_walk=True,
                             **FAST),
    "soft_rs": Params(adaptive_alpha=True, soft_write=True, rs=True,
                      **FAST),
}
_CACHE: dict = {}


def _adaptive_pair(mode):
    if mode not in _CACHE:
        p = ADAPTIVE[mode]
        imgs, secrets = _covers(), _secrets()
        salts = [bytes([40 + i]) * 16 for i in range(B)]
        t = stt.embed_batch(imgs, secrets, master_key=MK, params=p,
                            salts=salts, device="cpu")
        j = jbatch.embed_batch(imgs, secrets, master_key=MK, params=jp(p),
                               salts=salts)
        assert t.written_bits == j.written_bits
        _CACHE[mode] = (secrets, t.stego, np.asarray(j.stego))
    return _CACHE[mode]


@pytest.mark.parametrize("mode", list(ADAPTIVE))
def test_adaptive_batch_cross_decodes(mode):
    p = ADAPTIVE[mode]
    secrets, ts, js = _adaptive_pair(mode)
    assert jbatch.extract_batch(ts, master_key=MK, params=jp(p)) == secrets
    for stego in (ts, js):
        assert stt.extract_batch(stego, master_key=MK, params=p,
                                 device="cpu") == secrets
        assert stt.extract_batch(stego, master_key=MK, params=p,
                                 clen_hint=48, device="cpu") == secrets


@pytest.mark.parametrize("mode", list(ADAPTIVE))
def test_adaptive_batch_bytes_match_jax(mode):
    _, ts, js = _adaptive_pair(mode)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    print(f"{mode}: {n} of {diff.size} bytes differ")
    assert np.abs(diff).max() <= 1
    assert n <= MAX_DIFF_FRAC * diff.size, n


def test_adaptive_batch_verify_and_device_resident():
    p = ADAPTIVE["shared"]
    imgs, secrets = _covers(3, seed=19), _secrets(3, seed=20)
    res = stt.embed_batch(torch.from_numpy(imgs), secrets, password="pw",
                          params=p, verify=True, device_resident=True)
    assert res.verified == [True] * 3
    assert isinstance(res.stego, torch.Tensor)
    job = stt.extract_dispatch(res.stego, password="pw", params=p)
    assert job.finalize() == secrets
    assert jbatch.extract_batch(res.stego.numpy(), password="pw",
                                params=jp(p)) == secrets


def test_adaptive_inline_soft_recovers_margin_failures():
    """tests/test_soft_decode.py's adaptive batch margin workload (noise
    covers, 240 bytes, salts 0..7): the full-grid read's inline soft rows
    recover images the hard decode loses, as in the JAX package."""
    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    n = 8
    covers = np.stack([cover] * n)
    salts = [bytes([i]) * 16 for i in range(n)]
    hard_p = Params(adaptive_alpha=True, soft_decode_fallback=False)
    soft_p = Params(adaptive_alpha=True)
    res = stt.embed_batch(covers, [secret] * n, master_key=MK, params=hard_p,
                          salts=salts, device="cpu")
    hard = stt.extract_batch(res.stego, master_key=MK, params=hard_p,
                             device="cpu")
    soft = stt.extract_batch(res.stego, master_key=MK, params=soft_p,
                             device="cpu")
    jsoft = jbatch.extract_batch(res.stego, master_key=MK,
                                 params=jp(soft_p))
    n_hard = sum(g is None for g in hard)
    n_soft = sum(g is None for g in soft)
    assert n_hard > 0 and n_soft < n_hard, (n_hard, n_soft)
    for h, s in zip(hard, soft):
        assert s is None or s == secret
        assert h is None or s == h
    assert soft == jsoft


def test_channel_report_refuses_full_grid_like_jax():
    imgs, secrets = _covers(1), _secrets(1)
    salts = [bytes(16)]
    for field in ("adaptive_alpha", "cover_dependent_path"):
        p = Params(**FAST).replace(**{field: True})
        with pytest.raises(stt.StegoError, match="shared-walk corner path"):
            stt.channel_report(imgs, secrets, salts, master_key=MK, params=p,
                               device="cpu")
        with pytest.raises(Exception, match="shared-walk corner path"):
            jbatch.channel_report(imgs, secrets, salts, master_key=MK,
                                  params=jp(p))


# --- mixed batches through extract_batch ------------------------------------

def _mixed():
    """Rows: two port stegos (shared walk), two JAX-written coherent stegos
    (one plain, one QIM), a plain cover; and their secrets (None for the
    cover)."""
    if "mixed" not in _CACHE:
        covers = _covers(5, seed=23)
        p = Params(**FAST)
        plain = stt.embed_batch(covers[:2], [b"row-0", b"row-1 longer"],
                                master_key=MK, params=p,
                                device="cpu").stego
        coh = [np.asarray(jembed(covers[2 + i], s, master_key=MK,
                                 params=jp(Params(coherent=True, qim=q,
                                                  **FAST)),
                                 salt=bytes([60 + i]) * 16).stego)
               for i, (s, q) in enumerate([(b"coherent-2", 0),
                                           (b"coherent-qim-3", 4)])]
        stack = np.concatenate([plain, np.stack(coh), covers[4:5]])
        _CACHE["mixed"] = (stack, [b"row-0", b"row-1 longer", b"coherent-2",
                                   b"coherent-qim-3", None])
    return _CACHE["mixed"]


@pytest.mark.parametrize("form", ["nhwc", "nchw", "tensor", "hint"])
def test_mixed_batch_with_coherent_rows_and_a_cover(form):
    stack, want = _mixed()
    p = Params(**FAST)
    kw = dict(master_key=MK, params=p, device="cpu")
    if form == "nchw":
        got = stt.extract_batch(np.ascontiguousarray(
            stack.transpose(0, 3, 1, 2)), layout="nchw", **kw)
    elif form == "tensor":
        job = stt.extract_dispatch(torch.from_numpy(stack), master_key=MK,
                                   params=p)
        got = job.finalize()
    else:
        got = stt.extract_batch(stack, clen_hint=12 if form == "hint"
                                else None, **kw)
    assert got == want
    if form == "nhwc":
        assert jbatch.extract_batch(stack, master_key=MK,
                                    params=jp(p)) == want


def test_port_coherent_stegos_read_by_both_batch_extracts():
    covers = _covers(2, seed=29)
    p = Params(coherent=True, **FAST)
    secrets = [b"port-coherent-a", b"port-coherent-b!"]
    # fixed salts: each package's f32 coherent embed misses ~0.2% of
    # salts (tools/coherent_salt_sweep.py), so a random one fails the
    # read now and then in either package
    stegos = np.stack([stt.embed_array(c, s, password="pw", params=p,
                                       salt=bytes([i]) * 16,
                                       device="cpu").stego
                       for i, (c, s) in enumerate(zip(covers, secrets))])
    assert stt.extract_batch(stegos, password="pw", params=Params(**FAST),
                             device="cpu") == secrets
    assert jbatch.extract_batch(stegos, password="pw",
                                params=jp(Params(**FAST))) == secrets
