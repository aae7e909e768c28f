"""The torch port's batch embed -> extract slice against the JAX package.

384x640 covers (a Ky = Kx = 256 corner), B=4, 128-byte secrets, a fixed
master key and fixed salts, on the CPU (the port's kernel wrappers take
their plain versions for CPU tensors). Stegos must cross-decode between the
packages in both directions and both layouts, and the two packages' stego
bytes may differ only by +-1 on at most 0.1% of the bytes: the bf16 stages
round in other places (torch's matmul vs XLA's dot sum in another order,
and topk may break energy ties the other way)."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, B, SECRET = 384, 640, 4, 128
MK = bytes(range(32))
SALTS = [bytes([i]) * 16 for i in range(B)]
MAX_DIFF_FRAC = 1e-3


def _inputs(layout):
    rng = np.random.default_rng(21)
    base = np.linspace(150, 235, W)
    imgs = np.clip(base[None, None, :, None]
                   + rng.integers(-18, 19, (B, H, W, 3)), 0,
                   255).astype(np.uint8)
    if layout == "nchw":
        imgs = np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))
    secrets = [bytes(rng.integers(0, 256, SECRET, dtype=np.uint8))
               for _ in range(B)]
    return imgs, secrets


_CACHE: dict = {}


def _stegos(layout):
    """(covers, secrets, torch stego, JAX stego) for one layout, made once."""
    if layout not in _CACHE:
        imgs, secrets = _inputs(layout)
        ts = stt.embed_batch(imgs, secrets, master_key=MK, salts=SALTS,
                             layout=layout, device="cpu").stego
        js = np.array(jbatch.embed_batch(imgs, secrets, master_key=MK,
                                         salts=SALTS, layout=layout).stego)
        _CACHE[layout] = (imgs, secrets, ts, js)
    return _CACHE[layout]


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_torch_embed_jax_extract(layout):
    imgs, secrets, ts, _ = _stegos(layout)
    assert isinstance(ts, np.ndarray) and ts.dtype == np.uint8
    assert ts.shape == imgs.shape
    got = jbatch.extract_batch(ts, master_key=MK, clen_hint=SECRET,
                               layout=layout)
    assert got == secrets


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_jax_embed_torch_extract(layout):
    _, secrets, _, js = _stegos(layout)
    got = stt.extract_batch(js, master_key=MK, clen_hint=SECRET,
                            layout=layout, device="cpu")
    assert got == secrets


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_stego_bytes_match_jax(layout):
    """Same covers, secrets, key and salts: every differing byte is off by
    one, and at most 0.1% of them differ."""
    _, _, ts, js = _stegos(layout)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    assert np.abs(diff).max() <= 1
    assert n <= MAX_DIFF_FRAC * diff.size, (n, diff.size)


ODD_H, ODD_W, ODD_B = 384, 637, 2  # W % 16 != 0: K1's load route on a card
_ODD: dict = {}


def _odd_stegos():
    """(secrets, torch stego, JAX stego) of B=2 covers of width 637 at fixed
    salts (nhwc), made once."""
    if not _ODD:
        rng = np.random.default_rng(22)
        base = np.linspace(150, 235, ODD_W)
        imgs = np.clip(base[None, None, :, None]
                       + rng.integers(-18, 19, (ODD_B, ODD_H, ODD_W, 3)), 0,
                       255).astype(np.uint8)
        secrets = [bytes(rng.integers(0, 256, SECRET, dtype=np.uint8))
                   for _ in range(ODD_B)]
        salts = SALTS[:ODD_B]
        ts = stt.embed_batch(imgs, secrets, master_key=MK, salts=salts,
                             device="cpu").stego
        js = np.array(jbatch.embed_batch(imgs, secrets, master_key=MK,
                                         salts=salts).stego)
        _ODD.update(secrets=secrets, ts=ts, js=js)
    return _ODD["secrets"], _ODD["ts"], _ODD["js"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_odd_width_cross_decode(writer):
    """At a width that is not a multiple of 16 the port's stegos read back
    in the JAX package and the JAX package's in the port, every secret."""
    secrets, ts, js = _odd_stegos()
    if writer == "torch":
        got = jbatch.extract_batch(ts, master_key=MK, clen_hint=SECRET)
    else:
        got = stt.extract_batch(js, master_key=MK, clen_hint=SECRET,
                                device="cpu")
    assert got == secrets


def test_odd_width_stego_bytes_match_jax():
    """The same covers, secrets, key and salts at width 637: every byte
    that differs between the packages' stegos differs by one, and at most
    0.1% of them do."""
    _, ts, js = _odd_stegos()
    assert ts.shape == js.shape == (ODD_B, ODD_H, ODD_W, 3)
    diff = ts.astype(np.int16) - js.astype(np.int16)
    n = int(np.count_nonzero(diff))
    assert np.abs(diff).max() <= 1
    assert n <= MAX_DIFF_FRAC * diff.size, (n, diff.size)


def test_torch_round_trip_without_hint_and_device_resident():
    """No clen_hint: the header-only probe pass (912 slots) then the payload
    pass; device_resident returns the stego as a tensor in the input
    layout."""
    imgs, secrets = _inputs("nchw")
    res = stt.embed_batch(torch.from_numpy(imgs), secrets, master_key=MK,
                          salts=SALTS, device_resident=True, layout="nchw")
    assert isinstance(res.stego, torch.Tensor)
    assert res.stego.dtype == torch.uint8 and res.stego.shape == imgs.shape
    assert res.written_bits == [912 + (SECRET + 16) * 56] * B
    assert res.salts == SALTS and res.payload_bytes == [SECRET] * B
    job = stt.extract_dispatch(res.stego, master_key=MK, layout="nchw")
    assert job.finalize() == secrets
    assert job.finalize() == secrets  # idempotent
    # a short hint costs a second pass, never a wrong result
    assert stt.extract_batch(res.stego, master_key=MK, clen_hint=16,
                             layout="nchw") == secrets


def test_wrong_key_and_flagged_headers_read_as_none(monkeypatch):
    """An image that does not open yields None, never an exception: a
    wrong key, and a header whose FLAGS byte carries FLAG_COHERENT over a
    payload that was not written coherently (the row goes to the
    single-image extract_array, which reads a coherent payload, fails its
    AEAD and its soft retry, and raises StegoError, which the batch turns
    into None). A FLAGS bit of a mode the port carries (here FLAG_PADDED
    from Params.pad_quantum) reads back."""
    from steganosaurus_tpu_torch.pipeline import batch as tpb
    from steganosaurus_tpu_torch.pipeline import header as theader

    imgs, secrets = _inputs("nhwc")
    _, _, ts, _ = _stegos("nhwc")
    assert stt.extract_batch(ts, master_key=bytes(32), clen_hint=SECRET,
                             device="cpu") == [None] * B
    padded = np.array(jbatch.embed_batch(imgs, secrets, master_key=MK,
                                         salts=SALTS,
                                         params=jp(Params(pad_quantum=64))).stego)
    assert jbatch.extract_batch(padded, master_key=MK,
                                params=jp(Params(pad_quantum=64))) == secrets
    assert stt.extract_batch(padded, master_key=MK, device="cpu") == secrets
    monkeypatch.setattr(tpb, "_flags", lambda params: theader.FLAG_COHERENT)
    flagged = stt.embed_batch(imgs[:2], secrets[:2], master_key=MK,
                              salts=SALTS[:2], device="cpu").stego
    monkeypatch.undo()
    assert stt.extract_batch(np.concatenate([flagged[:1], ts[1:2]]),
                             master_key=MK, clen_hint=SECRET,
                             device="cpu") == [None, secrets[1]]


@pytest.mark.parametrize("field,value", [
    ("soft_write", True), ("qim", 4), ("rs", True),
    ("alpha_spread", 0.2), ("per_image_walk", True), ("pad_quantum", 64),
    ("adaptive_alpha", True), ("coherent", True),
    ("cover_dependent_path", True)])
def test_unsupported_params_raise(field, value):
    """The batch path refuses exactly what the JAX package's refuses, with
    its errors: the per-image modes coherent (embed only: extraction reads
    coherent rows through extract_array) and cover_dependent_path (embed
    and extract), and adaptive_alpha in the nchw layout. Every other field
    embeds and reads back, adaptive_alpha (nhwc) through the full-grid
    cores."""
    imgs, secrets = _inputs("nhwc")
    p = Params().replace(**{field: value})
    if field not in ("coherent", "cover_dependent_path"):
        res = stt.embed_batch(imgs[:1], secrets[:1], master_key=MK,
                              params=p, device="cpu")
        assert stt.extract_batch(res.stego, master_key=MK, params=p,
                                 device="cpu") == secrets[:1]
        if field == "adaptive_alpha":
            nchw = np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))
            for call in (stt.embed_batch, stt.extract_batch):
                args = (nchw, secrets) if call is stt.embed_batch else (nchw,)
                with pytest.raises(stt.StegoError, match="corner-path only"):
                    call(*args, master_key=MK, params=p, layout="nchw",
                         device="cpu")
        return
    with pytest.raises(stt.StegoError, match=field):
        stt.embed_batch(imgs, secrets, master_key=MK, params=p, device="cpu")
    for jcall in (jbatch.embed_batch, jbatch.extract_batch):
        jargs = (imgs, secrets) if jcall is jbatch.embed_batch else (imgs,)
        if field == "coherent" and jcall is jbatch.extract_batch:
            continue
        with pytest.raises(Exception, match=field):
            jcall(*jargs, master_key=MK, params=jp(p))
    if field == "cover_dependent_path":
        with pytest.raises(stt.StegoError, match=field):
            stt.extract_batch(imgs, master_key=MK, params=p, device="cpu")
    else:  # Params.coherent is embed-side only, as in the JAX package
        assert stt.extract_batch(imgs[:1], master_key=MK, params=p,
                                 device="cpu") == [None]


def test_unsupported_call_options_raise():
    imgs, secrets = _inputs("nhwc")
    # mesh= takes a parallel Mesh (tests/test_torch_parallel.py), nothing else
    with pytest.raises(TypeError, match="mesh"):
        stt.embed_batch(imgs, secrets, master_key=MK, mesh=object(),
                        device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        stt.extract_batch(imgs, master_key=MK, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        stt.embed_batch(imgs, secrets, device="cpu")  # no key
    with pytest.raises(ValueError):
        stt.embed_batch(imgs, secrets, master_key=MK, layout="hwc",
                        device="cpu")
    with pytest.raises(ValueError, match="channels"):
        stt.embed_batch(imgs, secrets, master_key=MK, layout="nchw",
                        device="cpu")
    with pytest.raises(ValueError, match="salts"):
        stt.embed_batch(imgs, secrets, master_key=MK, salts=SALTS[:-1],
                        device="cpu")


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    imgs, secrets = _inputs("nhwc")
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.embed_batch(imgs, secrets, master_key=MK, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.extract_batch(imgs, master_key=MK)  # the default device is CUDA
    from steganosaurus_tpu_torch import runtime

    with pytest.raises(RuntimeError):
        runtime.require_cuda()


def test_port_never_imports_jax():
    """Importing the port (its stream and metrics modules too) and running
    a CPU round trip leaves jax out of sys.modules (the card's machine has
    no JAX)."""
    code = """
import sys
import numpy as np
import torch
import steganosaurus_tpu_torch as stt
import steganosaurus_tpu_torch.pipeline.stream
import steganosaurus_tpu_torch.utils.metrics
torch.set_num_threads(2)
rng = np.random.default_rng(0)
imgs = rng.integers(100, 160, (2, 256, 256, 3), dtype=np.uint8)
secrets = [b"x" * 32, b"y" * 32]
res = stt.embed_batch(imgs, secrets, master_key=bytes(32), device="cpu")
got = stt.extract_batch(res.stego, master_key=bytes(32), clen_hint=32,
                        device="cpu")
assert got == secrets, got
print("jax" in sys.modules, any(m.startswith("jax") for m in sys.modules))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"], out.stdout


# --- ragged secrets, jitter and verify (128x128 covers, B=6) ---------------

FAST = Params(pbkdf2_iter=500)
JITTER = Params(pbkdf2_iter=500, jitter=0.2)
# (params, secrets, salts): the JAX package's tests/test_batch.py ragged
# case (:24-35) and jitter case (:340-358; its secrets are ragged too)
CASES = {
    "ragged": (FAST, [b"a", b"bb", b"ccc", b"x" * 40, b"hello world", b"z"],
               [bytes([11 * i + 1]) * 16 for i in range(6)]),
    "jitter": (JITTER, [bytes([70 + i]) * (7 + i) for i in range(6)],
               [bytes([5 * i + 1]) * 16 for i in range(6)]),
}


def _small_covers():
    """tests/test_batch.py's covers fixture: 6 x 128x128 gradient + noise."""
    rng = np.random.default_rng(21)
    base = np.linspace(170, 225, 128)
    imgs = base[None, None, :, None] + rng.integers(-12, 13, (6, 128, 128, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


def _case_stegos(case):
    """(params, covers, secrets, torch result, JAX result) for one case."""
    key = ("case", case)
    if key not in _CACHE:
        p, secrets, salts = CASES[case]
        covers = _small_covers()
        tres = stt.embed_batch(covers, secrets, password="pw", params=p,
                               salts=salts, device="cpu")
        jres = jbatch.embed_batch(covers, secrets, password="pw", params=jp(p),
                                  salts=salts)
        _CACHE[key] = (p, covers, secrets, tres, jres)
    return _CACHE[key]


@pytest.mark.parametrize("case", ["ragged", "jitter"])
def test_case_torch_embed_jax_extract(case):
    p, covers, secrets, tres, jres = _case_stegos(case)
    assert tres.stego.shape == covers.shape
    assert tres.written_bits == jres.written_bits
    assert len(set(tres.written_bits)) > 1  # the unequal-length path
    assert jbatch.extract_batch(tres.stego, password="pw",
                                params=jp(p)) == secrets


@pytest.mark.parametrize("case", ["ragged", "jitter"])
def test_case_jax_embed_torch_extract(case):
    """Unhinted (header probe, then the payload pass) and hinted (one fused
    pass) reads of the JAX package's stegos, and of the port's own."""
    p, _, secrets, tres, jres = _case_stegos(case)
    js = np.asarray(jres.stego)
    longest = max(len(s) for s in secrets)
    for stego in (js, tres.stego):
        assert stt.extract_batch(stego, password="pw", params=p,
                                 device="cpu") == secrets
        assert stt.extract_batch(stego, password="pw", params=p,
                                 clen_hint=longest, device="cpu") == secrets


@pytest.mark.parametrize("case", ["ragged", "jitter"])
def test_case_stego_bytes_match_jax(case):
    _, _, _, tres, jres = _case_stegos(case)
    diff = tres.stego.astype(np.int16) - np.asarray(jres.stego).astype(
        np.int16)
    n = int(np.count_nonzero(diff))
    assert np.abs(diff).max() <= 1
    assert n <= MAX_DIFF_FRAC * diff.size, (n, diff.size)


def test_equal_and_ragged_frames_agree():
    """The unequal-length path (host-built frames) and the equal-length
    path (ECC expanded on the device) write the same frame: a batch made
    ragged only by one extra image leaves the other rows' bytes unchanged
    when the extra image's frame fits the same bucket."""
    covers = _small_covers()[:3]
    salts = [bytes([9 * i + 2]) * 16 for i in range(3)]
    eq = stt.embed_batch(covers, [b"same"] * 3, password="pw", params=FAST,
                         salts=salts, device="cpu")
    rg = stt.embed_batch(covers, [b"same", b"same", b"sam"], password="pw",
                         params=FAST, salts=salts, device="cpu")
    assert eq.written_bits[0] - rg.written_bits[2] == 56
    # same bucket; rows 0 and 1 write identical frames in both batches
    np.testing.assert_array_equal(eq.stego[:2], rg.stego[:2])


def test_verify_resalts_like_jax(monkeypatch):
    """verify=True (tests/test_batch.py:65-97): every image reads back; a
    failure forced on the first read-back is re-embedded with a fresh salt
    and written into the stego in place. verified and the salts come out
    as in the JAX package under the same forced failure."""
    from steganosaurus_tpu.pipeline import batch as jpb
    from steganosaurus_tpu_torch.pipeline import batch as tpb

    covers = _small_covers()[:3]
    secrets = [b"v0", b"v1", b"v2"]
    res = stt.embed_batch(covers, secrets, password="pw", params=FAST,
                          verify=True, device="cpu")
    assert res.verified == [True, True, True]
    assert len(res.salts) == 3 and all(len(s) == 16 for s in res.salts)
    assert jbatch.extract_batch(res.stego, password="pw",
                                params=jp(FAST)) == secrets

    fixed = [bytes([i]) * 16 for i in range(3)]
    outs = {}
    for name, mod in (("torch", tpb), ("jax", jpb)):
        real = mod.extract_batch
        calls = {"n": 0}

        def flaky(*a, _real=real, _calls=calls, **kw):
            out = list(_real(*a, **kw))
            _calls["n"] += 1
            if _calls["n"] == 1:
                out[1] = None
            return out

        monkeypatch.setattr(mod, "extract_batch", flaky)
        kw = {"device": "cpu"} if name == "torch" else {}
        outs[name] = mod.embed_batch(covers, secrets, password="pw",
                                     params=FAST, salts=fixed, verify=True,
                                     **kw)
        monkeypatch.undo()
        assert calls["n"] == 2  # the first read-back, then one retry
    t, j = outs["torch"], outs["jax"]
    assert t.verified == j.verified == [True, True, True]
    for r in (t, j):
        assert r.salts[0] == fixed[0] and r.salts[2] == fixed[2]
        assert r.salts[1] != fixed[1]
    assert isinstance(t.stego, np.ndarray)
    assert jbatch.extract_batch(t.stego, password="pw",
                                params=jp(FAST)) == secrets
    # the re-embedded row is the embed under its new salt, in place
    again = stt.embed_batch(covers, secrets, password="pw", params=FAST,
                            salts=t.salts, device="cpu")
    np.testing.assert_array_equal(t.stego, again.stego)
