"""The port's host modules against their JAX-package twins, and the port's
independence from the JAX package.

steganosaurus_tpu_torch carries its own copies of config, crypto,
keystream, _native_loader, ops/rs, io/image, utils/debug and the numpy
metrics, at the paths that mirror the JAX package. Each copy is held against
its twin on the same numpy-seeded inputs, with the native library and with
the pure-Python paths (STEGANOSAURUS_NO_NATIVE=1): Params are equal field
for field, keys (the cover-hash path key too), AEAD output, walks (the
coherent walks too) and RS codewords byte- or array-equal, PNG bytes and
debug dumps equal, the metrics equal to 1e-12. Then the port runs batch and
single-image round trips with steganosaurus_tpu and jax blocked from
import (every name of its lazy API resolving there), and no module of the
port, nor chip_smoke.py or its tools, names the JAX package in an import;
every name of the JAX package's lazy API resolves in the port, and the
port's launchers run the port's CLI and key tool.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from steganosaurus_tpu import config as jconfig
from steganosaurus_tpu import crypto as jcrypto
from steganosaurus_tpu import keystream as jkeystream
from steganosaurus_tpu.io import image as jimage
from steganosaurus_tpu.ops import rs as jrs
from steganosaurus_tpu.utils import debug as jdebug
from steganosaurus_tpu.utils import metrics as jmetrics
from steganosaurus_tpu_torch import _build
from steganosaurus_tpu_torch import config as tconfig
from steganosaurus_tpu_torch import crypto as tcrypto
from steganosaurus_tpu_torch import keystream as tkeystream
from steganosaurus_tpu_torch.io import image as timage
from steganosaurus_tpu_torch.ops import rs as trs
from steganosaurus_tpu_torch.utils import debug as tdebug
from steganosaurus_tpu_torch.utils import metrics as tmetrics

REPO = pathlib.Path(__file__).resolve().parent.parent
BACKENDS = ["native", "pure"]


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """Both packages on their native library, or both on pure Python; the
    walk disk cache off, so every walk is expanded here."""
    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", "0")
    if request.param == "native":
        _build.ensure_native()
    else:
        monkeypatch.setenv("STEGANOSAURUS_NO_NATIVE", "1")
    return request.param


def _bytes(rng, n):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


# --- config ------------------------------------------------------------------

@pytest.mark.parametrize("preset", [
    lambda P: P(),
    lambda P: P.stealth(),
    lambda P: P.stealth(per_image_walk=False, qim=0),
    lambda P: P(rs=True, pad_quantum=4096).replace(jitter=0.2),
])
def test_params_equal(preset):
    assert ([f.name for f in dataclasses.fields(tconfig.Params)]
            == [f.name for f in dataclasses.fields(jconfig.Params)])
    t, j = preset(tconfig.Params), preset(jconfig.Params)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# --- crypto ------------------------------------------------------------------

def test_derived_keys_byte_equal(backend):
    rng = np.random.default_rng(1)
    mk, salt = _bytes(rng, 32), _bytes(rng, 16)
    for args in (("pw", None), (None, mk), ("pw", None, salt * 2),
                 (None, mk, bytes(32))):
        assert tcrypto.derive_path_key(*args) == jcrypto.derive_path_key(
            *args)
    for args in (("pw", None), (None, mk)):
        pk = tcrypto.derive_path_key(*args)
        assert pk == jcrypto.derive_path_key(*args)
        assert tcrypto.derive_path_key(*args, None) == pk
    assert tcrypto.derive_turtle_keys(pk) == jcrypto.derive_turtle_keys(pk)
    for name in ("derive_alpha_spread_key", "derive_qim_key"):
        assert getattr(tcrypto, name)(pk) == getattr(jcrypto, name)(pk)
    assert (tcrypto.derive_salt_path_key(pk, salt)
            == jcrypto.derive_salt_path_key(pk, salt))
    for n in (1, 32, 77, 8160):
        assert (tcrypto.hkdf_expand(pk, b"info", n)
                == jcrypto.hkdf_expand(pk, b"info", n))
    assert len(tcrypto.get_random_bytes(16)) == 16


@pytest.mark.parametrize("password,master", [("pw", None),
                                             (None, bytes(range(32)))])
def test_vault_seal_open_byte_equal(backend, password, master):
    """derive_keys_vault: the same nonce, ciphertext, tag and HKDF export;
    each package opens the other's seal and rejects a flipped tag."""
    rng = np.random.default_rng(2)
    salt, aad, pt = _bytes(rng, 16), _bytes(rng, 38), _bytes(rng, 300)
    with tcrypto.derive_keys_vault(password, master, salt=salt,
                                   iters=50) as tk, \
            jcrypto.derive_keys_vault(password, master, salt=salt,
                                      iters=50) as jk:
        if backend == "native":
            assert isinstance(tk, tcrypto.VaultedKeys)
        else:
            assert isinstance(tk, tcrypto._FallbackKeys)
        assert (tk.nonce, tk.salt) == (jk.nonce, jk.salt)
        ct, tag = tk.seal(aad, pt)
        assert (ct, tag) == jk.seal(aad, pt)
        assert jk.open(aad, ct, tag) == pt == tk.open(aad, ct, tag)
        bad = bytes([tag[0] ^ 1]) + tag[1:]
        assert tk.open(aad, ct, bad) is None
        assert tk.hkdf_expand(b"pad", 100) == jk.hkdf_expand(b"pad", 100)


@pytest.mark.parametrize("ref_compat", [True, False])
def test_aead_byte_equal(backend, ref_compat):
    rng = np.random.default_rng(3)
    key, nonce = _bytes(rng, 32), _bytes(rng, 12)
    for n in (0, 1, 64, 1000):
        aad, pt = _bytes(rng, 17), _bytes(rng, n)
        out = tcrypto.aead_seal(key, nonce, aad, pt, ref_compat)
        assert out == jcrypto.aead_seal(key, nonce, aad, pt, ref_compat)
        assert tcrypto.aead_open(key, nonce, aad, *out, ref_compat) == pt
        assert tcrypto.aead_open(key, nonce, aad + b"x", *out,
                                 ref_compat) is None


# --- keystream ---------------------------------------------------------------

H, W = 64, 96


def _walk_keys(seed):
    pk = tcrypto.derive_path_key(None, bytes([seed]) * 32)
    wk, r, g, b = tcrypto.derive_turtle_keys(pk)
    return wk, (r, g, b)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_turtle_walks_array_equal(backend, jitter):
    wk, pks = _walk_keys(4 if jitter else 5)
    args = (wk, pks, H, W, 0.05, 0.45, 0.7, jitter)
    for nbits in (300, 700):  # the second grows the cached walk
        t = tkeystream.turtle_expand(*args, nbits)
        j = jkeystream.turtle_expand(*args, nbits)
        assert len(t) == len(j) == 4
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    t = tkeystream.turtle_expand(*args, 200, allow_short=True)
    j = jkeystream.turtle_expand(*args, 200, allow_short=True)
    assert t[4] == j[4] == 200
    for a, b in zip(t[:4], j[:4]):
        np.testing.assert_array_equal(a, b)


def test_chained_walks_array_equal(backend):
    wk, pks = _walk_keys(6)
    hdr_t = tkeystream.header_walk_with_visited(wk, pks, H, W, 0.05, 0.45,
                                                0.7, 0.2, 912)
    hdr_j = jkeystream.header_walk_with_visited(wk, pks, H, W, 0.05, 0.45,
                                                0.7, 0.2, 912)
    for a, b in zip(hdr_t, hdr_j):
        np.testing.assert_array_equal(a, b)
    swk, spk = _walk_keys(7)
    for short in (False, True):
        t = tkeystream.turtle_expand_chained(swk, spk, H, W, 0.05, 0.45,
                                             0.7, 0.2, 300, hdr_t[4],
                                             allow_short=short)
        j = jkeystream.turtle_expand_chained(swk, spk, H, W, 0.05, 0.45,
                                             0.7, 0.2, 300, hdr_j[4],
                                             allow_short=short)
        assert len(t) == len(j) == (5 if short else 4)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_coherent_walks_array_equal(backend):
    """The coherent header prefix (sites consumed whole) and a coherent
    payload walk chained from it, native and pure, equal JAX's; the
    coherent prefix differs from the standard one."""
    wk, pks = _walk_keys(8)
    h, w = 128, 160  # room for 912 whole sites and a chained payload
    args = (wk, pks, h, w, 0.05, 0.45, 0.7, 0.1, 912)
    hdr_t = tkeystream.header_walk_with_visited(*args, coherent=True)
    hdr_j = jkeystream.header_walk_with_visited(*args, coherent=True)
    for a, b in zip(hdr_t, hdr_j):
        np.testing.assert_array_equal(a, b)
    std = tkeystream.header_walk_with_visited(*args)
    assert not np.array_equal(std[4], hdr_t[4])
    sites = set(zip(hdr_t[1].tolist(), hdr_t[2].tolist()))
    assert len(sites) == 912  # one bit per whole (y, x) site
    swk, spk = _walk_keys(9)
    for short in (False, True):
        t = tkeystream.turtle_expand_chained(swk, spk, h, w, 0.05, 0.45,
                                             0.7, 0.1, 400, hdr_t[4],
                                             allow_short=short, coherent=True)
        j = jkeystream.turtle_expand_chained(swk, spk, h, w, 0.05, 0.45,
                                             0.7, 0.1, 400, hdr_j[4],
                                             allow_short=short, coherent=True)
        assert len(t) == len(j) == (5 if short else 4)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_signed_unit_offsets_equal():
    key = bytes(range(32))
    for n in (1, 17, 5000):
        t = tkeystream.signed_unit_offsets(key, n)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, jkeystream.signed_unit_offsets(key,
                                                                        n))
    assert tkeystream.ks_stream_bytes(key, 100) == jkeystream.ks_stream_bytes(
        key, 100)


# --- RS ----------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 100, 223, 500, 1000])
def test_rs_byte_equal(backend, m):
    """Encode, hard decode and soft (errors-and-erasures) decode with
    planted byte errors: within t per codeword, past t for the hard
    decoder but with low confidences that the erasure ladder uses."""
    rng = np.random.default_rng(m)
    msg = _bytes(rng, m)
    coded = trs.rs_encode_interleaved(msg)
    assert coded == jrs.rs_encode_interleaved(msg)
    assert len(coded) == trs.coded_len(m) == jrs.coded_len(m)
    arr = np.frombuffer(coded, np.uint8).copy()
    nb = trs.n_blocks(m)
    for n_err in (10 * nb, 20 * nb):
        bad = arr.copy()
        pos = rng.choice(arr.size, size=min(n_err, arr.size), replace=False)
        bad[pos] ^= rng.integers(1, 256, pos.size).astype(np.uint8)
        t = trs.rs_decode_interleaved(bad.tobytes(), m)
        assert t == jrs.rs_decode_interleaved(bad.tobytes(), m)
        conf = rng.random(arr.size) + 1.0
        conf[pos] = rng.random(pos.size) * 0.5
        ts = trs.rs_decode_interleaved_soft(bad, m, conf)
        assert ts == jrs.rs_decode_interleaved_soft(bad, m, conf)
        if n_err <= 16 * nb:
            assert t == (msg, True, pos.size)
        assert ts == (msg, True)


# --- image I/O and metrics ----------------------------------------------------

def test_load_rgb_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    fast = tmp_path / "fast.png"
    jimage.save_png(str(fast), img)  # the fast-decode subset
    rgba = tmp_path / "rgba.png"
    Image.fromarray(np.dstack([img, img[..., :1]]), "RGBA").save(rgba)
    gray = tmp_path / "gray.png"
    Image.fromarray(img[..., 0], "L").save(gray)
    for path in (fast, rgba, gray):
        t = timage.load_rgb(str(path))
        assert t.dtype == np.uint8 and t.shape == (37, 53, 3)
        np.testing.assert_array_equal(t, jimage.load_rgb(str(path)))
    np.testing.assert_array_equal(timage.load_rgb(str(fast)), img)


def test_encode_and_save_png_byte_equal(tmp_path):
    rng = np.random.default_rng(11)
    for shape in ((37, 53, 3), (1, 1, 3), (64, 128, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = timage.encode_png(img)
        assert data == jimage.encode_png(img)
        path = tmp_path / f"{shape[0]}.png"
        timage.save_png(str(path), img)
        assert path.read_bytes() == data
        np.testing.assert_array_equal(jimage.load_rgb(str(path)), img)
    with pytest.raises(ValueError):
        timage.encode_png(np.zeros((4, 4), np.uint8))


def test_debug_dumps_equal(monkeypatch, capsys):
    walk = (np.arange(12) % 3, np.arange(12) + 5, np.arange(12) * 2)
    for env in ("", "0", "1"):
        monkeypatch.setenv("STEGANOSAURUS_DEBUG", env)
        outs = []
        for mod in (tdebug, jdebug):
            assert mod.enabled() == (env == "1")
            mod.dump_dims("embed", 4, 5, 4, 5)
            mod.dump_key_prefix("key", bytes(range(16)))
            mod.dump_walk("embed", *walk)
            mod.dump_header("hdr", b"FTTG\x02")
            mod.log("done")
            outs.append(capsys.readouterr().err)
        assert outs[0] == outs[1]
        assert (outs[0].count("[DEBUG]") == 14) == (env == "1")
    assert tdebug.N_BITS_TO_DUMP == jdebug.N_BITS_TO_DUMP


def test_metrics_equal():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 256, (2, 67, 45, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0,
                255).astype(np.uint8)
    for x, y in ((a[0], b[0]), (a, b), (a[0, ..., 0], b[0, ..., 0])):
        assert abs(tmetrics.psnr(x, y) - jmetrics.psnr(x, y)) <= 1e-12
        if x.ndim <= 3:
            assert abs(tmetrics.ssim(x, y) - jmetrics.ssim(x, y)) <= 1e-12
    assert tmetrics.psnr(a, a) == float("inf")
    s, r = rng.integers(0, 2, 999), rng.integers(0, 2, 1200)
    assert abs(tmetrics.ber(s, r) - jmetrics.ber(s, r)) <= 1e-12
    assert tmetrics.ber([], []) == 0.0


# --- independence ------------------------------------------------------------

def test_round_trip_with_jax_package_blocked():
    """A 128x128 B=2 embed -> extract, the same over a 2-shard mesh, then
    single-image round trips at 256x256 (default, coherent, the f64
    backend), on the CPU in a fresh interpreter where importing
    steganosaurus_tpu or jax raises."""
    code = """
import sys
sys.modules["steganosaurus_tpu"] = None
sys.modules["jax"] = None
import numpy as np
import torch
import steganosaurus_tpu_torch as stt
import steganosaurus_tpu_torch.pipeline.stream
import steganosaurus_tpu_torch.utils.metrics
import steganosaurus_tpu_torch.cli
import steganosaurus_tpu_torch.keytool
import steganosaurus_tpu_torch.pipeline.serve
import steganosaurus_tpu_torch.utils.cost
from steganosaurus_tpu_torch import parallel
for name in stt._API:
    getattr(stt, name)
torch.set_num_threads(2)
rng = np.random.default_rng(0)
imgs = rng.integers(90, 170, (2, 128, 128, 3), dtype=np.uint8)
secrets = [b"first", b"second!"]
p = stt.Params(pbkdf2_iter=500)
res = stt.embed_batch(imgs, secrets, password="pw", params=p, device="cpu")
got = stt.extract_batch(res.stego, password="pw", params=p, device="cpu")
assert got == secrets, got
mesh = parallel.make_mesh(2, device="cpu")
res = stt.embed_batch(imgs, secrets, password="pw", params=p, mesh=mesh,
                      device_resident=True)
got += stt.extract_batch(res.stego, password="pw", params=p)
assert got == secrets * 2, got
img = rng.integers(90, 170, (256, 256, 3), dtype=np.uint8)
for q in (p, p.replace(coherent=True), p.replace(fft_dtype="complex128")):
    one = stt.embed_array(img, b"single", password="pw", params=q,
                          salt=bytes([1]) * 16, device="cpu")
    assert stt.extract_array(one.stego, password="pw", params=q,
                             device="cpu") == b"single"
    got.append(b"single")
print("recovered", len(got))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["recovered", "7"], out.stdout


def _port_sources():
    files = sorted((REPO / "steganosaurus_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py",
                    REPO / "tools" / "time_wrong_key_batch.py",
                    REPO / "tools" / "serve_latency_torch.py",
                    REPO / "tools" / "mesh_cards_torch.py",
                    REPO / "tools" / "k3_ablation_torch.py",
                    REPO / "tools" / "k4_ablation_torch.py",
                    REPO / "tools" / "band_ber_torch.py",
                    REPO / "tools" / "k1_ablation_torch.py",
                    REPO / "tools" / "k2_ablation_torch.py",
                    REPO / "tools" / "k6_ablation_torch.py",
                    REPO / "tools" / "k5_ablation_torch.py",
                    REPO / "tools" / "parent_kernels_torch.py"]


def test_launchers_run_the_ports_modules():
    """bin/turtlefft-torch and bin/turtlefft-key-torch run the port's cli
    and keytool (whose imports the AST test below checks), and the JAX
    package's launchers still run the JAX package's."""
    for name, mod in (("turtlefft-torch", "steganosaurus_tpu_torch.cli"),
                      ("turtlefft-key-torch",
                       "steganosaurus_tpu_torch.keytool"),
                      ("turtlefft", "steganosaurus_tpu.cli"),
                      ("turtlefft-key", "steganosaurus_tpu.keytool")):
        text = (REPO / "bin" / name).read_text()
        assert f"python3 -m {mod} " in text, name
        assert os.access(REPO / "bin" / name, os.X_OK), name


def test_every_jax_api_name_resolves_in_the_port():
    """Every name of the JAX package's lazy top-level API resolves in the
    port, to an object of the port."""
    import steganosaurus_tpu as jst
    import steganosaurus_tpu_torch as stt

    assert set(jst._API) <= set(stt._API)
    for name in jst._API:
        obj = getattr(stt, name)
        assert obj.__module__.startswith("steganosaurus_tpu_torch."), name


def test_no_port_module_imports_the_jax_package():
    bad = []
    files = _port_sources()
    assert len(files) > 20
    names = {str(f.relative_to(REPO)) for f in files}
    assert "tools/serve_latency_torch.py" in names
    for mod in ("ops/phase.py", "ops/stats.py", "ops/mask.py",
                "pipeline/device.py", "pipeline/embed.py",
                "pipeline/extract.py", "pipeline/frame.py",
                "pipeline/serve.py", "utils/covers.py", "utils/debug.py",
                "parallel/batch.py", "parallel/fft_dist.py", "utils/cost.py",
                "utils/steganalysis.py", "utils/channel.py",
                "crypto/keywrap.py", "cli.py", "keytool.py",
                "graft_entry.py", "spectral/corner.py",
                "spectral/write_kernels.py"):
        assert f"steganosaurus_tpu_torch/{mod}" in names
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("steganosaurus_tpu", "jax", "jaxlib"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, bad
