"""The port's key handling against the JAX package's: the crypto helpers
the CLIs use (base64, fingerprint, constant-time compare, wipe), both
wrapped-key formats (the 80-byte main-binary TFKW and the 81-byte key-tool
TFKW-v1), `decode_or_unwrap_key`, and the `turtlefft-key` tool's stdout,
stderr, files and exit codes in every mode and error path. With the CSPRNG
patched to the same bytes in both packages, every blob and key file is
byte-equal; with the real CSPRNG each package unwraps the other's blobs.
Host code only: nothing here touches a device."""

import hashlib

import numpy as np
import pytest

from steganosaurus_tpu import crypto as jcrypto
from steganosaurus_tpu import keytool as jkeytool
from steganosaurus_tpu.crypto import keywrap as jkw
from steganosaurus_tpu_torch import crypto as tcrypto
from steganosaurus_tpu_torch import keytool as tkeytool
from steganosaurus_tpu_torch.crypto import keywrap as tkw

MK = bytes(range(32))
ITERS = 500  # the main format's PBKDF2 count (the tool format fixes 200k)


class _FixedRandom:
    """A deterministic get_random_bytes: SHA-256 in counter mode."""

    def __init__(self, seed: bytes = b"fixed"):
        self.seed, self.n = seed, 0

    def __call__(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(self.seed + self.n.to_bytes(8, "big")).digest()
            self.n += 1
        return out[:n]


@pytest.fixture
def fixed_random(monkeypatch):
    """Patches both packages' CSPRNG; call the returned function to restart
    both on the same byte stream."""
    def reset(seed: bytes = b"fixed"):
        monkeypatch.setattr(jcrypto, "get_random_bytes", _FixedRandom(seed))
        monkeypatch.setattr(tcrypto, "get_random_bytes", _FixedRandom(seed))
    reset()
    return reset


# --- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "AAECAwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8=",
    "  AAEC\nAwQF\tBgc= ", "not base64!!", "", "QUJD", "QUJ",
])
def test_base64_decode_equal(text):
    assert tcrypto.base64_decode(text) == jcrypto.base64_decode(text)


@pytest.mark.parametrize("data", [b"", MK, bytes(81), b"\xff" * 5])
def test_base64_encode_and_fingerprint_equal(data):
    assert tcrypto.base64_encode(data) == jcrypto.base64_encode(data)
    assert tcrypto.key_fingerprint(data) == jcrypto.key_fingerprint(data)
    for other in (data, data + b"x", bytes(len(data))):
        assert (tcrypto.constant_time_compare(data, other)
                == jcrypto.constant_time_compare(data, other))


@pytest.mark.parametrize("kind", ["bytearray", "memoryview", "ndarray",
                                  "bytes"])
def test_secure_zero_equal(kind):
    def make():
        if kind == "bytearray":
            return bytearray(MK)
        if kind == "memoryview":
            return memoryview(bytearray(MK))
        if kind == "ndarray":
            return np.frombuffer(MK, np.uint8).copy()
        return bytes(MK)

    outs = []
    for pkg in (jcrypto, tcrypto):
        buf = make()
        try:
            pkg.secure_zero(buf)
            outs.append(bytes(buf))
        except TypeError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    assert outs[0] == (bytes(32) if kind != "bytes" else outs[0])


# --- wrapped-key formats -----------------------------------------------------

def _wrap(kw, fmt, key, pw):
    return (kw.wrap_key_main(key, pw, ITERS) if fmt == "main"
            else kw.wrap_key_tool(key, pw))


def _unwrap(kw, fmt, blob, pw):
    return (kw.unwrap_key_main(blob, pw, ITERS) if fmt == "main"
            else kw.unwrap_key_tool(blob, pw))


@pytest.mark.parametrize("fmt", ["main", "tool"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_unwraps_the_others_blobs(fmt, writer):
    w, r = (jkw, tkw) if writer == "jax" else (tkw, jkw)
    blob = _wrap(w, fmt, MK, "wrap pw")
    assert len(blob) == (80 if fmt == "main" else 81)
    assert _unwrap(r, fmt, blob, "wrap pw") == MK
    assert _unwrap(r, fmt, blob, "wrong") is None
    assert r.decode_or_unwrap_key(tcrypto.base64_encode(blob), "wrap pw",
                                  ITERS) == MK


@pytest.mark.parametrize("fmt", ["main", "tool"])
def test_blobs_byte_equal_under_fixed_randomness(fixed_random, fmt):
    fixed_random()
    jblob = _wrap(jkw, fmt, MK, "wrap pw")
    fixed_random()
    tblob = _wrap(tkw, fmt, MK, "wrap pw")
    assert tblob == jblob
    fixed_random(b"other")
    assert _wrap(tkw, fmt, MK, "wrap pw") != jblob


@pytest.mark.parametrize("case", ["raw32", "main80", "tool81", "wrong_pass",
                                  "no_pass", "garbage", "bad_len",
                                  "empty"])
def test_decode_or_unwrap_key_equal(case):
    pw = "wrap pw"
    text = {
        "raw32": tcrypto.base64_encode(MK),
        "main80": tcrypto.base64_encode(tkw.wrap_key_main(MK, pw, ITERS)),
        "tool81": tcrypto.base64_encode(tkw.wrap_key_tool(MK, pw)),
        "wrong_pass": tcrypto.base64_encode(tkw.wrap_key_main(MK, pw, ITERS)),
        "no_pass": tcrypto.base64_encode(tkw.wrap_key_tool(MK, pw)),
        "garbage": "%%% not a key %%%",
        "bad_len": tcrypto.base64_encode(bytes(31)),
        "empty": "",
    }[case]
    use = {"wrong_pass": "nope", "no_pass": ""}.get(case, pw)
    got = tkw.decode_or_unwrap_key(text, use, ITERS)
    assert got == jkw.decode_or_unwrap_key(text, use, ITERS)
    assert got == (MK if case in ("raw32", "main80", "tool81") else None)


# --- turtlefft-key -----------------------------------------------------------

KEYTOOL_CASES = [
    ["--gen-key"], ["--gen-key", "--hex"], ["--gen-key", "--key-out", "{k}"],
    ["--gen-key", "--wrap", "pw"], ["--gen-key", "--wrap", "pw",
                                    "--key-out", "{k}"],
    ["--unwrap", "{w}", "--pass", "pw"],
    ["--unwrap", "{w}", "--pass", "pw", "--hex"],
    ["--unwrap", "{w}", "--pass", "pw", "--key-out", "{k}"],
    ["--unwrap", "{w}", "--pass", "wrong"], ["--unwrap", "{w}"],
    ["--unwrap"], ["--export-hex", "{r}"],
    ["--export-hex", "{w}", "--pass", "pw"], ["--export-hex", "{w}"],
    ["--export-hex", "{w}", "--pass", "wrong"], ["--export-hex", "{b}"],
    ["--export-hex"], ["--help"], ["-h"], ["--bogus"], [], ["--hex"],
]


@pytest.mark.parametrize("argv", KEYTOOL_CASES,
                         ids=[" ".join(a) or "none" for a in KEYTOOL_CASES])
def test_keytool_matches_jax(argv, tmp_path, capsys, fixed_random):
    """Both tools on the same argv, files and random bytes: the same
    stdout, stderr, exit code and key file."""
    fixed_random()
    paths = {"k": tmp_path / "key.out", "w": tmp_path / "wrapped.bin",
             "r": tmp_path / "raw.bin", "b": tmp_path / "bad.bin"}
    paths["w"].write_bytes(jkw.wrap_key_tool(MK, "pw"))
    paths["r"].write_bytes(MK)
    paths["b"].write_bytes(bytes(40))
    args = ["turtlefft-key"] + [a.format(**paths) for a in argv]
    runs = []
    for tool in (jkeytool, tkeytool):
        fixed_random()
        paths["k"].unlink(missing_ok=True)
        rc = tool.main(list(args))
        out, err = capsys.readouterr()
        key_file = paths["k"].read_bytes() if paths["k"].exists() else None
        runs.append((rc, out, err, key_file))
    assert runs[1] == runs[0]
    assert runs[0][0] in (0, 1)
