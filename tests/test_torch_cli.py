"""The port's `turtlefft` CLI (steganosaurus_tpu_torch/cli.py) on the CPU,
by STEGANOSAURUS_PLATFORM=cpu: the JAX package's batch-mode cases
(tests/test_cli_batch.py), the five checks of scripts/test_hardening.sh
in-process on a tools/gen_png.py host (the script hard-codes bin/turtlefft,
the JAX launcher), `check`'s printed lines equal to the JAX CLI's on the
same cover, secret, key and salt, stegos crossing between the two CLIs both
ways under a passphrase, a raw --key and both wrapped --key formats, and
bin/turtlefft-torch refusing to run without a card or with an unknown
platform."""

import hashlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from steganosaurus_tpu import cli as jcli
from steganosaurus_tpu import crypto as jcrypto
from steganosaurus_tpu.crypto import keywrap as jkw
from steganosaurus_tpu_torch import cli
from steganosaurus_tpu_torch import crypto as tcrypto
from steganosaurus_tpu_torch.io import image as image_io

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
FAST = ["--pbkdf2_iter", "500"]
MK = bytes(range(32))


class _FixedRandom:
    """A deterministic get_random_bytes: SHA-256 of seed || counter."""

    def __init__(self, seed: bytes = b""):
        self.seed, self.n = seed, 0

    def __call__(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(self.seed
                                  + self.n.to_bytes(8, "big")).digest()
            self.n += 1
        return out[:n]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch, request):
    """The CLI on the CPU, and both packages' keys and salts from one
    seeded stream per test: a salt decides whether a Rep-3 header group
    lands on weak cover bins, which the single-image extract (no soft
    header trial, in either package) then misses, so random salts would
    make a test fail now and then."""
    monkeypatch.setenv("STEGANOSAURUS_PLATFORM", "cpu")
    seed = hashlib.sha256(request.node.nodeid.encode()).digest()
    for crypto in (jcrypto, tcrypto):
        monkeypatch.setattr(crypto, "get_random_bytes", _FixedRandom(seed))


def _gradient_png(path, seed, hw=(128, 128)):
    rng = np.random.default_rng(seed)
    base = np.linspace(160, 220, hw[1])[None, :, None]
    img = np.clip(base + rng.integers(-15, 16, (*hw, 3)),
                  0, 255).astype(np.uint8)
    image_io.save_png(str(path), img)
    return path


# --- tests/test_cli_batch.py against the port --------------------------------

@pytest.fixture()
def batch_dirs(tmp_path):
    rng = np.random.default_rng(17)
    in_dir = tmp_path / "covers"
    out_dir = tmp_path / "stego"
    in_dir.mkdir()
    # two sizes: groups must each run as their own batch
    for i, (h, w) in enumerate([(128, 128), (128, 128), (96, 128)]):
        base = np.linspace(160, 220, w)[None, :, None]
        img = np.clip(base + rng.integers(-15, 16, (h, w, 3)),
                      0, 255).astype(np.uint8)
        image_io.save_png(str(in_dir / f"c{i}.png"), img)
    secrets = tmp_path / "secrets.txt"
    secrets.write_text("alpha secret\nbeta secret\ngamma secret\n")
    return in_dir, out_dir, secrets


def test_batch_embed_extract_cli(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    rc = cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
                   "--out-dir", str(out_dir), "--secrets-file", str(secrets),
                   "--pass", "pw", "--verify", "1", *FAST])
    assert rc == 0
    assert capsys.readouterr().out.startswith("Embedded 3/3")
    rc = cli.main(["turtlefft", "batch-extract", "--in-dir", str(out_dir),
                   "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 0
    assert "c0.png\talpha secret" in out
    assert "c1.png\tbeta secret" in out
    assert "c2.png\tgamma secret" in out


def test_batch_extract_failure_isolation(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
              "--out-dir", str(out_dir), "--secrets-file", str(secrets),
              "--pass", "pw", *FAST])
    capsys.readouterr()
    rc = cli.main(["turtlefft", "batch-extract", "--in-dir", str(out_dir),
                   "--pass", "wrong", *FAST])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.count("<FAILED>") == 3


def test_batch_embed_count_mismatch(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    secrets.write_text("only one\n")
    rc = cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
                   "--out-dir", str(out_dir), "--secrets-file", str(secrets),
                   "--pass", "pw", *FAST])
    assert rc == 1


def test_check_mode(tmp_path, capsys):
    """`check`: a dry run reporting capacity, PSNR/SSIM and the warden
    statistics; rc 0 iff the payload fits and round-trips, rc 1 on
    over-capacity; nothing written."""
    cover = _gradient_png(tmp_path / "cover.png", 23)
    rc = cli.main(["turtlefft", "check", "--in", str(cover),
                   "--secret", "dry run", "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 0
    assert "capacity:" in out and "psnr" in out and "chi2_z" in out
    assert "cross-channel: align_z" in out
    assert "joint-residual: coherence" in out
    assert "round-trip: ok" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cover.png"]

    rc = cli.main(["turtlefft", "check", "--in", str(cover),
                   "--secret", "x" * 4000, "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 1 and "check FAILED" in out


def test_cli_pad_flag_roundtrip(tmp_path, capsys):
    """--pad embeds the padded wire mode; extraction needs no flag."""
    cover = _gradient_png(tmp_path / "c.png", 29)
    stego = tmp_path / "s.png"
    rc = cli.main(["turtlefft", "embed", "--in", str(cover), "--out",
                   str(stego), "--secret", "padded cli", "--pass", "pw",
                   "--pad", "32", *FAST])
    assert rc == 0
    capsys.readouterr()
    rc = cli.main(["turtlefft", "extract", "--in", str(stego),
                   "--pass", "pw", *FAST])
    assert rc == 0
    assert capsys.readouterr().out == "padded cli\n"
    # a negative quantum is a usage error (usage text), not a traceback
    assert cli.main(["turtlefft", "embed", "--in", str(cover), "--out",
                     str(stego), "--secret", "x", "--pass", "pw",
                     "--pad", "-1"]) != 0


# --- scripts/test_hardening.sh, in-process ----------------------------------

@pytest.fixture(scope="module")
def host_png(tmp_path_factory):
    """tools/gen_png.py's 256x256 host."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import gen_png
    finally:
        sys.path.remove(str(REPO / "tools"))
    path = tmp_path_factory.mktemp("hardening") / "host.png"
    image_io.save_png(str(path), gen_png.gen_host())
    return path


def _run(argv, capsys):
    rc = cli.main(["turtlefft", *argv])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("check", [1, 2, 3, 4, 5])
def test_hardening_check(check, host_png, tmp_path, capsys):
    """The script's tests 1-5: round trip at the default 600k PBKDF2
    iterations, a long message, a wrong password failing at the magic
    check ("Magic not found"), custom KDF iterations, and the adaptive
    alpha flag (allowed to fail, never to crash)."""
    stego = str(tmp_path / "stego.png")
    msg, pw, extra = {
        1: ("Hello World!", "test123", []),
        2: ("TurtleFFT hardened system with 600k PBKDF2 iterations.",
            "SecurePassword123!", []),
        3: ("Hello World!", "test123", []),
        4: ("Faster test", "test", ["--pbkdf2_iter", "50000"]),
        5: ("Test", "test", ["--pbkdf2_iter", "50000", "--adaptive_alpha",
                             "1"]),
    }[check]
    rc, out, err = _run(["embed", "--in", str(host_png), "--out", stego,
                         "--secret", msg, "--pass", pw, *extra], capsys)
    if check == 5:
        assert rc in (0, 1)
        rc, out, err = _run(["extract", "--in", stego, "--pass", pw,
                             *extra], capsys)
        assert rc in (0, 1)
        return
    assert rc == 0 and out.startswith("Embedded "), (out, err)
    if check == 3:
        rc, out, err = _run(["extract", "--in", stego, "--pass",
                             "WrongPassword"], capsys)
        assert rc != 0 and "Magic not found" in err
        return
    rc, out, err = _run(["extract", "--in", stego, "--pass", pw, *extra],
                        capsys)
    assert rc == 0 and out == msg + "\n"


# --- against the JAX CLI -----------------------------------------------------

_NUM = re.compile(r"-?\d+(?:\.\d+)?")


@pytest.mark.parametrize("fft_dtype", ["complex128", "complex64"])
def test_check_lines_equal_to_jax(fft_dtype, tmp_path, capsys, monkeypatch):
    """`check` prints the same capacity, quality, warden, cross-channel,
    joint-residual and round-trip lines as the JAX CLI on the same cover,
    secret and key, with both packages' salt drawn from the same bytes.
    Under complex128 both embed on the same f64 host backend, so the
    stegos and every line are byte-equal. Under complex64 the port's f32
    write rounds some pixels the other way (+-1) than JAX's, which moves
    the stego's statistics in their last digits: the text and the
    capacity and round-trip lines stay equal, every figure within 1% or
    0.15 absolute (the z-scores print one decimal, so a difference of 0.01
    can print as a step of 0.1)."""
    cover = _gradient_png(tmp_path / "cover.png", 23, hw=(160, 192))
    argv = ["turtlefft", "check", "--in", str(cover), "--secret",
            "the same dry run", "--key", tcrypto.base64_encode(MK),
            "--fft_dtype", fft_dtype, *FAST]
    outs = []
    for pkg, crypto in ((jcli, jcrypto), (cli, tcrypto)):
        monkeypatch.setattr(crypto, "get_random_bytes", _FixedRandom())
        assert pkg.main(list(argv)) == 0
        outs.append(capsys.readouterr().out.splitlines())
    jax_lines, port_lines = outs
    assert len(jax_lines) == 6 and jax_lines[-1] == "round-trip: ok"
    if fft_dtype == "complex128":
        assert port_lines == jax_lines
        return
    assert [port_lines[0], port_lines[-1]] == [jax_lines[0], jax_lines[-1]]
    for pl, jl in zip(port_lines, jax_lines):
        assert _NUM.sub("#", pl) == _NUM.sub("#", jl)
        for p, j in zip(_NUM.findall(pl), _NUM.findall(jl)):
            assert abs(float(p) - float(j)) <= max(0.15, 0.01 * abs(
                float(j))), (pl, jl)


def _key_args(mode: str, tmp_path):
    """(embed/extract argv for the key mode): a passphrase, a raw --key,
    or --key holding a blob wrapped in the main binary's 80-byte format
    (by gen-key --wrap-pass) or in the key tool's 81-byte format."""
    if mode == "pass":
        return ["--pass", "pw"]
    if mode == "raw":
        return ["--key", tcrypto.base64_encode(MK)]
    if mode == "main80":
        key_file = tmp_path / "key.b64"
        assert cli.main(["turtlefft", "gen-key", "--key-out", str(key_file),
                         "--wrap-pass", "wp", *FAST]) == 0
        return ["--key", key_file.read_text().strip(), "--wrap-pass", "wp"]
    blob = jkw.wrap_key_tool(MK, "wp")
    return ["--key", tcrypto.base64_encode(blob), "--wrap-pass", "wp"]


@pytest.mark.parametrize("mode", ["pass", "raw", "main80", "tool81"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stegos_cross_between_the_clis(mode, writer, tmp_path, capsys):
    """One CLI embeds, the other extracts the secret, under each kind of
    key."""
    embedder, extractor = (jcli, cli) if writer == "jax" else (cli, jcli)
    keys = _key_args(mode, tmp_path)
    capsys.readouterr()
    cover = _gradient_png(tmp_path / "c.png", 41, hw=(192, 192))
    stego = str(tmp_path / "s.png")
    secret = f"{writer} -> other, {mode}"
    assert embedder.main(["turtlefft", "embed", "--in", str(cover), "--out",
                          stego, "--secret", secret, *keys, *FAST]) == 0
    assert capsys.readouterr().out.startswith("Embedded ")
    assert extractor.main(["turtlefft", "extract", "--in", stego, *keys,
                           *FAST]) == 0
    assert capsys.readouterr().out == secret + "\n"


# --- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("platform", ["unset", "tpu"])
def test_launcher_refuses_without_card_or_platform(platform, tmp_path):
    """bin/turtlefft-torch with no STEGANOSAURUS_PLATFORM on a machine
    without CUDA exits non-zero with require_cuda's message and writes no
    stego; an unknown platform is a usage error."""
    if torch.cuda.is_available() and platform == "unset":
        pytest.skip("a CUDA card is present")
    cover = _gradient_png(tmp_path / "c.png", 43)
    stego = tmp_path / "s.png"
    env = {k: v for k, v in os.environ.items()
           if k != "STEGANOSAURUS_PLATFORM"}
    if platform != "unset":
        env["STEGANOSAURUS_PLATFORM"] = platform
    out = subprocess.run([str(REPO / "bin" / "turtlefft-torch"), "embed",
                          "--in", str(cover), "--out", str(stego),
                          "--secret", "x", "--pass", "pw", *FAST],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == "" and not stego.exists()
    if platform == "unset":
        assert "CUDA requested but torch.cuda is not available" in out.stderr
    else:
        assert "Bad STEGANOSAURUS_PLATFORM" in out.stderr
        assert "Usage:" in out.stderr
