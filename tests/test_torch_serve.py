"""The port's `turtlefft serve` worker (steganosaurus_tpu_torch/pipeline/
serve.py) on the CPU: the JAX package's serve cases (tests/test_serve.py)
run against the port's serve_loop with device="cpu" — the JSON-lines
protocol, warm single ops on the batch path at B=1, pipelined batch ops,
learned and explicit clen hints, per-request error isolation, raw-tensor
ingest; the two packages' workers read each other's stegos; a cold worker
process's first stdout line is the ready line (through
tools/serve_latency_torch.py's measure at a small size); and without a
card and without "cpu" the worker refuses to start."""

import base64
import dataclasses
import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from steganosaurus_tpu import crypto as jcrypto
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline.serve import serve_loop as jserve_loop
from steganosaurus_tpu_torch import crypto
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.io import image as image_io
from steganosaurus_tpu_torch.pipeline.serve import serve_loop

torch.set_num_threads(2)


class _FixedRandom:
    """A deterministic get_random_bytes: SHA-256 of seed || counter."""

    def __init__(self, seed: bytes):
        self.seed, self.n = seed, 0

    def __call__(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(self.seed
                                  + self.n.to_bytes(8, "big")).digest()
            self.n += 1
        return out[:n]


@pytest.fixture(autouse=True)
def fixed_salts(monkeypatch, request):
    """Both packages' salts from one seeded stream per test: a salt decides
    whether a Rep-3 header group lands on weak cover bins, which an
    unhinted single extract (extract_array, no soft header trial in either
    package) then misses, so random salts would make a test fail now and
    then."""
    seed = hashlib.sha256(request.node.nodeid.encode()).digest()
    for mod in (jcrypto, crypto):
        monkeypatch.setattr(mod, "get_random_bytes", _FixedRandom(seed))

REPO = pathlib.Path(__file__).resolve().parent.parent
MK = bytes(range(32))
P = Params(pbkdf2_iter=500)
CPU = torch.device("cpu")


def _lines(requests) -> str:
    return "".join(json.dumps(r) + "\n" if isinstance(r, dict) else r + "\n"
                   for r in requests)


def run_serve(requests, params=P, loop=serve_loop, **kw):
    """Feed JSON requests through a serve_loop; return (rc, responses)."""
    stdout = io.StringIO()
    if loop is serve_loop:
        kw.setdefault("device", "cpu")
    else:
        params = JParams(**dataclasses.asdict(params))
    rc = loop(None, MK, params, stdin=io.StringIO(_lines(requests)),
              stdout=stdout, **kw)
    lines = [json.loads(x) for x in stdout.getvalue().splitlines()]
    assert lines[0] == {"ok": True, "op": "ready", **{
        k: lines[0][k] for k in ("pid", "version")}}
    return rc, lines[1:]


def _cover(tmp_path, name, seed=11, hw=(128, 128)):
    rng = np.random.default_rng(seed)
    base = np.linspace(160, 220, hw[1])[None, :, None]
    img = np.clip(base + rng.integers(-15, 16, (*hw, 3)),
                  0, 255).astype(np.uint8)
    p = tmp_path / name
    image_io.save_png(str(p), img)
    return str(p)


def test_ping_unknown_op_bad_json_and_shutdown():
    rc, rs = run_serve([{"op": "ping", "id": 7}, {"op": "nope"},
                        "this is not json", {"op": "shutdown", "id": 9},
                        {"op": "ping"}])  # after shutdown: never processed
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["op"] == "ping" and rs[0]["id"] == 7
    assert not rs[1]["ok"] and "unknown op" in rs[1]["error"]
    assert not rs[2]["ok"]
    assert rs[3] == {"ok": True, "op": "shutdown", "id": 9}
    assert len(rs) == 4  # the loop exited on shutdown


def test_embed_extract_roundtrip_and_binary_secret(tmp_path):
    cov = _cover(tmp_path, "c.png")
    out = str(tmp_path / "s.png")
    blob = bytes([0, 255, 10, 13, 127]) * 4
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "hello serve"},
        {"op": "extract", "in": out, "id": "x1"},
        {"op": "embed", "in": cov, "out": out,
         "secret_b64": base64.b64encode(blob).decode()},
        {"op": "extract", "in": out},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["bits"] > 0 and rs[0]["out"] == out
    assert base64.b64decode(rs[1]["secret_b64"]) == b"hello serve"
    assert rs[1]["id"] == "x1"
    assert base64.b64decode(rs[3]["secret_b64"]) == blob


def test_batch_ops_and_per_item_error_isolation(tmp_path):
    covs = [_cover(tmp_path, f"c{i}.png", seed=20 + i) for i in range(3)]
    outs = [str(tmp_path / f"s{i}.png") for i in range(3)]
    jobs = [{"in": c, "out": o, "secret": f"msg {i}"}
            for i, (c, o) in enumerate(zip(covs, outs))]
    rc, rs = run_serve([
        {"op": "embed_batch", "jobs": jobs, "verify": True},
        {"op": "extract_batch", "ins": outs},
        # a missing input fails ITS item; the worker and peers survive
        {"op": "extract_batch", "ins": [outs[0], str(tmp_path / "no.png")]},
        {"op": "embed_batch", "jobs": []},
        {"op": "embed", "in": covs[0], "out": outs[0]},  # missing secret
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["n_ok"] == 3
    assert all(r["ok"] for r in rs[0]["results"])
    got = [base64.b64decode(r["secret_b64"]) for r in rs[1]["results"]]
    assert got == [f"msg {i}".encode() for i in range(3)]
    assert not rs[2]["ok"] and rs[2]["n_ok"] == 1
    assert rs[2]["results"][0]["ok"] and not rs[2]["results"][1]["ok"]
    assert not rs[3]["ok"] and "non-empty" in rs[3]["error"]
    assert not rs[4]["ok"] and "secret" in rs[4]["error"]


def test_cli_serve_wiring(tmp_path, monkeypatch, capsys):
    """cli.main routes `serve` to the loop (stdin/stdout), key via --key,
    on the CPU by STEGANOSAURUS_PLATFORM."""
    from steganosaurus_tpu_torch import cli

    cov = _cover(tmp_path, "c.png", seed=5)
    out = str(tmp_path / "s.png")
    reqs = [{"op": "embed", "in": cov, "out": out, "secret": "via cli"},
            {"op": "extract", "in": out}, {"op": "shutdown"}]
    monkeypatch.setenv("STEGANOSAURUS_PLATFORM", "cpu")
    monkeypatch.setattr("sys.stdin", io.StringIO(_lines(reqs)))
    rc = cli.main(["turtlefft", "serve", "--key",
                   crypto.base64_encode(MK), "--pbkdf2_iter", "500"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["op"] == "ready"
    assert base64.b64decode(lines[2]["secret_b64"]) == b"via cli"
    assert lines[3]["op"] == "shutdown"


def test_stats_and_latency_fields(tmp_path):
    cov = _cover(tmp_path, "c.png", seed=31)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "t"},
        {"op": "embed", "in": cov, "out": out},  # error: missing secret
        {"op": "extract", "in": out},
        {"op": "stats"},
    ])
    assert rc == 0
    assert all("ms" in r and r["ms"] >= 0 for r in rs)
    st = rs[3]
    assert st["ok"] and st["uptime_s"] >= 0
    emb = st["ops"]["embed"]
    assert emb["n"] == 2 and emb["errors"] == 1 and emb["images"] == 1
    assert emb["ms_p95"] >= emb["ms_p50"] >= 0
    assert st["ops"]["extract"]["n"] == 1
    assert "stats" not in st["ops"]  # the stats op itself reports first


def test_serve_requires_key():
    from steganosaurus_tpu_torch import cli

    assert cli.parse_args(["turtlefft", "serve"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw"]) is not None


def test_serve_warmup_flag_and_ready_field(tmp_path):
    """--warmup HxW runs the shape classes before the ready line; the
    ready response lists them. Parser rejects malformed values."""
    from steganosaurus_tpu_torch import cli

    a = cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                        "--warmup", "64x48", "--warmup", "128X96:4096"])
    assert a.warmup == [(64, 48), (128, 96, 4096)]
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "64"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "axb"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "64x48:big"]) is None

    stdin = io.StringIO(json.dumps({"op": "shutdown"}) + "\n")
    stdout = io.StringIO()
    rc = serve_loop(None, MK, P, stdin=stdin, stdout=stdout,
                    warmup=[(64, 48), (128, 96, 16)], device="cpu")
    assert rc == 0
    ready = json.loads(stdout.getvalue().splitlines()[0])
    assert ready["op"] == "ready"
    assert ready["warmed"] == ["64x48:6", "128x96:16"]


def test_serve_extract_rides_hint_and_survives_stale_hint(tmp_path):
    """Single extracts use the fused one-pass path once a payload size is
    known (learned from embeds/extracts or given as clen_hint); a stale or
    wrong hint falls back to the two-pass path and still decodes."""
    cov = _cover(tmp_path, "c.png")
    out1, out2 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out1, "secret": "short"},
        {"op": "extract", "in": out1},                      # learned hint
        {"op": "embed", "in": cov, "out": out2,
         "secret": "a much longer secret body"},
        {"op": "extract", "in": out1, "clen_hint": 1},
        {"op": "extract", "in": out2},
        {"op": "shutdown"},
    ])
    assert rc == 0
    assert base64.b64decode(rs[1]["secret_b64"]) == b"short"
    assert base64.b64decode(rs[3]["secret_b64"]) == b"short"
    assert base64.b64decode(rs[4]["secret_b64"]) == b"a much longer secret body"


@pytest.mark.parametrize("wire", ["rs", "pad", "qim"])
def test_serve_hinted_extract_composes_with_wire_modes(tmp_path, wire):
    """The learned-clen fused path stays correct under each wire mode (RS
    changes the coded length, padding the wire clen, QIM the read rule)."""
    p = {"rs": Params(pbkdf2_iter=500, rs=True),
         "pad": Params(pbkdf2_iter=500, pad_quantum=64),
         "qim": Params(pbkdf2_iter=500, qim=10)}[wire]
    cov = _cover(tmp_path, "c.png", seed=40, hw=(192, 192))
    out = str(tmp_path / "s.png")
    rc, rs_ = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "wire-mode body"},
        {"op": "extract", "in": out},                 # learned hint
        {"op": "extract", "in": out, "clen_hint": 14},  # explicit
    ], params=p)
    assert rc == 0, rs_
    assert rs_[0]["ok"], rs_[0]
    for r in rs_[1:]:
        assert r["ok"] and base64.b64decode(r["secret_b64"]) == \
            b"wire-mode body", (wire, r)


def test_serve_batch_ops_learn_and_use_hint(tmp_path):
    """embed_batch teaches the worker its payload size; a following
    extract_batch and single extract ride the hint."""
    covs = [_cover(tmp_path, f"c{i}.png", seed=50 + i) for i in range(3)]
    outs = [str(tmp_path / f"s{i}.png") for i in range(3)]
    jobs = [{"in": c, "out": o, "secret": f"msg number {i}"}
            for i, (c, o) in enumerate(zip(covs, outs))]
    rc, rs_ = run_serve([
        {"op": "embed_batch", "jobs": jobs},
        {"op": "extract_batch", "ins": outs},
        {"op": "extract", "in": outs[0]},
    ])
    assert rc == 0
    assert rs_[0]["n_ok"] == 3
    got = [base64.b64decode(r["secret_b64"]).decode()
           for r in rs_[1]["results"]]
    assert got == [f"msg number {i}" for i in range(3)]
    assert base64.b64decode(rs_[2]["secret_b64"]) == b"msg number 0"


def test_serve_cover_dependent_path_class(tmp_path):
    """A worker with cover_dependent_path serves: embed rides the
    single-image path, and extract either round-trips or reports the mode's
    real parity failure ("Magic not found"); never the internal 'use
    embed_array' contract error, and the worker stays alive."""
    p = Params(cover_dependent_path=True, pbkdf2_iter=500)
    cov = _cover(tmp_path, "c.png", seed=60)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "cover-keyed"},
        {"op": "extract", "in": out},            # learned hint is skipped
        {"op": "extract", "in": out, "clen_hint": 11},  # explicit hint too
        {"op": "ping"},
    ], params=p)
    assert rc == 0
    assert rs[0]["ok"], rs[0]
    for r in rs[1:3]:
        if r["ok"]:
            assert base64.b64decode(r["secret_b64"]) == b"cover-keyed", r
        else:
            assert "Magic not found" in r["error"] \
                and "embed_array" not in r["error"], r
    assert rs[3]["ok"] and rs[3]["op"] == "ping"


@pytest.mark.parametrize("hints", [
    [[4096], {"n": 1}, "not-a-number"],   # malformed types
    [0, -5, -4096],                       # non-positive
], ids=["malformed", "nonpositive"])
def test_serve_rejects_bad_hints_and_stays_alive(tmp_path, hints):
    """A non-scalar, non-numeric or non-positive clen_hint gives one
    ok:false reply naming the field, never a dead worker and never a
    dispatch with that hint."""
    cov = _cover(tmp_path, "c.png", seed=61)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "hi"},
        {"op": "extract", "in": out, "clen_hint": hints[0]},
        {"op": "extract_batch", "ins": [out], "clen_hint": hints[1]},
        {"op": "extract", "in": out, "clen_hint": hints[2]},
        {"op": "ping"},
    ])
    assert rc == 0
    for r in rs[1:4]:
        assert not r["ok"] and "clen_hint" in r["error"], r
    assert rs[4]["ok"] and rs[4]["op"] == "ping"


def test_warmup_specs_validated_at_parse_and_runtime():
    """Non-positive --warmup dims are rejected at parse time; a bad spec
    reaching the worker raises StegoError, not a numpy traceback."""
    from steganosaurus_tpu_torch.cli import parse_args
    from steganosaurus_tpu_torch.pipeline.errors import StegoError
    from steganosaurus_tpu_torch.pipeline.serve import _warmup_shape

    for bad in ("-1x64", "0x0", "64x-2", "64x48:0", "64x48:-6"):
        assert parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", bad]) is None, bad
    ok = parse_args(["turtlefft", "serve", "--pass", "pw",
                     "--warmup", "64x48:16"])
    assert ok is not None and ok.warmup == [(64, 48, 16)]
    with pytest.raises(StegoError):
        _warmup_shape(-1, 64, 6, None, MK, P, CPU)


def test_serve_survives_unexpected_runtime_error(tmp_path, monkeypatch,
                                                 capsys):
    """The never-raise contract covers ANY exception type — a CUDA
    RuntimeError becomes one ok:false reply with a stderr traceback, not a
    dead worker."""
    import steganosaurus_tpu_torch.pipeline.serve as serve_mod

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(serve_mod, "_do_embed", boom)
    cov = _cover(tmp_path, "c.png", seed=72)
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": str(tmp_path / "s.png"),
         "secret": "x", "id": 1},
        {"op": "ping", "id": 2},
    ])
    assert rc == 0
    assert not rs[0]["ok"] and "illegal memory access" in rs[0]["error"]
    assert rs[1]["ok"] and rs[1]["op"] == "ping"
    assert "RuntimeError" in capsys.readouterr().err  # operator traceback


def test_serve_embed_batch_duplicate_cover_paths(tmp_path):
    """Two jobs sharing one cover path are distinct jobs."""
    cov = _cover(tmp_path, "c.png", seed=73)
    outs = [str(tmp_path / f"s{i}.png") for i in range(2)]
    rc, rs = run_serve([
        {"op": "embed_batch", "jobs": [
            {"in": cov, "out": outs[0], "secret": "first secret"},
            {"in": cov, "out": outs[1], "secret": "second secret"}]},
        {"op": "extract_batch", "ins": outs},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["n_ok"] == 2
    assert [r["out"] for r in rs[0]["results"]] == outs
    got = [base64.b64decode(r["secret_b64"]) for r in rs[1]["results"]]
    assert got == [b"first secret", b"second secret"]


def test_serve_raw_npy_mode_roundtrip(tmp_path):
    """PNG-free serving: in_npy/out_npy carry raw (H, W, 3) u8 tensors;
    out + out_npy may be combined; malformed npy inputs are rejected."""
    rng = np.random.default_rng(74)
    base = np.linspace(160, 220, 128)[None, :, None]
    cover = np.clip(base + rng.integers(-15, 16, (128, 128, 3)),
                    0, 255).astype(np.uint8)
    cov_npy = str(tmp_path / "c.npy")
    np.save(cov_npy, cover)
    out_npy = str(tmp_path / "s.npy")
    out_png = str(tmp_path / "s.png")
    bad_npy = str(tmp_path / "bad.npy")
    np.save(bad_npy, np.zeros((4, 4), np.float32))
    rc, rs = run_serve([
        {"op": "embed", "in_npy": cov_npy, "out_npy": out_npy,
         "out": out_png, "secret": "raw tensor path"},
        {"op": "extract", "in_npy": out_npy},
        {"op": "extract", "in": out_png},
        {"op": "embed", "in_npy": bad_npy, "out_npy": out_npy,
         "secret": "x"},
        {"op": "embed", "in_npy": cov_npy, "secret": "x"},  # no output
        {"op": "ping"},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["out_npy"] == out_npy \
        and rs[0]["out"] == out_png
    # both encodings carry the identical stego
    assert np.array_equal(np.load(out_npy), image_io.load_rgb(out_png))
    assert base64.b64decode(rs[1]["secret_b64"]) == b"raw tensor path"
    assert base64.b64decode(rs[2]["secret_b64"]) == b"raw tensor path"
    assert not rs[3]["ok"] and "uint8" in rs[3]["error"]
    assert not rs[4]["ok"] and "out" in rs[4]["error"]
    assert rs[5]["ok"]


# --- the two packages' workers, each other's stegos ------------------------

@pytest.mark.parametrize("op", ["single", "batch"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_workers_read_each_others_stegos(tmp_path, writer, op):
    """A stego written by one package's worker (embed at B=1, or
    embed_batch) is read by the other's (extract, or extract_batch)."""
    loops = {"jax": jserve_loop, "port": serve_loop}
    reader = "port" if writer == "jax" else "jax"
    covs = [_cover(tmp_path, f"c{i}.png", seed=80 + i) for i in range(2)]
    outs = [str(tmp_path / f"s{i}.png") for i in range(2)]
    secrets = [f"{writer} wrote {i}" for i in range(2)]
    if op == "single":
        emb = [{"op": "embed", "in": c, "out": o, "secret": s}
               for c, o, s in zip(covs, outs, secrets)]
        ext = [{"op": "extract", "in": o} for o in outs]
    else:
        emb = [{"op": "embed_batch", "jobs": [
            {"in": c, "out": o, "secret": s}
            for c, o, s in zip(covs, outs, secrets)]}]
        ext = [{"op": "extract_batch", "ins": outs}]
    rc, rs = run_serve(emb, loop=loops[writer])
    assert rc == 0 and all(r["ok"] for r in rs), rs
    rc, rs = run_serve(ext, loop=loops[reader])
    assert rc == 0
    items = rs if op == "single" else rs[0]["results"]
    assert [base64.b64decode(r["secret_b64"]).decode() for r in items] \
        == secrets


# --- process level -----------------------------------------------------------

def test_cold_worker_process_first_line_is_ready(tmp_path, monkeypatch):
    """A fresh `python -m steganosaurus_tpu_torch.cli serve` process on the
    CPU (STEGANOSAURUS_PLATFORM=cpu) writes the ready line first, then
    serves the four request classes of tools/serve_latency_torch.py, each
    round trip verified, and exits 0 on shutdown."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import serve_latency_torch as sl
    finally:
        sys.path.remove(str(REPO / "tools"))
    monkeypatch.setenv("STEGANOSAURUS_PLATFORM", "cpu")
    rng = np.random.default_rng(3)
    cover = np.clip(np.linspace(150, 230, 160)[None, :, None]
                    + rng.integers(-20, 21, (128, 160, 3)), 0,
                    255).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 24, dtype=np.uint8))
    cmd = [sys.executable, "-m", "steganosaurus_tpu_torch.cli", "serve",
           "--key", crypto.base64_encode(MK), "--pbkdf2_iter", "500",
           "--warmup", "128x160:24"]
    out = sl.measure(cmd, cover, secret, 1, str(tmp_path))
    assert out["roundtrips_verified"] and out["hw"] == [128, 160]
    assert set(out["client"]) == set(sl.CLASSES)
    assert out["worker_stats"]["embed"]["n"] == 6
    assert out["worker_stats"]["extract"]["errors"] == 0
    assert set(out["warmup_s"]) == {"128x160:24"}


def test_worker_refuses_to_start_without_a_card(monkeypatch):
    """Without CUDA and without device="cpu" the worker raises before the
    ready line; it never runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("STEGANOSAURUS_PLATFORM", raising=False)
    stdout = io.StringIO()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_loop(None, MK, P, stdin=io.StringIO(""), stdout=stdout)
    assert stdout.getvalue() == ""
