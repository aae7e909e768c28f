"""Warm single-op 4K serve latency of the PyTorch + CUDA port's worker (the
twin of tools/serve_latency.py, which drives the JAX package's worker).

Starts one `turtlefft serve` worker of the port (bin/turtlefft-torch, on the
CUDA card; --warmup runs the 4K class once before the ready line), then
measures client-side warm p50/p95 for four request classes — PNG embed,
PNG extract, raw-npy embed, raw-npy extract — with every round trip
verified (the extract's secret must equal the embed's). The covers, stegos
and raw tensors live in a temporary directory (TMPDIR). The JSON record
names the card and its power limit (nvidia-smi) beside the numbers.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 tools/serve_latency_torch.py [n_per_class=9] [out.json]

(default out.json: build/serve_latency_torch.json). chip_smoke.py
phase 8b runs measure() at 16 KB through `python -m
steganosaurus_tpu_torch.cli serve`.
"""

import base64
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 2160, 3840
PAYLOAD = 4096
CLASSES = ("embed_png", "extract_png", "embed_raw", "extract_raw")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else ""


def _req(proc, obj):
    proc.stdin.write((json.dumps(obj) + "\n").encode())
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError("worker died")
    return json.loads(line)


def measure(cmd: list, cover: np.ndarray, secret: bytes, n: int,
            workdir: str) -> dict:
    """Start the worker `cmd` (its stdin/stdout carry the JSON lines), wait
    for its ready line, run two unmeasured warm passes of the four classes,
    then n measured rounds, each round trip verified; ask for its stats,
    shut it down and require exit code 0. Returns the record: seconds to
    the ready line, the worker's own warm-up seconds per class (its
    stderr), the worker's stats and the client's p50/p95/min per class in
    seconds. The worker's stderr goes to a file in `workdir` (a pipe
    nobody reads could fill and stall it) and is shown if anything fails;
    the worker is killed then."""
    from steganosaurus_tpu_torch.io import image as image_io

    cover_npy = os.path.join(workdir, "sl_cover.npy")
    stego_npy = os.path.join(workdir, "sl_stego.npy")
    cover_png = os.path.join(workdir, "sl_cover.png")
    stego_png = os.path.join(workdir, "sl_stego.png")
    np.save(cover_npy, cover)
    image_io.save_png(cover_png, cover)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    err_path = os.path.join(workdir, "worker.err")
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err,
                                cwd=str(REPO), env=env)
    try:
        ready = json.loads(proc.stdout.readline() or b"{}")
        ready_s = time.perf_counter() - t0
        if ready.get("op") != "ready":
            raise RuntimeError(f"first line is not the ready line: {ready}")
        if not _req(proc, {"op": "ping"})["ok"]:
            raise RuntimeError("ping failed")
        sb64 = base64.b64encode(secret).decode()
        reqs = {"embed_png": {"op": "embed", "in": cover_png,
                              "out": stego_png, "secret_b64": sb64},
                "extract_png": {"op": "extract", "in": stego_png},
                "embed_raw": {"op": "embed", "in_npy": cover_npy,
                              "out_npy": stego_npy, "secret_b64": sb64},
                "extract_raw": {"op": "extract", "in_npy": stego_npy}}
        lat = {k: [] for k in CLASSES}
        for i in range(2 + n):  # two unmeasured warm passes, then n
            for k in CLASSES:
                t = time.perf_counter()
                r = _req(proc, reqs[k])
                dt = time.perf_counter() - t
                if not r["ok"] or (k.startswith("extract")
                                   and r["secret_b64"] != sb64):
                    raise RuntimeError(f"{k}: {r}")
                if i >= 2:
                    lat[k].append(dt)
        stats = _req(proc, {"op": "stats"})
        _req(proc, {"op": "shutdown"})
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise RuntimeError(f"worker exit code {rc}")
    except Exception as e:
        with open(err_path, errors="replace") as f:
            raise RuntimeError(f"{e}; worker stderr: {f.read()[-4000:]}") \
                from e
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err_path, errors="replace") as f:
        warmed = {m[0]: float(m[1]) for m in
                  re.findall(r"^warmed (\S+) in ([0-9.]+)s$", f.read(), re.M)}
    return {"hw": list(cover.shape[:2]), "payload": len(secret), "n": n,
            "roundtrips_verified": True, "ready_s": ready_s,
            "warmup_s": warmed,
            "worker_stats": stats.get("ops"),
            "client": {k: {"p50": float(np.percentile(v, 50)),
                           "p95": float(np.percentile(v, 95)),
                           "min": float(min(v))}
                       for k, v in lat.items()}}


def main(n: int = 9, out_path: str = "") -> None:
    out_path = out_path or str(REPO / "build" / "serve_latency_torch.json")
    sys.path.insert(0, str(REPO))
    rng = np.random.default_rng(3)
    cover = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    secret = bytes(rng.integers(0, 256, PAYLOAD, dtype=np.uint8))
    cmd = [str(REPO / "bin" / "turtlefft-torch"), "serve", "--pass", "pw",
           "--pbkdf2_iter", "5000", "--warmup", f"{H}x{W}:{PAYLOAD}"]
    with tempfile.TemporaryDirectory(prefix="serve_latency_") as tmp:
        out = measure(cmd, cover, secret, n, tmp)
    out["card"] = card()
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    print(json.dumps(out["client"], indent=1))
    print("wrote", out_path)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 9, *(a[1:] or []))
