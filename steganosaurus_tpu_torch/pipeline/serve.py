"""`turtlefft serve` — a long-running steady-state serving worker (the port's
twin of steganosaurus_tpu/pipeline/serve.py, with the same protocol,
routing and replies; tests/test_torch_serve.py runs the JAX package's serve
cases against it).

The worker's warm state is process-level: walk expansions (keystream prefix
cache + disk cache), derived keys (native key vault), DFT tables and cuFFT
plans, and the loaded K1 library (spectral/corner_kernels.py). A one-shot
CLI call pays all of it per image; this daemon pays it once and then serves
requests at steady-state cost.

No reference counterpart (the reference binary is strictly one-shot,
steganosaur.cpp:879-1313 main dispatch); rebuild-only surface.

Protocol: JSON lines on stdin, one JSON line per response on stdout
(stderr is free-form logging; nothing else is ever written to stdout: the
kernel and native builds capture their compilers' output). The key, the
Params and the device are fixed at startup — that is what makes the caches
coherent; run one worker per (key, params) serving class. Requests:

  {"op": "ping"}
  {"op": "embed",   "in": P, "out": P2, "secret": S | "secret_b64": B}
  {"op": "extract", "in": P2}
  (raw-tensor mode: "in_npy"/"out_npy" — (H, W, 3) uint8 .npy paths —
   replace "in"/"out" on the single ops; callers that already hold
   pixels write the .npy to /dev/shm and skip the PNG codec entirely.
   "out" and "out_npy" may be given together to get both encodings.)
  {"op": "embed_batch",   "jobs": [{"in":..., "out":...,
                                    "secret"|"secret_b64":...}, ...]}
  {"op": "extract_batch", "ins": [P, ...] [, "clen_hint": N]}
  {"op": "stats"}
  {"op": "shutdown"}

Routing (the JAX package's): a single embed rides embed_batch at B=1 (the
corner path, K1 at 3 planes), except cover-dependent walks, which go
through embed_array; a single extract tries the hinted one-pass
extract_batch first and falls back to extract_array; the batch ops run the
embed_stream / extract_stream pipeline in batches of 32 (K1 at up to 96
planes).

Observability: every response carries "ms" (request wall time); "stats"
returns uptime and per-op {n, errors, images, ms_p50, ms_p95, ms_max}
over a bounded window (last 512 latencies per op).

Every request may carry an "id"; it is echoed in the response. Responses
are {"ok": true, "op": ..., ...} or {"ok": false, "error": "..."}; batch
ops return per-item "results" arrays and ok=true iff every item
succeeded. Extracted secrets are returned base64 ("secret_b64") — they
are bytes, not necessarily text.

Errors: no request can kill the worker. A CUDA error surfaces as a
RuntimeError from torch and becomes an {"ok": false} reply with a traceback
on stderr, like any unexpected exception. A sticky CUDA error (an illegal
memory access, a device-side assert) leaves the CUDA context unusable, so
every later request on the device fails the same way: the replies say so,
and the operator restarts the worker.
"""

from __future__ import annotations

import base64
import json
import sys

import numpy as np
import torch

from steganosaurus_tpu_torch.pipeline.errors import StegoError

BATCH = 32  # images per device batch on the batch ops


def _secret_of(req: dict) -> bytes:
    if "secret_b64" in req:
        return base64.b64decode(req["secret_b64"])
    s = req.get("secret")
    if s is None:
        raise StegoError("embed request needs 'secret' or 'secret_b64'")
    return s.encode() if isinstance(s, str) else bytes(s)


def _load(path: str):
    from steganosaurus_tpu_torch.io import image as image_io

    try:
        return image_io.load_rgb(path)
    except Exception as e:
        raise StegoError(f"Failed to load {path}") from e


def _load_npy(path: str):
    """Raw-tensor ingest: an (H, W, 3) uint8 .npy file (callers that
    already hold pixels write one to /dev/shm — a memcpy, not a codec)."""
    try:
        arr = np.load(path)
    except Exception as e:
        raise StegoError(f"Failed to load npy {path}") from e
    if not (isinstance(arr, np.ndarray) and arr.dtype == np.uint8
            and arr.ndim == 3 and arr.shape[2] == 3):
        raise StegoError(
            f"npy {path} must be (H, W, 3) uint8, got "
            f"{getattr(arr, 'dtype', '?')} {getattr(arr, 'shape', '?')}")
    return arr


def _load_req(req: dict):
    """Resolve a request's input image: 'in_npy' (raw tensor) wins over
    'in' (any PIL-supported image file)."""
    if req.get("in_npy"):
        return _load_npy(req["in_npy"])
    if req.get("in"):
        return _load(req["in"])
    raise StegoError("request needs 'in' or 'in_npy'")


def _clen_of(secret_len: int, params) -> int:
    """On-wire ciphertext length for a secret of this size under the
    worker's params (the padded length when pad_quantum is on)."""
    from steganosaurus_tpu_torch.pipeline import header as header_mod

    if params.pad_quantum:
        return header_mod.padded_len(secret_len, params.pad_quantum)
    return secret_len


def _embed_one(cover, secret: bytes, password, mk, params, dev,
               verify: bool) -> tuple[np.ndarray, int, int]:
    """(stego, written bits, payload bytes) of one image, routed as the JAX
    worker routes it: cover-dependent walks are per image by contract (the
    batch path rejects them), so that class rides embed_array; every other
    class rides embed_batch at B=1 (the corner path), with the same salting,
    framing and write rule as the single-image path."""
    if params.cover_dependent_path:
        from steganosaurus_tpu_torch.pipeline.embed import embed_array
        from steganosaurus_tpu_torch.pipeline.extract import extract_array

        res = embed_array(cover, secret, password=password, master_key=mk,
                          params=params, device=dev)
        stego = res.stego  # numpy, as the cover
        if verify:
            try:
                got = extract_array(stego, password=password, master_key=mk,
                                    params=params, device=dev)
            except StegoError:
                got = None
            if got != secret:
                raise StegoError("verify failed")
        return stego, int(res.written_bits), int(res.payload_bytes)
    from steganosaurus_tpu_torch.pipeline.batch import embed_batch

    res = embed_batch(cover[None], [secret], password=password,
                      master_key=mk, params=params, verify=verify, device=dev)
    if res.verified is not None and not res.verified[0]:
        raise StegoError("verify failed")
    return (res.stego[0], int(res.written_bits[0]),
            int(res.payload_bytes[0]))


def _extract_one(img, password, mk, params, dev, hint) -> bytes:
    """One image's secret: the hinted one-pass extract_batch first (a wrong
    hint can cost the fallback, never misdecode; cover-dependent walks
    skip it, extract_batch raises for them), then the two-pass
    extract_array, which raises the precise StegoError ("Magic not found."
    vs an authentication failure) on a real failure."""
    from steganosaurus_tpu_torch.pipeline.extract import extract_array

    secret = None
    if hint and not params.cover_dependent_path:
        from steganosaurus_tpu_torch.pipeline.batch import extract_batch

        secret = extract_batch(img[None], password=password, master_key=mk,
                               params=params, clen_hint=hint, device=dev)[0]
    if secret is None:
        secret = extract_array(img, password=password, master_key=mk,
                               params=params, device=dev)
    return secret


def _do_embed(req: dict, password, mk, params, hints: dict, dev) -> dict:
    from steganosaurus_tpu_torch.io import image as image_io

    if not (req.get("out") or req.get("out_npy")):
        raise StegoError("embed request needs 'out' or 'out_npy'")
    secret = _secret_of(req)
    cover = _load_req(req)
    stego, bits, payload = _embed_one(cover, secret, password, mk, params,
                                      dev, bool(req.get("verify", False)))
    out: dict = {"bits": bits, "payload_bytes": payload}
    if req.get("out_npy"):
        np.save(req["out_npy"], stego)
        out["out_npy"] = req["out_npy"]
    if req.get("out"):
        image_io.save_png(req["out"], stego)
        out["out"] = req["out"]
    # The worker's serving class usually has one payload size; remember
    # it so subsequent single extracts ride the one-pass hinted path.
    hints["clen"] = _clen_of(len(secret), params)
    return out


def _hint_int(hint) -> int | None:
    """Validate a client-supplied clen hint: positive int or None, never a
    crash (serve_loop's never-raise contract covers malformed request
    fields). Non-positive hints are rejected rather than coerced — a
    negative clen would flow into _ExtractJob geometry."""
    if hint is None:
        return None
    try:
        hint = int(hint)
    except (TypeError, ValueError) as e:
        raise StegoError(f"bad clen_hint: {hint!r}") from e
    if hint <= 0:
        raise StegoError(f"bad clen_hint: {hint} (must be positive)")
    return hint


def _do_extract(req: dict, password, mk, params, hints: dict, dev) -> dict:
    img = _load_req(req)
    hint = _hint_int(req.get("clen_hint", hints.get("clen")))
    secret = _extract_one(img, password, mk, params, dev, hint)
    hints["clen"] = _clen_of(len(secret), params)
    return {"secret_b64": base64.b64encode(secret).decode()}


def _preflight(paths: list) -> tuple[list, dict]:
    """Split paths into (loadable, {path: error-result}). The stream
    loader (load_rgb_batches) propagates decode failures, which would turn
    one bad file into a whole-request error; a cheap PIL header probe up
    front keeps per-item isolation for the common failure (missing or
    non-image file). A file that passes the probe but fails full decode
    still errors the request — documented, and rare."""
    from PIL import Image

    good, bad = [], {}
    for p in paths:
        try:
            with Image.open(p):
                pass
            good.append(p)
        except Exception as e:  # noqa: BLE001 — per-item isolation
            bad[p] = {"ok": False, "in": p,
                      "error": f"{type(e).__name__}: {e}"}
    return good, bad


def _do_embed_batch(req: dict, password, mk, params, hints: dict,
                    dev) -> dict:
    from steganosaurus_tpu_torch.io import image as image_io
    from steganosaurus_tpu_torch.pipeline import stream

    jobs = req.get("jobs") or []
    if not jobs:
        raise StegoError("embed_batch request needs non-empty 'jobs'")
    # Jobs are keyed by INDEX, not input path: two jobs may legally share
    # a cover path with different secrets/outputs. The preflight probe is
    # still cached per path.
    all_paths = [j["in"] for j in jobs]
    good_paths, bad = _preflight(sorted(set(all_paths)))
    goodset = set(good_paths)
    results: list = [dict(bad[p], **{"in": p}) if p in bad
                     else {"ok": False, "in": p, "error": "not processed"}
                     for p in all_paths]
    idxs = [i for i, p in enumerate(all_paths) if p in goodset]
    verify = bool(req.get("verify", False))
    queued: list = []

    def batches():
        pos = 0
        for got_paths, covers in stream.load_rgb_batches(
                [all_paths[i] for i in idxs], BATCH):
            got = idxs[pos:pos + len(got_paths)]
            pos += len(got_paths)
            queued.append(got)
            yield covers, [_secret_of(jobs[i]) for i in got]

    for res in stream.embed_stream(batches(), password=password,
                                   master_key=mk, params=params,
                                   verify=verify, device=dev):
        got = queued.pop(0)
        stego = res.stego.cpu().numpy()  # the stream's stego is a tensor
        for j, i in enumerate(got):
            p = all_paths[i]
            if verify and not res.verified[j]:
                results[i] = {"ok": False, "in": p,
                              "error": "verify failed"}
                continue
            out = jobs[i]["out"]
            image_io.save_png(out, stego[j])
            results[i] = {"ok": True, "in": p, "out": out,
                          "bits": int(res.written_bits[j])}
    if idxs:
        # oversized hints are safe; undersized ones cost a second pass —
        # learn the largest payload in the batch
        hints["clen"] = max(_clen_of(len(_secret_of(jobs[i])), params)
                            for i in idxs)
    return {"results": results,
            "n_ok": sum(1 for r in results if r["ok"])}


def _do_extract_batch(req: dict, password, mk, params, hints: dict,
                      dev) -> dict:
    from steganosaurus_tpu_torch.pipeline import stream

    all_paths = req.get("ins") or []
    if not all_paths:
        raise StegoError("extract_batch request needs non-empty 'ins'")
    paths, results = _preflight(all_paths)
    queued: list = []

    def batches():
        for got_paths, stegos in stream.load_rgb_batches(paths, BATCH):
            queued.append(got_paths)
            yield stegos

    hint = _hint_int(req.get("clen_hint", hints.get("clen")))
    for got in stream.extract_stream(batches(), password=password,
                                     master_key=mk, params=params,
                                     clen_hint=hint, device=dev):
        for p, secret in zip(queued.pop(0), got):
            if secret is None:
                results[p] = {"ok": False, "in": p,
                              "error": "extraction failed"}
            else:
                results[p] = {"ok": True, "in": p, "secret_b64":
                              base64.b64encode(secret).decode()}
    ordered = [results[p] for p in all_paths]
    return {"results": ordered,
            "n_ok": sum(1 for r in ordered if r["ok"])}


class _OpStats:
    """Per-op serving telemetry over a bounded latency window."""

    WINDOW = 512

    def __init__(self):
        from collections import deque

        self.n = 0
        self.errors = 0
        self.images = 0  # items processed by batch ops; 1 per single op
        self.ms_max = 0.0
        self.recent = deque(maxlen=self.WINDOW)

    def record(self, ms: float, ok: bool, images: int) -> None:
        self.n += 1
        self.errors += 0 if ok else 1
        self.images += images
        self.ms_max = max(self.ms_max, ms)
        self.recent.append(ms)

    def report(self) -> dict:
        lat = sorted(self.recent)

        def pct(q: float) -> float:
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

        return {"n": self.n, "errors": self.errors, "images": self.images,
                "ms_p50": round(pct(0.50), 1), "ms_p95": round(pct(0.95), 1),
                "ms_max": round(self.ms_max, 1)}


def _warmup_shape(h: int, w: int, payload: int, password, mk, params,
                  dev) -> float:
    """Cache-fill for one (H, W, payload-size) serving class: a synthetic
    cover through exactly what a real request of the class runs, in memory
    (never touches disk): the single embed, the hinted one-pass extract and
    the two-pass extract_array. That expands the walk, vaults the key,
    builds the DFT tables and the cuFFT plans, and builds and loads the K1
    library. Eager torch compiles nothing per shape, so the JAX worker's
    reason for warming at the real payload size (one jitted module per
    4096-bit frame bucket) does not apply; the payload size still sizes the
    walk prefix that is cached. Returns wall seconds."""
    import time

    if h <= 0 or w <= 0 or payload <= 0:
        raise StegoError(f"bad warmup shape {h}x{w}:{payload}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    base = np.linspace(60.0, 200.0, w)[None, :, None]
    cover = np.clip(base + rng.integers(-12, 13, (h, w, 3)),
                    0, 255).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, max(1, payload), dtype=np.uint8))
    try:
        stego = _embed_one(cover, secret, password, mk, params, dev, False)[0]
        _extract_one(stego, password, mk, params, dev,
                     _clen_of(len(secret), params))
        if not params.cover_dependent_path:
            from steganosaurus_tpu_torch.pipeline.extract import extract_array

            extract_array(stego, password=password, master_key=mk,
                          params=params, device=dev)
    except StegoError:
        # A margin failure on synthetic data (or a shape too small for
        # the frame) still warmed every stage it reached; keep serving.
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def serve_loop(password, mk, params, stdin=None, stdout=None,
               warmup=(), device=None) -> int:
    """Read JSON-lines requests until EOF or a shutdown op. Returns the
    process exit code (0 on clean EOF/shutdown). Never raises on a bad
    request — every per-request failure becomes an {"ok": false}
    response so one malformed job cannot kill the worker.

    `device`: where every request runs (default CUDA; "cpu" on request
    only, runtime.resolve_device). Without a card and without "cpu" it
    raises before the ready line.

    `warmup`: iterable of (H, W) or (H, W, payload_bytes) serving
    classes to run once BEFORE the ready line (_warmup_shape), so the
    first real request of a warmed class finds every cache filled."""
    import os
    import time

    from steganosaurus_tpu_torch import __version__, runtime

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    dev = runtime.resolve_device(device)

    def reply(obj: dict) -> None:
        stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
        stdout.flush()

    warmed = []
    for spec in warmup:
        h, w = int(spec[0]), int(spec[1])
        payload = int(spec[2]) if len(spec) > 2 else 6
        dt = _warmup_shape(h, w, payload, password, mk, params, dev)
        print(f"warmed {h}x{w}:{payload} in {dt:.1f}s", file=sys.stderr,
              flush=True)
        warmed.append(f"{h}x{w}:{payload}")
    t_up = time.perf_counter()
    stats: dict[str, _OpStats] = {}
    hints: dict = {}  # learned serving-class state (last wire clen)
    reply({"ok": True, "op": "ready", "pid": os.getpid(),
           "version": __version__,
           **({"warmed": warmed} if warmed else {})})
    ops = {"embed": _do_embed, "extract": _do_extract,
           "embed_batch": _do_embed_batch,
           "extract_batch": _do_extract_batch}
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        rid = None
        op = None
        t0 = time.perf_counter()
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise StegoError("request must be a JSON object")
            rid = req.get("id")
            op = req.get("op")
            if op == "shutdown":
                reply({"ok": True, "op": "shutdown",
                       **({"id": rid} if rid is not None else {})})
                return 0
            if op == "ping":
                out = {"pid": os.getpid(), "version": __version__}
            elif op == "stats":
                out = {"uptime_s": round(time.perf_counter() - t_up, 1),
                       "ops": {k: v.report()
                               for k, v in sorted(stats.items())}}
            elif op in ops:
                out = ops[op](req, password, mk, params, hints, dev)
            else:
                raise StegoError(f"unknown op: {op!r}")
            n_ok = out.get("n_ok")
            ok = (n_ok == len(out["results"])) if n_ok is not None else True
            ms = 1e3 * (time.perf_counter() - t0)
            stats.setdefault(op, _OpStats()).record(
                ms, ok, n_ok if n_ok is not None else 1)
            reply({"ok": ok, "op": op,
                   **({"id": rid} if rid is not None else {}), **out,
                   "ms": round(ms, 1)})
        except Exception as e:  # noqa: BLE001 — never-raise contract
            # The worker must survive ANY per-request failure, CUDA's
            # RuntimeErrors included. The expected types (StegoError,
            # ValueError, ...) are normal bad-request traffic; anything
            # else gets a traceback on stderr so operator logs can tell a
            # bug or a device fault from a bad request.
            ms = 1e3 * (time.perf_counter() - t0)
            if not isinstance(e, (StegoError, ValueError, KeyError,
                                  TypeError, OSError)):
                import traceback

                traceback.print_exc(file=sys.stderr)
                sys.stderr.flush()
            if op is not None:
                stats.setdefault(op, _OpStats()).record(ms, False, 0)
            reply({"ok": False,
                   **({"id": rid} if rid is not None else {}),
                   "error": f"{type(e).__name__}: {e}", "ms": round(ms, 1)})
    return 0
