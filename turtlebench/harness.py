"""The benchmark of steganosaurus_tpu_torch, driven by data.

A cell of BENCHMARK.json names a configuration (configs/<config>.json: the
deployment's shapes, parameters and precision, and under "checker" the
checker that judges its cells), a traffic mix (traffic/<traffic>.json: its
parameters, and the driver that reads them) and its check
(checks/<cell>.json: the sample the checker reads and each limit).

A driver, drivers/<driver>.py, is one kind of traffic: a class
`Driver(stt, cell, seed, device)` with `warm()`,
`stream(until=, count=, sample=) -> Stream`, and the `shape`, `params`,
`key`, `covers` (NCHW), `layout` and `unread` the checker reads
(drivers/stream.py says what each is).

A checker, checkers/<checker>.py, is one way of deciding `correct`: a
function `check(stt, service, sample, wrong, read_precision, cache) ->
(numbers, info)`. It may read the driver's `shape`, `params`, `key`,
`covers`, `layout` and `unread`, the (cover, secret, salt, stego) items of
`sample.drawn()`, the count `wrong` of answers that were another secret or
never came, and the program through `stt`; read_precision, where not None,
is the corner DFT precision the program's compared read runs under (a
control's); cache is a directory of the checkout where it may keep what its
reference computes, for the checkout's later runs. It returns every number
`verdict` compares, each as [value, limit], the limits taken from
`service.cell.check["limits"]`, and a record of what else it read. Its
plain reference lives in reference/, which imports nothing of the program;
a checker imports nothing of the harness.

Every metric, end-to-end or per layer, is a reader of its own,
metrics/<name>.py, with `read(run) -> float | None`: the harness hands each
the run's window record and, in a traced run, its trace, and leaves a
metric out when its reader returns None. A later cell, configuration, mix,
kind of traffic, checker or metric is new files and entries.

One run: the covers are made on the card from the seed, the driver warms
every shape the window uses, the peak statistics are reset, then the
service runs for the window, optionally followed by a traced stretch under
torch.profiler, and last the configuration's checker judges what the
window produced. The harness takes from the program only the system under
test, its kernel names and the profiler's view of it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from turtlebench.reference import stego as ref_stego

ROOT = pathlib.Path(__file__).resolve().parent
CACHE = ROOT / ".cache"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "steganosaurus_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


def load_cell(bench: dict, root: pathlib.Path, name: str) -> Cell:
    """The cell `name` of a parsed BENCHMARK.json, its files read from
    `root` (the checkout), and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = root / "turtlebench"
    config = json.loads((root / cfg["file"]).read_text())
    if "checker" not in config:
        raise ValueError(f'{cfg["file"]} has no "checker" key: the name of '
                         "the checkers/<name>.py that judges its cells")
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    check = json.loads((here / "checks" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic, check, e2e, layer)


def corner_dims(H: int, W: int, rmax: float) -> tuple[int, int]:
    """(Ky, Kx) of the spectrum corner that holds every walk bin:
    floor(rmax * min(H, W)) + 1 rounded up to 256, clamped to the grid."""
    k = -(-(int(math.floor(rmax * min(H, W))) + 1) // 256) * 256
    return min(k, H), min(k, W)


def shape_of(cell: Cell) -> dict:
    """The sizes the work counts and the reference need."""
    c = cell.config
    H, W = c["height"], c["width"] - cell.traffic.get("crop_right", 0)
    Ky, Kx = corner_dims(H, W, c["params"]["rmax"])
    return {"B": c["batch"], "H": H, "W": W, "Ky": Ky, "Kx": Kx,
            "secret_bytes": c["secret_bytes"], "precision": c["precision"],
            "slots": ref_stego.frame_slots(c["secret_bytes"])}


def service_key(cell: Cell) -> bytes:
    """The service's one master key: fixed for a configuration, so that a
    checkout's later runs find its walk in the walk caches."""
    return hashlib.sha256(b"turtlebench service key|"
                          + cell.config["name"].encode()).digest()


def make_covers(cell: Cell, seed: int, device) -> torch.Tensor:
    """(B, 3, H, W) u8 covers on `device`: the configuration's pool, the
    bench recipe (a horizontal gradient low..high across the configuration's
    width plus uniform integer noise in [-noise, noise], clipped) drawn from
    the pool's own seed, so every run serves the same covers; cropped by the
    mix's crop_right columns, made contiguous, and put in an order drawn
    from the run's seed."""
    c = cell.config
    spec = c["covers"]
    B, H, W = c["batch"], c["height"], c["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(spec["pool_seed"]))
    base = torch.floor(torch.linspace(spec["low"], spec["high"], W,
                                      dtype=torch.float64, device=device))
    base = base.to(torch.int16)
    n = spec["noise"]
    crop = cell.traffic.get("crop_right", 0)
    out = torch.empty((B, 3, H, W - crop), dtype=torch.uint8, device=device)
    order = torch.randperm(B, generator=torch.Generator().manual_seed(seed))
    step = 8
    for i in range(0, B, step):
        k = min(step, B - i)
        noise = torch.randint(-n, n + 1, (k, 3, H, W), generator=gen,
                              device=device, dtype=torch.int16)
        idx = order[i:i + k].to(device)
        out[idx] = (noise + base).clamp_(0, 255)[..., :W - crop].to(
            torch.uint8)
    return out


class Feed:
    """The traffic of a stream mix: batch k's B secrets and B salts, drawn
    from (seed, k) alone, so that every run of a seed sends the same."""

    def __init__(self, seed: int, B: int, secret_bytes: int):
        self.seed, self.B, self.n = seed, B, secret_bytes

    def batch(self, k: int) -> tuple[list[bytes], list[bytes]]:
        rng = np.random.default_rng([self.seed, k])
        raw = rng.bytes(self.B * (self.n + 16))
        secrets = [raw[i * self.n:(i + 1) * self.n] for i in range(self.B)]
        off = self.B * self.n
        salts = [raw[off + 16 * i:off + 16 * (i + 1)] for i in range(self.B)]
        return secrets, salts


class Sample:
    """The stegos the check reads, drawn from the seed over every batch the
    run streams: one image for each class of batch slot (slot modulo
    `size`), each a reservoir of one over that class, so that every class
    of slot is drawn whatever the batch. Items: (cover, secret, salt, a
    copy of its stego)."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([seed, 0x5A4D])
        self.size = size
        self.seen = [0] * size
        self.items: list = [None] * size

    def offer(self, stego: torch.Tensor, covers, secrets, salts) -> None:
        draws = self.rng.random(len(secrets))
        for i in range(len(secrets)):
            c = i % self.size
            self.seen[c] += 1
            if draws[i] * self.seen[c] < 1.0:
                self.items[c] = (covers[i], secrets[i], salts[i],
                                 stego[i].clone())

    def drawn(self) -> list:
        return [it for it in self.items if it is not None]


@dataclasses.dataclass
class Stream:
    """What one stretch of the stream did: images sent, secrets returned
    byte for byte, and answers that were wrong or never came (the rest
    said that no secret could be read: None)."""
    seconds: float = 0.0
    batches: int = 0
    images: int = 0
    ok: int = 0
    wrong: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Trace:
    """A traced stretch, as the per-layer readers see it. Times in
    microseconds on the profiler's clock; `window_s` on the host's."""
    device_ops: list      # (name, start, duration): kernels, copies, sets
    runtime: list         # (name, start, duration): host calls into CUDA
    host: list            # (name, start, duration): host ops and ranges
    window_s: float
    batches: int


@dataclasses.dataclass
class Run:
    """What a reader gets: the window (None in a traced run's per-layer
    pass), the trace (None untraced), the cell's sizes and the card's
    peaks (None where peaks.json does not know the card)."""
    window: dict | None
    trace: Trace | None
    shape: dict
    peaks: dict | None


def busy_intervals(ops) -> list:
    """The union of (start, duration) intervals as merged [start, end]."""
    spans = sorted((s, s + d) for _, s, d in ops)
    merged: list = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace.device_ops)) / 1e6


def breakdown(trace: Trace) -> dict:
    """The device operations that took the most time (summed by name), and
    the device's idle time summed by the innermost host op running at each
    gap's middle, ten of each."""
    by_op: dict = {}
    for name, _, d in trace.device_ops:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + d / 1e6
    merged = busy_intervals(trace.device_ops)
    events = trace.host + trace.runtime + trace.device_ops
    gaps = []
    if merged and events:
        lo = min(s for _, s, _ in events)
        hi = max(s + d for _, s, d in events)
        edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_gap: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = int(np.searchsorted(starts, mid, side="right"))
        inner = [h for h in host[max(0, i - 256):i] if h[1] + h[2] >= mid]
        label = (short_name(min(inner, key=lambda h: h[2])[0]) if inner
                 else "host: no traced op")
        by_gap[label] = by_gap.get(label, 0.0) + (e - s) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def short_name(name: str) -> str:
    """A kernel or op name without its return type and argument list."""
    name = name.removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:160]


def parse_chrome_trace(path: str, window_s: float, batches: int) -> Trace:
    """A torch.profiler chrome trace as a Trace."""
    data = json.loads(pathlib.Path(path).read_text())
    dev, rt, host = [], [], []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        item = (ev.get("name", ""), float(ev["ts"]), float(ev.get("dur", 0)))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(item)
        elif cat in ("cuda_runtime", "cuda_driver"):
            rt.append(item)
        elif cat in ("cpu_op", "user_annotation"):
            host.append(item)
    return Trace(dev, rt, host, window_s, batches)


def traced_stretch(service, seconds: float,
                   sample: Sample) -> tuple[Trace, Stream]:
    """A stream of `seconds` under torch.profiler (host ops and, on a card,
    CUDA), fill and drain included, as a Trace of whole batches."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if service.covers.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        st = service.stream(until=time.perf_counter() + seconds,
                            sample=sample)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="turtlebench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse_chrome_trace(path, st.seconds, st.batches), st
    finally:
        os.unlink(path)


def _load(folder: str, name: str):
    """The module <folder>/<name>.py of the benchmark."""
    spec = importlib.util.spec_from_file_location(
        f"turtlebench_{folder}_" + name.replace(".", "_"),
        ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """metrics/<name>.py's read()."""
    return _load("metrics", name).read


def load_driver(name: str):
    """drivers/<name>.py's Driver."""
    return _load("drivers", name).Driver


def load_checker(name: str):
    """checkers/<name>.py's check()."""
    return _load("checkers", name).check


def card_peaks(kind: str) -> dict | None:
    for card in json.loads((ROOT / "peaks.json").read_text())["cards"]:
        if card["match"] in kind:
            return card
    return None


def verdict(numbers: dict) -> bool:
    """correct: every number the check compares at or under its limit."""
    return all(v <= lim for v, lim in numbers.values())


def forbidden_modules() -> list[str]:
    """The top-level names of FORBIDDEN that sys.modules holds, compared
    whole (steganosaurus_tpu_torch is not steganosaurus_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def measure(stt, cell: Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float,
            read_precision: str | None = None) -> tuple[dict, dict]:
    """One run of `cell`: (the result line's fields, the check's numbers).
    t_start: the process's start on the perf_counter clock;
    read_precision: the precision of the checker's compared read (the
    checker contract, in the module's docstring)."""
    on_card = torch.device(device).type == "cuda"
    check = load_checker(cell.config["checker"])
    service = load_driver(cell.traffic["driver"])(stt, cell, seed, device)
    sample = Sample(seed, int(cell.check["sample_images"]))
    service.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    win = service.stream(until=t_window + seconds, sample=sample)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window = {"seconds": win.seconds, "batches": win.batches,
              "images": win.images, "ok": win.ok,
              "latencies_s": win.latencies_s, "peak_bytes": peak,
              "setup_s": t_window - t_start}
    attempted, ok, wrong = win.images, win.ok, win.wrong
    tr = None
    if trace:
        tr, st = traced_stretch(service, float(cell.traffic["trace_seconds"]),
                                sample)
        attempted += st.images
        ok += st.ok
        wrong += st.wrong
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    run = Run(None if trace else window, tr, service.shape, card_peaks(kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"attempted": attempted, "failed": attempted - ok,
              "metrics": metrics, "device": device_info,
              "answered_none": attempted - ok - wrong}
    if tr is not None:
        device_info["busy_s"] = busy_seconds(tr)
        device_info["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    # the checker runs once the window is over and the peak is read, with
    # the program's in-flight state gone
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    numbers, result["reference"] = check(stt, service, sample, wrong,
                                         read_precision, CACHE / "reference")
    return result, numbers


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reports it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
