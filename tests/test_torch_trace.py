"""The port's spans (utils/spans.py) and the benchmark's readers of them: a
profiled CPU stream records each stream span once a batch, numbered by
batch, with the host steps nested inside; with no profiler running a span
is one shared null context and never builds a record_function; the
readers host_ms_per_batch and host_stall_ms_per_batch on worked traces;
the trace parser counts no annotation as a device operation. Shapes and
Params of tests/test_torch_stream.py."""

import contextlib
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline import stream as tstream
from steganosaurus_tpu_torch.utils import spans
from turtlebench import harness
from turtlebench import host_steps

torch.set_num_threads(2)

FAST = Params(pbkdf2_iter=500)
STREAM_SPANS = ("stt.stream.take", "stt.stream.embed", "stt.wait.stream",
                "stt.stream.extract_dispatch", "stt.stream.extract_finalize")


def _batches():
    rng = np.random.default_rng(21)
    base = np.linspace(170, 225, 128)
    imgs = base[None, None, :, None] + rng.integers(-12, 13, (6, 128, 128, 3))
    covers = np.clip(imgs, 0, 255).astype(np.uint8)
    secrets = [bytes([i]) * (5 + i) for i in range(6)]
    salts = [bytes([i * 7]) * 16 for i in range(6)]
    return [(covers[k:k + 2], secrets[k:k + 2], salts[k:k + 2])
            for k in (0, 2, 4)]


def _round_trip(batches):
    """embed_stream -> extract_stream on the CPU: (stegos, answers)."""
    stegos = []

    def fed():
        for res in tstream.embed_stream(iter(batches), password="pw",
                                        params=FAST, depth=2, device="cpu"):
            stegos.append(res.stego.clone())
            yield res.stego

    got = list(tstream.extract_stream(fed(), password="pw", params=FAST,
                                      depth=2, device="cpu"))
    return stegos, got


def _read(name, trace):
    return harness.load_reader(name)(harness.Run(None, trace, {}, None))


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A 3-batch stream under torch.profiler (CPU activity), as the
    benchmark's parser reads its trace, and the stream's answers."""
    batches = _batches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stegos, got = _round_trip(batches)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return harness.parse_chrome_trace(str(path), 1.0, 3), stegos, got


def _by_batch(trace, name):
    """{batch number: [(start, end)]} of the spans `name(b=N)`."""
    out: dict = {}
    pat = re.compile(re.escape(name) + r"\(b=(\d+)\)$")
    for n, s, d in trace.host:
        m = pat.match(n)
        if m:
            out.setdefault(int(m.group(1)), []).append((s, s + d))
    return out


def test_stream_spans_once_a_batch_and_the_answers_unchanged(profiled):
    trace, stegos, got = profiled
    for name in STREAM_SPANS:
        seen = _by_batch(trace, name)
        # take(b=3) is the stream's last read of its input, which found
        # the feed at its end
        want = [0, 1, 2, 3] if name == "stt.stream.take" else [0, 1, 2]
        assert sorted(seen) == want, name
        assert all(len(v) == 1 for v in seen.values()), name
    embeds = _by_batch(trace, "stt.stream.embed")
    seals = [(s, s + d) for n, s, d in trace.host if n == "stt.embed.seal"]
    assert len(seals) == 3
    for b, [(s, e)] in embeds.items():
        assert sum(s <= a and z <= e for a, z in seals) == 1, b
    takes = _by_batch(trace, "stt.stream.take")
    for b, [(s, e)] in embeds.items():
        [(ts, te)] = takes[b + 1]
        assert te <= s or e <= ts, b
    # the spans change nothing the stream computes
    stegos0, got0 = _round_trip(_batches())
    assert got == got0 == [list(b[1]) for b in _batches()]
    for a, b in zip(stegos, stegos0):
        assert torch.equal(a, b)


def test_no_profiler_no_record_function(monkeypatch):
    off = spans.span("stt.stream.embed", 3)
    assert off is spans.span("stt.embed.seal")
    assert isinstance(off, contextlib.nullcontext)

    def boom(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    _, got = _round_trip(_batches()[:2])
    assert got == [list(b[1]) for b in _batches()[:2]]


def _span(name, s, e):
    return (name, float(s), float(e - s))


def test_host_readers_on_a_worked_trace():
    """Steps embed [0, 100], dispatch [150, 200], finalize [300, 400] with
    a wait.pull [320, 360] inside it; a wait.stream [100, 150] between
    steps, a take [400, 450] and an aten op, none of them a step. The
    host's own time: 100 + 50 + 20 + 40 = 210 us over 2 batches. The card
    is busy [0, 50], [180, 330] and [340, 500]: the idle gap [50, 180] is
    half inside steps (embed's [50, 100], dispatch's [150, 180]) and half
    in the wait.stream; the gap [330, 340] lies in the wait.pull. Stall:
    50 + 30 = 80 us over 2 batches."""
    host = [_span("stt.stream.embed(b=0)", 0, 100),
            _span("aten::copy_", 10, 20),
            _span("stt.embed.seal", 5, 40),
            _span("stt.wait.stream(b=0)", 100, 150),
            _span("stt.stream.extract_dispatch(b=0)", 150, 200),
            _span("stt.stream.extract_finalize(b=0)", 300, 400),
            _span("stt.wait.pull", 320, 360),
            _span("stt.stream.take(b=1)", 400, 450)]
    dev = [_span("k1", 0, 50), _span("k2", 180, 330), _span("k3", 340, 500)]
    t = harness.Trace(dev, [], host, 1e-3, 2)
    assert _read("host_ms_per_batch", t) == pytest.approx(0.105)
    assert _read("host_stall_ms_per_batch", t) == pytest.approx(0.040)
    # no spans (a program without them): nothing to read
    bare = harness.Trace(dev, [], [_span("aten::copy_", 10, 20)], 1e-3, 2)
    assert _read("host_ms_per_batch", bare) is None
    assert _read("host_stall_ms_per_batch", bare) is None


def test_subtract_matches_a_unit_grid():
    rng = np.random.default_rng(5)
    for _ in range(50):
        def ivs(n):
            pts = np.sort(rng.choice(100, 2 * n, replace=False))
            return [[int(a), int(b)] for a, b in pts.reshape(-1, 2)]
        a, b = ivs(int(rng.integers(1, 6))), ivs(int(rng.integers(0, 6)))
        grid = np.zeros(100, bool)
        for s, e in a:
            grid[s:e] = True
        for s, e in b:
            grid[s:e] = False
        got = host_steps.subtract(a, b)
        assert host_steps.length(got) == grid.sum()
        assert all(s < e for s, e in got)


def test_host_readers_on_the_cpu_stream(profiled):
    trace, _, _ = profiled
    ms = _read("host_ms_per_batch", trace)
    assert ms is not None and ms > 0
    # the CPU run records no device operation
    assert _read("host_stall_ms_per_batch", trace) is None


def test_parser_counts_no_annotation_as_a_device_operation(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20,
         "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 25,
         "dur": 1},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "stt.stream.embed(b=0)", "ts": 9, "dur": 30},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "stt.embed.queue",
         "ts": 9, "dur": 20},
        {"ph": "X", "cat": "user_annotation",
         "name": "stt.stream.embed(b=0)", "ts": 0, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = harness.parse_chrome_trace(str(path), 1.0, 1)
    assert [n for n, _, _ in t.device_ops] == ["k", "Memcpy DtoH", "Memset"]
    assert [n for n, _, _ in t.host] == ["stt.stream.embed(b=0)"]
    assert _read("host_ms_per_batch", t) == pytest.approx(0.040)
