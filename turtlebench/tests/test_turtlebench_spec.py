"""BENCHMARK.json against the benchmark's contract, and the import rules:
nothing the benchmark runs imports JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import ast
import json
import math
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "steganosaurus_tpu"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check():
    # 24 cells: 2 + 14 * 24 runs of run_seconds + 60 s, 2 * 90 s a cell to
    # compile, 1200 s spare, within 43200 s
    n = 24
    total = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200)
    assert total <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert LINE.match(e[k]), (e["name"], k)
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert LINE.match(m.get("layer", "x"))


def test_configs_files_and_reduced():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        # the checker that judges its cells, found by name
        assert NAME.match(cfg["checker"])
        assert (REPO / "turtlebench" / "checkers"
                / f"{cfg['checker']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")


def test_workloads_files_chips_and_metrics():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert LINE.match(w["why"])
        tb = REPO / "turtlebench"
        mix = json.loads((tb / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (tb / "drivers" / f"{mix['driver']}.py").is_file()
        assert (tb / "checks" / f"{w['name']}.json").is_file()
        reported = {m for m, e in e2e.items()
                    if w["name"] in e.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layer, w["name"]


def test_metric_entries_bounds_sources_and_moves():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert {m["name"] for m in e2e} == {"ips", "request_p95_ms", "peak_gib",
                                        "setup_s"}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in e2e if m["name"] == "setup_s"] == [0.25]
    cells = {w["name"] for w in BENCH["workloads"]}
    names = {m["name"] for m in BENCH["per_layer"]}
    # none of these may vanish without an edit here; a new one needs none
    assert names >= {"launches_per_batch", "fwd_dft_roofline",
                     "inv_dft_roofline", "device_idle_share"}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] == "ips"
        # every cell it lists reports the end-to-end metric it moves
        for w in m["workloads"]:
            assert w in cells
            e = next(x for x in e2e if x["name"] == m["moves"])
            assert w in e.get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (REPO / "turtlebench" / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in (REPO / "turtlebench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        assert not (_imports(p) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (REPO / "turtlebench" / "reference").rglob("*.py"):
        tops = _imports(p)
        assert not (tops & FORBIDDEN), p
        assert "steganosaurus_tpu_torch" not in tops, p
        # nothing of the benchmark outside the reference either
        assert not [m for m in tops if m == "turtlebench"] or all(
            "turtlebench.reference" in line or "turtlebench import" not in
            line for line in p.read_text().splitlines()), p


def test_a_checker_imports_nothing_of_the_harness():
    """The harness loads checkers; a checker reads only reference/, torch
    and what its call hands it, so the dependency runs one way."""
    files = list((REPO / "turtlebench" / "checkers").glob("*.py"))
    assert files
    for p in files:
        names = set()
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names |= {f"{node.module}.{a.name}" for a in node.names}
        assert not [n for n in names if "harness" in n.split(".")], p


def test_forbidden_names_are_compared_whole():
    from turtlebench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["steganosaurus_tpu_torch_fake"] = object()
        sys.modules["jaxlike"] = object()
        assert harness.forbidden_modules() == [] or "jax" not in saved
        sys.modules["flax.core"] = object()
        assert "flax" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_run_on_the_cpu_loads_no_jax(tmp_path):
    """The whole run but the card check, in a fresh process at a tiny size:
    once it has ended, sys.modules holds none of the forbidden names."""
    code = f"""
import json, pathlib, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {str(REPO)!r})
import os
os.environ["STEGANOSAURUS_WALK_CACHE"] = {str(tmp_path / 'walks')!r}
from turtlebench import harness
import steganosaurus_tpu_torch as stt
harness.CACHE = pathlib.Path({str(tmp_path)!r})
bench = json.loads(pathlib.Path({str(REPO / 'BENCHMARK.json')!r}).read_text())
cell = harness.load_cell(bench, pathlib.Path({str(REPO)!r}), "uhd4k_16k.stream")
cell.config = dict(cell.config, height=256, width=512, batch=2, secret_bytes=64)
cell.traffic = dict(cell.traffic, warmup_batches=1, trace_seconds=0.5)
# a few raw bit errors an image at this size: read_gap's limit is the cells'
cell.check = dict(sample_images=1,
                  limits=dict(cell.check["limits"], read_gap=1.0))
res, nums = harness.measure(stt, cell, 2**31 + 7, 0.5, True, "cpu", t0)
print(json.dumps([harness.forbidden_modules(), harness.verdict(nums)]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    found, correct = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and correct


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "turtlebench.run", "--workload",
         "uhd4k_16k.stream", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert math.isfinite(len(out.stderr))
