"""A configuration, a traffic mix, a kind of traffic (a driver), a checker,
a check and a metric added as new files, with new entries in
BENCHMARK.json, are found by name and run, and no file that was there is
edited."""

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from turtlebench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]


def digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_and_entries_are_found_by_name(tmp_path):
    tb = tmp_path / "turtlebench"
    shutil.copytree(REPO / "turtlebench", tb,
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    before = digests(tb)
    cfg = json.loads((tb / "configs" / "uhd4k_16k.json").read_text())
    cfg.update(name="tiny_cfg", height=256, width=512, batch=2,
               secret_bytes=64)
    (tb / "configs" / "tiny_cfg.json").write_text(json.dumps(cfg))
    (tb / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"driver": "capped", "cap": 2, "depth": 1, "crop_right": 3,
         "warmup_batches": 1, "trace_seconds": 0.5}))
    # a new kind of traffic: the stream driver's service, ending its window
    # after `cap` batches
    (tb / "drivers" / "capped.py").write_text(
        "from turtlebench.drivers.stream import Driver as Stream\n"
        "class Driver(Stream):\n"
        "    def stream(self, *, until=None, count=None, **kw):\n"
        "        cap = int(self.cell.traffic['cap'])\n"
        "        count = cap if count is None else min(count, cap)\n"
        "        return super().stream(until=None, count=count, **kw)\n")
    (tb / "checks" / "tiny_cfg.tiny_mix.json").write_text(json.dumps(
        {"sample_images": 1,
         "limits": {"spec_err": 4.0, "bytes_off": 100, "read_gap": 1.0}}))
    (tb / "metrics" / "batches_done.py").write_text(
        "def read(run):\n"
        "    return None if run.window is None else run.window['batches']\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_cfg", "source": "https://x.org",
                             "file": "turtlebench/configs/tiny_cfg.json",
                             "reduced": ["height", "width"], "why": "test"})
    bench["workloads"].append({"name": "tiny_cfg.tiny_mix",
                               "config": "tiny_cfg", "traffic": "tiny_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "batches_done", "unit": "batches",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny_cfg.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, os, pathlib, sys, time
t0 = time.perf_counter()
os.environ["STEGANOSAURUS_WALK_CACHE"] = "turtlebench/.cache/walks"
sys.path.insert(1, {str(REPO)!r})
from turtlebench import harness
assert harness.ROOT == pathlib.Path.cwd().resolve() / "turtlebench"
import steganosaurus_tpu_torch as stt
bench = json.loads(pathlib.Path("BENCHMARK.json").read_text())
cell = harness.load_cell(bench, pathlib.Path("."), "tiny_cfg.tiny_mix")
res, nums = harness.measure(stt, cell, 2**31 + 99, 0.5, False, "cpu", t0)
print(json.dumps([harness.shape_of(cell), res["metrics"], nums,
                  harness.verdict(nums)]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    shape, metrics, nums, correct = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert (shape["H"], shape["W"], shape["B"]) == (256, 509, 2)
    assert sorted(metrics) == ["batches_done", "ips", "request_p95_ms",
                               "setup_s"]
    assert metrics["batches_done"]["value"] == 2
    assert correct, nums
    after = digests(tb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_new_checker_and_its_metric_are_found_by_name(tmp_path):
    """A configuration that names a checker of its own (checkers/toy.py:
    the shared walk's numbers and one more), its cell's mix and check, and
    a per-layer metric of that cell: measure returns the toy's numbers,
    verdict reads them, and no file that was there is edited."""
    tb = tmp_path / "turtlebench"
    shutil.copytree(REPO / "turtlebench", tb,
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    before = digests(tb)
    cfg = json.loads((tb / "configs" / "uhd4k_16k.json").read_text())
    cfg.update(name="toy_cfg", height=256, width=512, batch=2,
               secret_bytes=64, checker="toy")
    (tb / "configs" / "toy_cfg.json").write_text(json.dumps(cfg))
    (tb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"driver": "stream", "depth": 1, "warmup_batches": 1,
         "trace_seconds": 0.5}))
    # its own number: the sample's classes of slot that drew no stego
    (tb / "checkers" / "toy.py").write_text(
        "from turtlebench.checkers import shared_walk\n"
        "def check(stt, service, sample, wrong, read_precision, cache):\n"
        "    numbers, info = shared_walk.check(\n"
        "        stt, service, sample, wrong, read_precision, cache)\n"
        "    lim = service.cell.check['limits']['undrawn']\n"
        "    numbers['undrawn'] = [sample.size - len(sample.drawn()), lim]\n"
        "    return numbers, dict(info, toy=True)\n")
    (tb / "checks" / "toy_cfg.toy_mix.json").write_text(json.dumps(
        {"sample_images": 2,
         "limits": {"spec_err": 4.0, "bytes_off": 100, "read_gap": 1.0,
                    "undrawn": 0}}))
    (tb / "metrics" / "stretch_batches.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else run.trace.batches\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_cfg", "source": "https://x.org",
                             "file": "turtlebench/configs/toy_cfg.json",
                             "reduced": ["height", "width"], "why": "test"})
    bench["workloads"].append({"name": "toy_cfg.toy_mix", "config": "toy_cfg",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "stretch_batches", "unit": "batches",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "stream", "moves": "ips",
                               "workloads": ["toy_cfg.toy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, os, pathlib, sys, time
t0 = time.perf_counter()
os.environ["STEGANOSAURUS_WALK_CACHE"] = "turtlebench/.cache/walks"
sys.path.insert(1, {str(REPO)!r})
from turtlebench import harness
import steganosaurus_tpu_torch as stt
bench = json.loads(pathlib.Path("BENCHMARK.json").read_text())
cell = harness.load_cell(bench, pathlib.Path("."), "toy_cfg.toy_mix")
res, nums = harness.measure(stt, cell, 2**31 + 77, 0.5, True, "cpu", t0)
print(json.dumps([res["metrics"], res["reference"], nums,
                  harness.verdict(nums),
                  harness.verdict(dict(nums, undrawn=[1, 0]))]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics, info, nums, correct, one_undrawn = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert sorted(nums) == ["bytes_off", "read_gap", "spec_err", "undrawn",
                            "unread", "wrong"]
    assert nums["undrawn"] == [0, 0] and info["toy"] is True
    assert correct and not one_undrawn, nums
    assert list(metrics) == ["stretch_batches"]
    assert metrics["stretch_batches"]["value"] >= 1
    after = digests(tb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_configuration_without_a_checker_is_refused(tmp_path):
    cfg = json.loads((REPO / "turtlebench" / "configs" / "uhd4k_16k.json")
                     .read_text())
    del cfg["checker"]
    (tmp_path / "plain.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    # an absolute file: load_cell reads root / file
    bench["configs"][0]["file"] = str(tmp_path / "plain.json")
    with pytest.raises(ValueError, match='"checker"'):
        harness.load_cell(bench, REPO, bench["workloads"][0]["name"])
