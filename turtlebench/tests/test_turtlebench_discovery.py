"""A configuration, a traffic mix, a kind of traffic (a driver), a check and
a metric added as new files, with new entries in BENCHMARK.json, are found
by name and run, and no file that was there is edited."""

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

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
