"""The check that decides `correct`. A whole run but the look for a card,
on the CPU at a small size, with the timed path broken underneath
(turtlebench/faults.py): each fault the cells can have makes `correct`
false, the sound path makes it true, and so do the controls: the program's
own lower-precision path, the whole run or the compared read alone.

The cells run on one card, so no exchange between cards can be left out.
On the card, the controls and the column fault run at the cells' own
sizes through `python3 -m turtlebench.readings` (test_controls_on_the_card).
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from turtlebench import faults, harness

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2**31 + 4242


def small_cell(tmp_path):
    cell = harness.load_cell(BENCH, REPO, "uhd4k_16k.stream")
    cell.config = dict(cell.config, height=540, width=960, batch=2,
                       secret_bytes=1000)
    cell.traffic = dict(cell.traffic, warmup_batches=1)
    # a few hundred raw bit errors an image at this size, so read_gap's
    # rounding noise is a few times the cells'
    cell.check = dict(sample_images=2,
                      limits=dict(cell.check["limits"], read_gap=0.05))
    return cell


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", str(tmp_path / "walks"))
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", "mix_adaptive")
    monkeypatch.setattr(harness, "CACHE", tmp_path)
    import steganosaurus_tpu_torch as stt

    return stt


def one_run(stt, cell, fault="none", read_precision=None):
    res, nums = harness.measure(faults.broken(stt, fault), cell, SEED, 1.0,
                                False, "cpu", time.perf_counter(),
                                read_precision)
    return harness.verdict(nums), nums, res


def test_the_sound_path_is_correct(env, tmp_path):
    ok, nums, res = one_run(env, small_cell(tmp_path))
    assert ok, nums
    assert res["failed"] == 0 and res["attempted"] > 0
    assert nums["spec_err"][0] < 2.0
    assert res["reference"]["rows"] == 2 and res["reference"]["images"] == 2


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "spec_err"), ("half_batch", "wrong"), ("altered", "wrong"),
    ("half_write", "spec_err"), ("unanswered", "unread"),
    ("wrong_column", "bytes_off")])
def test_each_fault_is_not_correct(env, tmp_path, fault, number):
    ok, nums, _ = one_run(env, small_cell(tmp_path), fault)
    assert not ok
    value, limit = nums[number]
    assert value > limit, nums


def test_the_control_is_not_correct(env, tmp_path, monkeypatch):
    """The program's bf16 mode (the forward DFT's stage 2 without its band
    of high-energy columns) in place of mix_adaptive, the whole run."""
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", "bf16")
    ok, nums, res = one_run(env, small_cell(tmp_path))
    assert not ok
    assert nums["spec_err"][0] > nums["spec_err"][1]
    assert res["failed"] == 0     # recovery alone cannot tell it


def test_the_read_control_reaches_the_read(env, tmp_path):
    """bf16 in the read the check compares alone, on the same sample: the
    stegos are judged as before, the program's raw decisions change. At
    this size on the CPU its gap stays within the rounding's; on the card,
    at the cells' size, it has to fail read_gap
    (test_controls_on_the_card)."""
    cell = small_cell(tmp_path)
    service = harness.load_driver("stream")(env, cell, SEED, "cpu")
    sample = harness.Sample(SEED, 2)
    service.warm()
    service.stream(count=2, sample=sample)
    check = harness.load_checker("shared_walk")
    sound, info0 = check(env, service, sample, 0, None, tmp_path)
    nums, info = check(env, service, sample, 0, "bf16", tmp_path)
    for k in ("spec_err", "bytes_off", "wrong", "unread"):
        assert nums[k] == sound[k]
    assert info["ref_raw_errors"] == info0["ref_raw_errors"]
    assert info["prog_raw_errors"] != info0["prog_raw_errors"]
    assert harness.verdict(sound)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_controls_on_the_card(cell):
    """On the card at the cell's size, in one process: a sound run comes
    out correct; three seeds of each control and of the column fault come
    out not correct, each through the number it is there to fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = 2**31 + 11
    plan = [("none", base)] + [
        (mode, base + 1 + 3 * k + j)
        for k, mode in enumerate(("bf16", "bf16_read", "wrong_column"))
        for j in range(3)]
    out = subprocess.run(
        [sys.executable, "-m", "turtlebench.readings", "--workload", cell,
         "--seconds", "3", "--runs", *[f"{m}={s}" for m, s in plan]],
        capture_output=True, text=True, timeout=1500, cwd=REPO,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [(x["mode"], x["seed"]) for x in lines] == plan
    expect = {"bf16": "spec_err", "bf16_read": "read_gap",
              "wrong_column": "bytes_off"}
    for x in lines:
        if x["mode"] == "none":
            assert x["correct"] is True, x
        else:
            value, limit = x["check"][expect[x["mode"]]]
            assert x["correct"] is False and value > limit, x
