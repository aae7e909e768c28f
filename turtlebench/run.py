"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m turtlebench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Standard output ends with one JSON object (correct, attempted, failed,
metrics, device, check; with --trace 1 also breakdown); standard error
ends with each number the check compares, beside its limit. The run exits
2, printing no result, without CUDA or with fewer cards than the cell
needs, and 3 when the process holds JAX or the JAX package once the window
has closed.

The process runs torch's CPU work on one thread (OMP_NUM_THREADS=1,
torch.set_num_threads(1)): the program's host path is one Python thread,
and idle CPU workers spinning beside it made the host-bound cells run
slower and spread wider.

--control bf16 runs the program's own lower-precision path (corner DFT
precision mode bf16) in place of the configuration's, the whole run;
--control bf16_read only the read the check compares (read_gap). These are
the controls of the check, whose `correct` has to come out false. The
benchmark's own runs never pass them.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m turtlebench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16", "bf16_read"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    root = pathlib.Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())

    from turtlebench import harness

    cell = harness.load_cell(bench, root, args.workload)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("turtlebench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"turtlebench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    # the program's walk cache at a fixed place in the checkout; the corner
    # DFT's precision as the configuration states it
    os.environ["STEGANOSAURUS_WALK_CACHE"] = str(harness.CACHE / "walks")
    os.environ["STEGANOSAURUS_MM_PRECISION"] = (
        "bf16" if args.control == "bf16" else cell.config["precision"])
    import steganosaurus_tpu_torch as stt

    result, numbers = harness.measure(
        stt, cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
        T_START, "bf16" if args.control == "bf16_read" else None)
    found = harness.forbidden_modules()
    if found:
        print(f"turtlebench: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = harness.power_limit()
    correct = harness.verdict(numbers)
    line = {"correct": correct, **result,
            "check": {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}}
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
