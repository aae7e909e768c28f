"""The readings that the check's limits are set from, many seeds in one
process, so that the set-up is paid once:

    python3 -m turtlebench.readings --workload <cell> --seconds 3 \
        --runs none=<seed> none=<seed> bf16=<seed> wrong_column=<seed> ...

from the root of a checkout on a machine with a card. Each run is a whole
run of the cell but its window's length (`harness.measure`), in one of
these modes: `none` (the program as the configuration states it), `bf16`
(the control: the program's bf16 precision mode, the whole run),
`bf16_read` (the control of the read: bf16 in the read the check compares
alone) or a fault of turtlebench/faults.py planted under the stream. Each
prints one JSON line: the mode, the seed, `correct`, each number compared
with its limit, and the run's counts. The benchmark's own runs never run
this; the card tests do.
"""

from __future__ import annotations

import os
import time

os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

MODES = ("none", "bf16", "bf16_read")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m turtlebench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="mode=seed, mode one of none, bf16, bf16_read or a "
                         "fault of turtlebench/faults.py")
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())

    from turtlebench import faults, harness

    runs = []
    for r in args.runs:
        mode, seed = r.split("=")
        if mode not in MODES and mode not in faults.FAULTS:
            ap.error(f"unknown mode {mode!r}")
        runs.append((mode, int(seed)))
    cell = harness.load_cell(bench, root, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("turtlebench: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["STEGANOSAURUS_WALK_CACHE"] = str(harness.CACHE / "walks")
    import steganosaurus_tpu_torch as stt

    for mode, seed in runs:
        os.environ["STEGANOSAURUS_MM_PRECISION"] = (
            "bf16" if mode == "bf16" else cell.config["precision"])
        prog = faults.broken(stt, mode if mode in faults.FAULTS else "none")
        res, nums = harness.measure(
            prog, cell, seed, args.seconds, False, "cuda:0",
            time.perf_counter(), "bf16" if mode == "bf16_read" else None)
        line = {"mode": mode, "seed": seed,
                "correct": harness.verdict(nums),
                "check": {k: [v, lim] for k, (v, lim) in nums.items()},
                "attempted": res["attempted"], "failed": res["failed"],
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "reference": res["reference"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
