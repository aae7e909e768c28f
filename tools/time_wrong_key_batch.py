"""Wall time of a wrong-key extract_batch at 4K UHD, B=64, on one CUDA card.

    python3 tools/time_wrong_key_batch.py [ROOT]

Imports steganosaurus_tpu_torch from ROOT (a checkout of this repository;
default: the one this file is in), embeds chip_smoke.py's main-path batch
(2160x3840, B=64, 16 KB secrets, seed-42 bench covers tiled from 32, nchw,
on the card) under one master key, and times extract_batch of those stegos
under another key: one cold call, then WARM calls, each on the host clock
ending in torch.cuda.synchronize(). No header parses under the wrong key,
so every row comes back None; what the call costs is how the package
treats unparseable rows. Prints the card's name and power limit, then one
JSON line: {"root", "cold_ms", "warm_ms": [...], "none", "rows"}.

To compare two trees, run it once per tree in one chip session, in the
order parent, change, change, parent.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
WARM = 5


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    import torch

    if not torch.cuda.is_available():
        print("time_wrong_key_batch: needs a CUDA card", file=sys.stderr)
        return 2
    # the workload's recipe from this checkout's chip_smoke.py, the package
    # under test from ROOT
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root))
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime

    if not pathlib.Path(stt.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {stt.__file__}, not from {root}")
    runtime.configure_precision()
    _build.ensure_native()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    B = smoke.UHD_B
    base = smoke.make_covers(smoke.UHD_BASE, smoke.UHD_H, smoke.UHD_W)
    covers = torch.from_numpy(base).to(dev).permute(0, 3, 1, 2)
    covers = covers.repeat(-(-B // base.shape[0]), 1, 1, 1)[:B].contiguous()
    secrets = smoke.secrets_for(B, smoke.UHD_SECRET)
    stego = stt.embed_batch(covers, secrets, master_key=smoke.MASTER_KEY,
                            salts=[bytes([i]) * 16 for i in range(B)],
                            device_resident=True, layout="nchw").stego

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = stt.extract_batch(stego, master_key=smoke.MASTER_KEY2,
                                clen_hint=smoke.UHD_SECRET, layout="nchw")
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t) * 1e3

    got, cold = run()
    warm = []
    for _ in range(WARM):
        got, ms = run()
        warm.append(ms)
    print(json.dumps({"root": str(root), "cold_ms": cold, "warm_ms": warm,
                      "none": got.count(None), "rows": B}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
