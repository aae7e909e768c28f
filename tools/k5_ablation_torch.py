"""Where K5 (the extract's walk read and decode) spends its time on one
CUDA card: its design's choices, each against the committed build.

    python3 tools/k5_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shape (4K, B=64: the forward corner spectrum of
chip_smoke.py's bench covers as the extract computes it, and phase 4's
16 KB walk) it builds variants of
steganosaurus_tpu_torch/csrc/corner_read_decode.cu, each a few text edits
of the committed source, and times them in turns with the committed build
and the lone gather ci[:, plane, y, x] by CUDA events, as the fused pass
calls K5 (hard and bf16 soft rows). A variant that drops work ("no soft
row") computes a wrong result by design: it is timed, never used; every
other variant's rows are checked equal to the committed build's. With
--parent REV it also builds REV's corner_read_decode.cu
(tools/parent_kernels_torch.py: from git, or a source put by hand under
build/parents/REV/), times it in the same turns and checks its rows. First
each build's ptxas report (registers, spills). Prints one line each with
the card's name and power limit, and writes them to OUT (default
build/k5_ablation.txt).
"""

from __future__ import annotations

import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "corner_read_decode.cu"

# (name, what the edits change, [(the committed text, its replacement)],
# whether its rows are the committed build's, {read_kernels constant: its
# value for the variant})
VARIANTS = [
    ("loads through L1", "the gather's loads cached in L1 too (ld.global.nc) "
     "in place of L2 only",
     [("constexpr bool L2_ONLY = true;", "constexpr bool L2_ONLY = false;")],
     True, {}),
    ("1 image group", "grid.y = 1: every block loops over the whole batch",
     [], True, {"GRID_FILL": 1}),
    ("4 image groups", "grid.y = 4 at 4K", [], True, {"GRID_FILL": 4}),
    ("2 blocks an SM", "registers capped at 32 a thread (launch bounds "
     "of two 1024-thread blocks an SM: 64 warps in flight), grid.y = 4 at 4K",
     [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 2)")],
     True, {"GRID_FILL": 4}),
    ("16 words a block", "blocks of 16 warps (512 threads), two an SM",
     [("constexpr int WARPS = 32;", "constexpr int WARPS = 16;")], True,
     {"WORDS_PER_BLOCK": 16}),
    ("8 words a block", "blocks of 8 warps (256 threads)",
     [("constexpr int WARPS = 32;", "constexpr int WARPS = 8;")], True,
     {"WORDS_PER_BLOCK": 8}),
    ("one image", "every image read from image 0's planes (a diagnostic: "
     "the gather from a batch that sits in L2; its rows are wrong)",
     [("  a.img_stride = 3LL * Ky * Kx;", "  a.img_stride = 0;")], False,
     {}),
    ("no soft row", "the soft row's rounding, sums, ballot and store",
     [("      if (a.soft_mode) {", "      if (a.soft_mode && a.B < 0) {")],
     False, {}),
]

ROUNDS = 5  # turns of every build


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def main(argv=None) -> int:
    import torch

    parents, args = [], []
    it = iter(sys.argv[1:] if argv is None else argv)
    for a in it:
        if a == "--parent":
            parents.append(next(it))
        else:
            args.append(a)
    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    missing = [r for r in parents if pk.parent_source(r, SOURCE) is None]
    if missing:
        print(f"k5_ablation_torch: no {SOURCE} of {missing[0]}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k5_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    out = pathlib.Path(args[0]) if args else (
        REPO / "build" / "k5_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    _build.ensure_native()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / SOURCE
    work = REPO / "build" / "k5_ablation"
    work.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    sources = {"committed": src}
    for name, _, edits, _, _ in VARIANTS:
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in "
                                   f"{src} once")
            t = t.replace(old, new)
        cu = work / (re.sub(r"\W+", "_", name) + ".cu")
        cu.write_text(t)
        sources[name] = cu
    pnames = [f"parent {r[:12]}" for r in parents]
    for r, pname in zip(parents, pnames):
        sources[pname] = pk.parent_source(r, SOURCE)
    kernels, reports = _build.build_variants(SOURCE, sources, work)
    for name, report in reports.items():
        keep = [s.strip() for s in report.splitlines()
                if "Used" in s or "spill" in s]
        log(f"K5 {name}: ptxas {'; '.join(keep)}")
    kernels["committed"] = base

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    covers = chip_smoke._grid_nchw(dev, B, H, W)
    p = stt.Params()
    pl, yy, xx, _, Ky, Kx, _ = chip_smoke._read_walk(dev, H, W,
                                                     chip_smoke.UHD_SECRET)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    _, ci = corner.fwd_corner(covers, p.center, Ky, Kx, tabs,
                              corner.precision())
    del covers, tabs
    ssa = pb._sign_sin(p.alpha)
    kw = dict(hdr_stream_bits=912, payload_rep=7, soft="bf16")

    patches = {name: patch for name, _, _, _, patch in VARIANTS}
    defaults = {k: getattr(rk, k) for patch in patches.values()
                for k in patch}

    def call(name):
        def fn():
            _build._kernels = kernels[name]
            for k, v in {**defaults, **patches.get(name, {})}.items():
                setattr(rk, k, v)
            return rk.read_decode(ci, pl, yy, xx, ssa, **kw)
        return fn

    want = call("committed")()
    same_rows = [name for name, _, _, same, _ in VARIANTS if same] + pnames
    for name in same_rows:
        got = call(name)()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K5 {name!r}: rows differ from the "
                                 f"committed build's")
    runs = {name: (call(name), 10) for name in kernels}
    runs["lone gather"] = (lambda: ci[:, pl, yy, xx], 10)
    times = chip_smoke._turns(runs, rounds=ROUNDS)
    what = {name: change for name, change, _, _, _ in VARIANTS}
    for name in runs:
        log(f"K5 {name}" + (f" (changes {what[name]})" if name in what
                            else "") + f": median {_median(times[name])!r} "
            f"of {times[name]!r} ms at 4K B={B} ({card})")
    _build._kernels = base
    for k, v in defaults.items():
        setattr(rk, k, v)
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
