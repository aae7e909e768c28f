"""Where K6 (the inverse DFT's y-stage) spends its time on one CUDA card:
an ablation of its work and of the pieces of its design.

    python3 tools/k6_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shape (4K, B=64: K3's bf16 operands of the forward
corner spectrum of chip_smoke.py's bench covers, as the smoke's phase 3e
makes them) it builds variants of
steganosaurus_tpu_torch/csrc/corner_ifft_y.cu, each a few text edits of the
committed source, and times them in turns with the committed build by CUDA
events. A variant that drops work ("no epilogue", "operands loaded once")
computes a wrong result by design: it is timed, never used. With --parent
REV (more than once for several) it also builds commit REV's
corner_ifft_y.cu (tools/parent_kernels_torch.py: from git, or from
build/parents/REV/ where the checkout has no history), times it in the same turns and reports
whether its bf16 outputs and the committed kernel's are bit-equal. First
each build's ptxas report (registers, spills, and whether ptxas serialised
the wgmmas). Prints one line each with the card's name and power limit,
and writes them to OUT (default build/k6_ablation.txt).
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "corner_ifft_y.cu"

_EPILOGUE = "      // ---- epilogue: round to bf16 (or keep f32) and store ----"
_LOADS = """          tma_load_2d(smem_a + stage * A_BYTES, &tm_a, kb * BK, t.mt * BM,
                      &full[stage]);"""
_WAIT = ("        wgmma_wait1();  // the k-block before this one is done: "
         "free its stage\n")

# (name, what the edits change, [(the committed text, its replacement)])
VARIANTS = [
    ("no epilogue", "the epilogue (the accumulators are summed, not "
     "stored; no store warp)",
     [("constexpr bool STAGED = true;", "constexpr bool STAGED = false;"),
      (_EPILOGUE, "      {\n        float s_ = 0.f;\n        for (int i = 0;"
       " i < 128; ++i) s_ += d[i];\n        if (s_ == 1.2345e-30f) "
       "reinterpret_cast<float*>(a.mr)[threadIdx.x] = s_;\n        if (a.Kx"
       " > 0) continue;\n      }\n" + _EPILOGUE)]),
    ("operands loaded once", "the table's and the delta's loads after each "
     "block's first ring (their L2 and HBM traffic)",
     [("          mbar_expect_tx(&full[stage], bytes);\n",
       "          const bool ld = tile == blockIdx.x && kb < STAGES;\n"
       "          mbar_expect_tx(&full[stage], ld ? bytes : 0u);\n"),
      (_LOADS, "          if (ld)\n  " + _LOADS.replace("\n", "\n  ")),
      ("          for (int j = 0; j < boxes; ++j)\n            tma_load_3d",
       "          for (int j = 0; j < boxes && ld; ++j)\n            "
       "tma_load_3d")]),
    ("register stores", "the staged epilogue and its store warp: each "
     "consumer thread stores bf16x2 pairs from its registers (the first "
     "version's stores)",
     [("constexpr bool STAGED = true;", "constexpr bool STAGED = false;")]),
    ("register stores, 4 stages", "the staged epilogue, its 64 KB given "
     "to a fourth stage (the first version's ring and stores)",
     [("constexpr bool STAGED = true;", "constexpr bool STAGED = false;"),
      ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]),
    ("wait_group 0", "the k-block kept in flight while the stage before it "
     "is freed", [(_WAIT, _WAIT.replace("wait1", "wait0"))]),
]


ROUNDS = 5  # turns of every build


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _args(argv):
    """(the revisions of each --parent REV, in order; the other
    arguments)."""
    parents, rest = [], []
    it = iter(argv)
    for a in it:
        if a == "--parent":
            parents.append(next(it))
        else:
            rest.append(a)
    return parents, rest


def main(argv=None) -> int:
    import torch

    parents, rest = _args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    missing = [r for r in parents if pk.parent_source(r, SOURCE) is None]
    if missing:
        print(f"k6_ablation_torch: no {SOURCE} of {missing[0]}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k6_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    out = pathlib.Path(rest[0]) if rest else (
        REPO / "build" / "k6_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / SOURCE
    work = REPO / "build" / "k6_ablation"
    work.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    sources = {"committed": src}
    for name, _, edits in VARIANTS:
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in "
                                   f"{src} once")
            t = t.replace(old, new)
        cu = work / (name.replace(" ", "_").replace(",", "") + ".cu")
        cu.write_text(t)
        sources[name] = cu
    pnames = [f"parent {r[:12]}" for r in parents]
    for r, pname in zip(parents, pnames):
        sources[pname] = pk.parent_source(r, SOURCE)
    # each build once, its ptxas report kept (the committed one too)
    kernels, reports = _build.build_variants(SOURCE, sources, work)
    for name, report in reports.items():
        keep = [s.strip() for s in report.splitlines()
                if "Used" in s or "spill" in s]
        log(f"K6 {name}: ptxas {'; '.join(keep)}; wgmmas serialised: "
            f"{'C7514' in report}")
    kernels["committed"] = base

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    planes = chip_smoke._grid_nchw(dev, B, H, W)
    p = stt.Params()
    Ky, Kx = corner.corner_dims(H, W, p.rmax)
    cr, ci, maps, _, tabs, rep = chip_smoke._write_inputs(planes, Ky, Kx, 60)
    dcr, dci, _ = wk.write_floor(cr, ci, maps[0], rep, *pb._cos_sin(p.alpha),
                                 floor=p.write_floor,
                                 img_pixels=float(H) * float(W),
                                 ifft_operands=True)
    del cr, ci, maps, rep, planes

    def call(name):
        def fn():
            _build._kernels = kernels[name]
            return wk.ifft_y(dcr, dci, tabs)
        return fn

    for name in pnames:
        got, want = call("committed")(), call(name)()
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        log(f"K6 committed against {name} at 4K B={B}: bf16 outputs "
            f"bit-equal {same}")
    runs = {name: (call(name), 10) for name in kernels}
    times = chip_smoke._turns(runs, rounds=ROUNDS)
    what = {name: change for name, change, _ in VARIANTS}
    for name in runs:
        log(f"K6 {name}" + (f" (changes {what[name]})" if name in what
                            else "") + f": median {_median(times[name])!r} "
            f"of {times[name]!r} ms ({card})")
    _build._kernels = base
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
