"""Where K2 (forward stage 2's GEMM) spends its time on one CUDA card: an
ablation of its work, its schedule and the pieces of its design.

    python3 tools/k2_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shape (4K, B=64: the stage-1 output of chip_smoke.py's
bench covers through K1, the prep and its band, as the smoke's phase 3d
makes them) it builds variants of steganosaurus_tpu_torch/csrc/
corner_stage2.cu, each a few text edits of the committed source, and times
the kernel alone (its C entry on prebuilt operands, no torch glue) in turns
with the committed build by CUDA events. A variant that drops work ("no
epilogue", "loads after the first ring skipped", "bulk tiles only")
computes a wrong spectrum by design, and the promotion variants another
sum order: they are timed, never used. With --parent REV (more than once
for several) it also builds commit REV's corner_stage2.cu (tools/parent_kernels_torch.py: from git, or
from build/parents/REV/ where the checkout has no history), times its K2 in
the same turns and reports whether its outputs and the committed kernel's
are bit-equal (a parent up to 4f717a6, whose K2 took one band group and no
bulk flag, binds through parent_kernels_torch.OLD_SIGNATURES; the
committed build runs there with nb = 1 and the bulk). First each build's ptxas report (registers, spills, and
whether ptxas serialised the wgmmas); last the accuracy of the sum orders
(the committed promotion every 4 k-blocks, every k-block, none) beside
cuBLAS's bf16 products: their error on the bulk columns against the exact
sum of the same bf16 products. Prints one line each with the card's name
and power limit, and writes them to OUT (default build/k2_ablation.txt).
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SOURCE = "corner_stage2.cu"
_EPILOGUE = "      // ---- epilogue: f32 cr / ci from registers ----"

# (name, what the edits change, [(the committed text, its replacement)])
VARIANTS = [
    ("7 stages", "a seventh stage of the ring",
     [("constexpr int STAGES = 6;", "constexpr int STAGES = 7;")]),
    ("multicast off", "the multicast: each block of a cluster loads its "
     "own B boxes and frees only its own stages",
     [("constexpr bool MULTICAST = true;",
       "constexpr bool MULTICAST = false;")]),
    ("promotion every k-block", "every k-block waited for and added into "
     "the f32 sum (PROMOTE = 1)",
     [("constexpr int PROMOTE = 4;", "constexpr int PROMOTE = 1;")]),
    ("no promotion", "no promotion inside a tile: the tensor cores sum the "
     "whole contraction (the first version's numerics)",
     [("constexpr int PROMOTE = 4;", "constexpr int PROMOTE = 1 << 20;")]),
    ("no epilogue", "no epilogue: the sums are added up, not stored",
     [(_EPILOGUE, "      {\n        float s_ = 0.f;\n        for (int i = 0;"
       " i < 64; ++i) s_ += acc[i];\n        if (s_ == 1.2345e-30f) "
       "a.cr[threadIdx.x] = s_;\n        if (a.X > 0) continue;\n      }\n"
       + _EPILOGUE)]),
    ("loads after the first ring skipped", "no TMA load after each "
     "cluster's first ring of stages: no operand traffic from L2 or HBM",
     [("          mbar_expect_tx(&full[stage], bytes);\n",
       "          const bool ld = unit == cluster_id() && kb < STAGES;\n"
       "          mbar_expect_tx(&full[stage], ld ? bytes : 0u);\n"),
      ("          if (t.band) {\n            // segment s",
       "          if (!ld) {\n          } else if (t.band) {\n"
       "            // segment s")]),
    ("bulk tiles only", "no band tiles: their columns keep no value",
     [("  a.n_band = (int)n_band;\n  a.n_units = (int)n_units;",
       "  a.n_band = 0;\n  a.n_units = (int)(n_units - n_band);")]),
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
        print(f"k2_ablation_torch: no {SOURCE} of {missing[0]}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    out = pathlib.Path(rest[0]) if rest else (
        REPO / "build" / "k2_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / SOURCE
    work = REPO / "build" / "k2_ablation"
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
        cu = work / (name.replace(" ", "_").replace("=", "") + ".cu")
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
        log(f"K2 {name}: ptxas {'; '.join(keep)}; wgmmas serialised: "
            f"{'C7514' in report}")
    kernels["committed"] = base

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    planes = chip_smoke._grid_nchw(dev, B, H, W)
    Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    ar, ai = ck.fwd_stage1(planes.reshape(-1, H, W), tabs.exr16, tabs.exi16,
                           False, tabs.stage1)
    del planes
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, corner.SPLIT_X0)
    g = ck.band_operand(ar, ai, idx)
    mask = ck.band_mask(idx, Kx)
    P = ar.shape[0]
    t2 = tabs.stage2
    Kyp, Hp = t2.shape[1] // 2, t2.shape[2] // 2
    cr, ci = (torch.empty((P, Ky, Kx), dtype=torch.float32, device=dev)
              for _ in range(2))
    log(f"K2 grid at 4K B={B}: {ck.stage2_grid(P, Kx, Ky)} blocks in "
        f"clusters of {ck.STAGE2_CLUSTER}")

    def call(name, outs=(cr, ci)):
        lib = kernels[name]
        # a parent built before the band width was a run-time count: its
        # own signature, without nb and the bulk flag
        old = name in pnames and pk.takes_old_signature(sources[name],
                                                        "corner_stage2")
        entry = (pk.old_entry(lib.paths["corner_stage2"], "corner_stage2")
                 if old else lib.corner_stage2)
        tail = () if old else (1, 1)

        def fn():
            rc = entry(
                t2.data_ptr(), ar16.data_ptr(), ai16.data_ptr(),
                g.data_ptr(), mask.data_ptr(), idx.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), P, H, Kx, Ky, Kyp,
                Hp, ar16.stride(1), ai16.stride(1), *tail,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return fn

    for pname in pnames:
        pr, pi = torch.empty_like(cr), torch.empty_like(ci)
        call("committed")()
        call(pname, (pr, pi))()
        torch.cuda.synchronize()
        same = torch.equal(cr, pr) and torch.equal(ci, pi)
        del pr, pi
        log(f"K2 committed against {pname} at 4K B={B}: outputs bit-equal "
            f"{same}")

    runs = {name: (call(name), 10) for name in kernels}
    times = chip_smoke._turns(runs, rounds=ROUNDS)
    what = {name: change for name, change, _ in VARIANTS}
    for name in runs:
        log(f"K2 {name}" + (f" ({what[name]})" if name in what
                            else "") + f": median {_median(times[name])!r} "
            f"of {times[name]!r} ms ({card})")

    # accuracy of the sum orders: the bulk columns of the first NP planes
    # against the exact (f64) sum of the same bf16 products
    # (corner_kernels.bulk_error, which chip_smoke.py's phase 3d bounds),
    # for the variants that compute K2's function and for the eager chain's
    # four cuBLAS bf16 products (corner._mm_bf16) and their f32 difference
    NP = 24

    def error(name, got):
        rms = ck.bulk_error(*got, ar16, ai16, idx, tabs, NP)
        log(f"K2 accuracy, {name}: bulk columns of {NP} planes against the "
            f"exact sum of the same bf16 products: RMS {rms!r}")

    for name in ("committed", "promotion every k-block", "no promotion"):
        call(name)()
        torch.cuda.synchronize()
        error(name, (cr, ci))
    m16 = (ar16[:NP], ai16[:NP])
    error("the eager chain's cuBLAS bf16 products",
          (corner._mm_bf16(tabs.eyr16, m16[0])
           - corner._mm_bf16(tabs.eyi16, m16[1]),
           corner._mm_bf16(tabs.eyr16, m16[1])
           + corner._mm_bf16(tabs.eyi16, m16[0])))
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
