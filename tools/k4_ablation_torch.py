"""Where K4 (the inverse DFT's x-stage with the u8 epilogue) spends its
time on one CUDA card: an ablation of its work and of the pieces of its
design.

    python3 tools/k4_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shape (4K, B=64: the forward corner spectrum of
chip_smoke.py's bench covers through K3's main-path write and the y-stage,
as the smoke's phase 3c makes them; centering off) it builds variants of
steganosaurus_tpu_torch/csrc/corner_ifft_epilogue.cu, each a few text
edits of the committed source, and times them in turns with the committed
build by CUDA events, NCHW and NHWC beside one torch.mm of [mr, mi] with
[exr; -exi] into f32, and NCHW at 4c's 2160x3839. A variant that drops
work ("no epilogue") writes a wrong stego by design: it is timed, never
used. With --parent REV (more than once for several) it also builds
commit REV's corner_ifft_epilogue.cu (tools/parent_kernels_torch.py: from
git, or from build/parents/REV/ where the checkout has no history),
reports whether its outputs and the committed kernel's are bit-equal on
every grid of the smoke's phase 3c (K4_GRIDS: u8 NCHW and NHWC, centering
off and on, and the f32 check mode), and times it in the same turns.
First each build's ptxas report (registers, spills, and whether ptxas
serialised the wgmmas) and the SASS counts of each of its kernels, and
the committed kernel's grid at 4K. Prints one line each with the card's
name and power limit, and writes them to OUT (default
build/k4_ablation.txt).
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "corner_ifft_epilogue.cu"

_WORDS = "        uint32_t cw[32];\n"
_WHOLE = "        // the staging is whole: the store warp takes it from here\n"
_HANDOFF = """        fence_async_shared();
        named_arrive(full_bar(wg), HANDOFF);"""
_STORE_WARP = "    } else if (kTma && threadIdx.x / 32 == STORER / 32) {"

# (name, what the edits change, [(the committed text, its replacement)])
VARIANTS = [
    ("no epilogue", "the epilogue's arithmetic and its staging words (the "
     "accumulators are summed; the handoffs, the cover loads and the "
     "stores stay)",
     [(_WORDS, "        {\n          float s_ = 0.f;\n          for (int i = 0; "
       "i < 128; ++i) s_ += d[i];\n          if (s_ == 1.2345e-30f) "
       "my_stg[lane] = 1;\n        }\n        if (a.W < 0) {\n" + _WORDS),
      (_WHOLE, "        }\n" + _WHOLE)]),
    ("stores by the consumers", "the store warp of the TMA path: each "
     "consumer warpgroup's first thread issues its TMA stores and waits "
     "until they have read the staging",
     [(_STORE_WARP, _STORE_WARP.replace("kTma &&", "false &&")),
      (_HANDOFF, """        fence_async_shared();
        named_sync(3 + wg, 128);
        if (threadIdx.x % 128 == 0) {
          const int m0 = t.m0 + 64 * wg;
          for (int j = 0; j < 2 && m0 < a.M && t.n0 + U8_BOX * j < a.W; ++j)
            tma_store_2d(tm_o, smem_u32(my_stg) + j * U8_BOX_BYTES,
                         t.n0 + U8_BOX * j, m0);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(&stg_empty[wg]);
        }""")]),
    ("cover in registers", "the cover's TMA loads: the consumers load the "
     "cover words into 32 registers a thread before each tile's k-loop "
     "(the first version's prefetch)",
     [("constexpr bool COVER_TMA = true;", "constexpr bool COVER_TMA = false;")]),
    ("cluster off", "the 2-CTA clusters: each block loads the whole table "
     "boxes of its stages itself (no multicast), walking row blocks one "
     "by one",
     [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")]),
    ("3 stages", "one stage of the ring of the staged tiles (TMA's and "
     "NHWC's)",
     [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
    ("plain ring of 4", "a fourth stage of the ring of the NCHW tiles TMA "
     "does not map (3839)",
     [("constexpr int STAGES_PLAIN = 3;", "constexpr int STAGES_PLAIN = 4;")]),
]

ROUNDS = 5  # turns of every build
SASS = ("HGMMA", "UTMALDG", "UTMASTG", "LDL", "STL")


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


def _inputs(chip_smoke, planes, seed: int):
    """3c's K4 operands of the u8 covers `planes`: their forward corner
    spectrum through K3's main-path write (bf16 operands), then the
    y-stage; (mr16, mi16, tabs)."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    B, _, H, W = planes.shape
    p = stt.Params()
    Ky, Kx = corner.corner_dims(H, W, p.rmax)
    cr, ci, maps, _, tabs, rep = chip_smoke._write_inputs(planes, Ky, Kx,
                                                          seed)
    dr, di, _ = wk.write_floor(cr, ci, maps[0], rep, *pb._cos_sin(p.alpha),
                               floor=p.write_floor,
                               img_pixels=float(H) * float(W),
                               ifft_operands=True)
    del cr, ci, maps, rep
    mr16, mi16 = corner.ifft_corner_y(dr, di, tabs, conjugated=True)
    return mr16, mi16, tabs


def main(argv=None) -> int:
    import torch

    parents, rest = _args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    missing = [r for r in parents if pk.parent_source(r, SOURCE) is None]
    if missing:
        print(f"k4_ablation_torch: no {SOURCE} of {missing[0]}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k4_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    out = pathlib.Path(rest[0]) if rest else (
        REPO / "build" / "k4_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / SOURCE
    work = REPO / "build" / "k4_ablation"
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
        cu = work / (re.sub(r"\W+", "_", name) + ".cu")
        cu.write_text(t)
        sources[name] = cu
    pnames = [f"parent {r[:12]}" for r in parents]
    for r, pname in zip(parents, pnames):
        sources[pname] = pk.parent_source(r, SOURCE)
    # each build once, its ptxas report and its NCHW kernels' SASS kept
    kernels, reports = _build.build_variants(SOURCE, sources, work)
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    for name, report in reports.items():
        keep = [s.strip() for s in report.splitlines()
                if "Used" in s or "spill" in s]
        lib = kernels[name].paths[wk.KERNEL_IFFT_EPILOGUE]
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
        counts = {fn: {op: len(re.findall(rf"\b{op}\b", body))
                       for op in SASS}
                  for fn, body in zip(parts[1::2], parts[2::2])
                  if "corner_ifft_" in fn}
        log(f"K4 {name}: ptxas {'; '.join(keep)}; wgmmas serialised: "
            f"{'C7514' in report}; SASS by kernel {counts}")
    kernels["committed"] = base

    def with_build(name, fn):
        _build._kernels = kernels[name]
        try:
            return fn()
        finally:
            _build._kernels = base

    dev = torch.device("cuda", 0)
    B, H = chip_smoke.UHD_B, chip_smoke.UHD_H
    log(f"K4 grid at 4K B={B} NCHW: {wk.ifft_epilogue_grid(B, H, chip_smoke.UHD_W, 'nchw')} blocks")
    # bit-equality against each parent on every grid of phase 3c
    for g, (gname, gb, gh, gw) in enumerate(chip_smoke.K4_GRIDS if pnames
                                            else ()):
        planes = chip_smoke._grid_nchw(dev, gb, gh, gw)
        mr16, mi16, tabs = _inputs(chip_smoke, planes, 60 + g)
        if "unaligned" in gname:
            mr16, mi16, planes = (chip_smoke._shifted(t)
                                  for t in (mr16, mi16, planes))
        cases = [(c, lay, False) for c in (False, True)
                 for lay in ("nchw", "nhwc")]
        cases += [(c, "nchw", True) for c in (False, True)]
        for pname in pnames:
            same = []
            for center, layout, values in cases:
                def run(center=center, layout=layout, values=values):
                    return wk.ifft_epilogue(mr16, mi16, tabs, planes, center,
                                            layout, values=values)
                got = run()
                want = with_build(pname, run)
                torch.cuda.synchronize()
                same.append(bool(torch.equal(got, want)))
                del got, want
            log(f"K4 committed against {pname} at {gname} B={gb} {gh}x{gw}: "
                f"bit-equal {all(same)} (u8 NCHW, NHWC, centering off and "
                f"on; f32 check mode, centering off and on: {same})")
        del mr16, mi16, tabs, planes
        torch.cuda.empty_cache()

    def call(name, layout="nchw"):
        def fn():
            return with_build(name, lambda: wk.ifft_epilogue(
                mr16, mi16, tabs, planes, False, layout))
        return fn

    what = {name: change for name, change, _ in VARIANTS}
    for W, layouts in ((chip_smoke.UHD_W, ("nchw", "nhwc")),
                       (chip_smoke.UHD_W - 1, ("nchw",))):
        planes = chip_smoke._grid_nchw(dev, B, H, W)
        mr16, mi16, tabs = _inputs(chip_smoke, planes, 60)
        runs = {}
        for layout in layouts:
            for name in kernels:
                runs[f"{name}, {layout}"] = (call(name, layout), 10)
        if W == chip_smoke.UHD_W:
            a_cat = torch.cat([mr16, mi16], dim=1)
            b_cat = torch.cat([tabs.exr16, -tabs.exi16], dim=0)
            runs["torch.mm"] = (lambda: torch.mm(
                a_cat, b_cat, out_dtype=torch.float32), 3)
        times = chip_smoke._turns(runs, rounds=ROUNDS)
        for key in runs:
            name = key.split(",")[0]
            log(f"K4 at {H}x{W} B={B} {key}" + (
                f" (changes {what[name]})" if name in what else "")
                + f": median {_median(times[key])!r} of {times[key]!r} ms "
                f"({card})")
        del mr16, mi16, tabs, planes, runs
        torch.cuda.empty_cache()
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
