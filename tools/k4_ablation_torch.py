"""Where K4 (the inverse DFT's x-stage with the u8 epilogue) spends its
time on one CUDA card: an ablation of its work and its schedule.

    python3 tools/k4_ablation_torch.py [OUT]

At the main path's shape (4K, B=64: the forward corner spectrum of
chip_smoke.py's bench covers through K3's main-path write and the y-stage,
as the smoke's phase 3c makes them; NCHW, centering off) it builds
variants of steganosaurus_tpu_torch/csrc/corner_ifft_epilogue.cu, each a
few text edits of the committed source, and times them in turns with the
committed build by CUDA events. A variant that drops work ("no epilogue",
"B loaded once") writes a wrong stego by design: it is timed, never used.
Also in turns: the committed kernel storing NHWC. First each build's ptxas
report (registers, spills, and whether ptxas serialised the wgmmas).
Prints one line each with the card's name and power limit, and writes them
to OUT (default build/k4_ablation.txt).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_EPILOGUE = "    // ---- epilogue: scale, sign, + cover, round, clamp, store ----"
_ISSUE = "      wgmma_fence();\n#pragma unroll\n      for (int s = 0; s < 4; ++s)"
_WAIT = ("      wgmma_wait1();  // the k-block before this one is done: free "
         "its stage\n")
_B_LOAD = """          mbar_expect_tx(&full[stage], bytes);
          tma_load_2d(smem_b + stage * B_BYTES, tm_b, kb * BK, t.n0,
                      &full[stage]);"""

# (name, what the edits change, [(the committed text, its replacement)])
VARIANTS = [
    ("fences in the k-loop", "the accumulator fences around each k-block's "
     "wgmmas, which make ptxas serialise them (the first version)",
     [(_ISSUE, "      fence_acc(d);\n" + _ISSUE),
      (_WAIT, _WAIT + "      fence_acc(d);\n")]),
    ("cover in the epilogue", "the cover words' loads moved from before the "
     "k-loop into the epilogue",
     [("  const bool prefetch = vec && mode != OUT_VALUES;",
       "  const bool prefetch = false;"),
      ("(cover[g] >> (8 * j)) & 0xff",
       "(*reinterpret_cast<const uint32_t*>(planes + r.nchw + w) >> (8 * j))"
       " & 0xff")]),
    ("no epilogue", "the epilogue (the accumulators are summed, not stored)",
     [(_EPILOGUE, "    {\n      float s_ = 0.f;\n      for (int i = 0; i < 128;"
       " ++i) s_ += d[i];\n      if (s_ == 1.2345e-30f) reinterpret_cast<"
       "float*>(out)[threadIdx.x] = s_;\n      if (W > 0) continue;\n    }\n"
       + _EPILOGUE)]),
    ("B loaded once", "the table's loads after each block's first ring "
     "(its L2 traffic)",
     [(_B_LOAD, """          const bool lb = tile == (int)blockIdx.x && kb < STAGES;
          mbar_expect_tx(&full[stage], lb ? bytes : bytes - B_BYTES);
          if (lb)
            tma_load_2d(smem_b + stage * B_BYTES, tm_b, kb * BK, t.n0,
                        &full[stage]);""")]),
    ("3 stages", "one stage of the ring",
     [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
    ("wait_group 0", "the k-block kept in flight while the stage before it "
     "is freed", [(_WAIT, _WAIT.replace("wait1", "wait0"))]),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else (
        REPO / "build" / "k4_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / "corner_ifft_epilogue.cu"
    flags = _build.NVCC_FLAGS + _build.NVCC_SOURCE_FLAGS[src.name]
    work = REPO / "build" / "k4_ablation"
    work.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    sources, libs = {"committed": src}, {}
    for name, _, edits in VARIANTS:
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in "
                                   f"{src} once")
            t = t.replace(old, new)
        cu = work / (name.replace(" ", "_") + ".cu")
        cu.write_text(t)
        sources[name] = cu
        libs[name] = cu.with_suffix(".so")
    # each build once, its ptxas report kept
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *flags, "-Xptxas", "-v", str(cu), "-o",
         str(libs.get(name, work / "committed.so"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cu in sources.items()}
    for name, proc in procs.items():
        report, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed\n{report[-4000:]}")
        keep = [s.strip() for s in report.splitlines()
                if "Used" in s or "spill" in s]
        serial = "C7514" in report
        log(f"K4 {name}: ptxas {'; '.join(keep)}; wgmmas serialised: "
            f"{serial}")

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    planes = chip_smoke._grid_nchw(dev, B, H, W)
    p = stt.Params()
    Ky, Kx = corner.corner_dims(H, W, p.rmax)
    cr, ci, maps, _, tabs, rep = chip_smoke._write_inputs(planes, Ky, Kx, 60)
    dr, di, _ = wk.write_floor(cr, ci, maps[0], rep, *pb._cos_sin(p.alpha),
                               floor=p.write_floor,
                               img_pixels=float(H) * float(W),
                               ifft_operands=True)
    del cr, ci, maps, rep
    mr16, mi16 = corner.ifft_corner_y(dr, di, tabs, conjugated=True)
    del dr, di
    others = {q: q for q in base.paths.values()
              if q != base.paths[wk.KERNEL_IFFT_EPILOGUE]}
    kernels = {"committed": base}
    kernels.update({name: _build.Kernels({**others, lib: lib})
                    for name, lib in libs.items()})

    def call(name, layout="nchw"):
        def fn():
            _build._kernels = kernels[name]
            return wk.ifft_epilogue(mr16, mi16, tabs, planes, False, layout)
        return fn

    runs = {name: (call(name), 10) for name in kernels}
    runs["committed, NHWC"] = (call("committed", "nhwc"), 10)
    times = chip_smoke._turns(runs, rounds=3)
    what = {name: change for name, change, _ in VARIANTS}
    for name in runs:
        log(f"K4 {name}" + (f" (changes {what[name]})" if name in what
                            else "") + f": {times[name]!r} ms ({card})")
    _build._kernels = base
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
