"""Where K6 (the inverse DFT's y-stage) spends its time on one CUDA card:
an ablation of its work.

    python3 tools/k6_ablation_torch.py [OUT]

At the main path's shape (4K, B=64: K3's bf16 operands of the forward
corner spectrum of chip_smoke.py's bench covers, as the smoke's phase 3e
makes them) it builds variants of
steganosaurus_tpu_torch/csrc/corner_ifft_y.cu, each a few text edits of the
committed source, and times them in turns with the committed build by CUDA
events. A variant that drops work ("no epilogue", "operands loaded once")
computes a wrong result by design: it is timed, never used. First each
build's ptxas report (registers, spills, and whether ptxas serialised the
wgmmas). Prints one line each with the card's name and power limit, and
writes them to OUT (default build/k6_ablation.txt).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_EPILOGUE = "    // ---- epilogue: round to bf16 (or keep f32) and store ----"
_LOADS = """          mbar_expect_tx(&full[stage], bytes);
          tma_load_2d(smem_a + stage * A_BYTES, &tm_a, kb * BK, t.mt * BM,
                      &full[stage]);
          const CUtensorMap* tm = kb < a.nky ? &tm_r : &tm_i;
          const int y0 = (kb < a.nky ? kb : kb - a.nky) * BK;
          uint8_t* sb = smem_b + stage * B_BYTES;
          for (int j = 0; j < boxes; ++j)
            tma_load_3d(sb + j * BOX_BYTES, tm, n0 + BOX * j, y0, t.p,
                        &full[stage]);"""
_WAIT = ("      wgmma_wait1();  // the k-block before this one is done: free "
         "its stage\n")

# (name, what the edits change, [(the committed text, its replacement)])
VARIANTS = [
    ("no epilogue", "the epilogue (the accumulators are summed, not stored)",
     [(_EPILOGUE, "    {\n      float s_ = 0.f;\n      for (int i = 0; i < 128;"
       " ++i) s_ += d[i];\n      if (s_ == 1.2345e-30f) reinterpret_cast<"
       "float*>(a.mr)[threadIdx.x] = s_;\n      if (a.Kx > 0) continue;\n"
       "    }\n" + _EPILOGUE)]),
    ("operands loaded once", "the table's and the delta's loads after each "
     "block's first ring (their L2 and HBM traffic)",
     [(_LOADS, """          const bool lb = tile == (int)blockIdx.x && kb < STAGES;
          mbar_expect_tx(&full[stage], lb ? bytes : 0u);
          const CUtensorMap* tm = kb < a.nky ? &tm_r : &tm_i;
          const int y0 = (kb < a.nky ? kb : kb - a.nky) * BK;
          uint8_t* sb = smem_b + stage * B_BYTES;
          if (lb) {
            tma_load_2d(smem_a + stage * A_BYTES, &tm_a, kb * BK, t.mt * BM,
                        &full[stage]);
            for (int j = 0; j < boxes; ++j)
              tma_load_3d(sb + j * BOX_BYTES, tm, n0 + BOX * j, y0, t.p,
                          &full[stage]);
          }""")]),
    ("3 stages", "one stage of the ring",
     [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
    ("wait_group 0", "the k-block kept in flight while the stage before it "
     "is freed", [(_WAIT, _WAIT.replace("wait1", "wait0"))]),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else (
        REPO / "build" / "k6_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / "corner_ifft_y.cu"
    flags = _build.NVCC_FLAGS + _build.NVCC_SOURCE_FLAGS.get(src.name, [])
    work = REPO / "build" / "k6_ablation"
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
        log(f"K6 {name}: ptxas {'; '.join(keep)}; wgmmas serialised: "
            f"{serial}")

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
    others = {q: q for q in base.paths.values()
              if q != base.paths[wk.KERNEL_IFFT_Y]}
    kernels = {"committed": base}
    kernels.update({name: _build.Kernels({**others, lib: lib})
                    for name, lib in libs.items()})

    def call(name):
        def fn():
            _build._kernels = kernels[name]
            return wk.ifft_y(dcr, dci, tabs)
        return fn

    runs = {name: (call(name), 10) for name in kernels}
    times = chip_smoke._turns(runs, rounds=3)
    what = {name: change for name, change, _ in VARIANTS}
    for name in runs:
        log(f"K6 {name}" + (f" (changes {what[name]})" if name in what
                            else "") + f": {times[name]!r} ms ({card})")
    _build._kernels = base
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
