"""Where K3's write_floor spends its time on one CUDA card: the resident
schedule's phases, and an ablation of its work.

    python3 tools/k3_ablation_torch.py [OUT]

At the main path's shape (4K, B=64: the forward corner spectrum of
chip_smoke.py's bench covers, a seeded walk of a 16 KB frame's 919,312
bins and its RepFrame, as the smoke's phase 3b makes them; hard write,
floor 0.45, bf16 operands) it builds variants of
steganosaurus_tpu_torch/csrc/corner_write_floor.cu, each one text edit of
the committed source that drops one piece of work, and times them in turns
with the committed build by CUDA events, each beside its phases
(write_kernels.PHASES by the kernel's own clock). A variant's output is
wrong by design: it is timed, never used. Also in turns: the committed
kernel given the (B, bucket) u8 frame bits in place of the RepFrame, its
f32 output, and its two-pass schedule on the u8 frame. First the ptxas
report (registers, spills) of each resident kernel of the committed
source. Prints one line each with the card's name and power limit, and
writes them to OUT (default build/k3_ablation.txt).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# (name, what the edit drops, the committed text, its replacement)
VARIANTS = [
    ("no frame bits", "pass 1's slot -> stream bit lookups",
     "      if (p[j] < a.bucket) ones |= stream_bit(a, sw, p[j]) << j;",
     "      if (p[j] < a.bucket) ones |= (p[j] & 1) << j;"),
    ("no walk math", "pass 1's write and terms at walk bins",
     """    write_from_mag<kRule>(a, base + k, r, m, magnitude(r, m),
                          (ones >> j) & 1u ? 1.f : -1.f, true, dr, di);
    add_terms(f, r, m, dr, di, v, x, h);""",
     "    v = add(v, r); x = add(x, m); h = add(h, (ones >> j) & 1u ? r : m);"),
    ("no apply math", "the apply pass's write and boost (not |C|)",
     """    write_from_mag<kRule>(a, base + k + e, r[e], m[e], mag[e],
                          (ones >> e) & 1u ? 1.f : -1.f, (ins >> e) & 1u,
                          dr[e], di[e]);
    boosted(f, bb, q, r[e], m[e], dr[e], di[e]);""",
     """    dr[e] = (ones >> e) & 1u ? mul(mag[e], bb) : r[e];
    di[e] = (ins >> e) & 1u ? mul(mag[e], q) : m[e];"""),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else (
        REPO / "build" / "k3_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / "corner_write_floor.cu"
    flags = _build.NVCC_FLAGS + _build.NVCC_SOURCE_FLAGS[src.name]
    work = REPO / "build" / "k3_ablation"
    work.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    cmds, libs = [], {}
    for name, _, old, new in VARIANTS:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: its text is not in {src}")
        cu = work / (name.replace(" ", "_") + ".cu")
        cu.write_text(text.replace(old, new))
        libs[name] = cu.with_suffix(".so")
        cmds.append(([_build.nvcc(), *flags, str(cu)], libs[name]))
    _build._compile(cmds)
    ptxas = subprocess.run([_build.nvcc(), *flags, "-Xptxas", "-v", str(src),
                            "-o", str(work / "committed.so")],
                           capture_output=True, text=True, check=True)
    report = (ptxas.stdout + ptxas.stderr).splitlines()
    for i, line in enumerate(report):
        if "Compiling entry function" in line and "resident_kernel" in line:
            used = [s.strip() for s in report[i + 1:i + 4]
                    if "Used" in s or "spill" in s]
            log(f"ptxas {line.split(chr(39))[1][-60:]}: {'; '.join(used)}")

    dev = torch.device("cuda", 0)
    planes = chip_smoke._grid_nchw(dev, chip_smoke.UHD_B, chip_smoke.UHD_H,
                                   chip_smoke.UHD_W)
    cr, ci, maps, frame, _, rep = chip_smoke._write_inputs(planes, 1024,
                                                           1024, 30)
    del planes
    ca, sa = pb._cos_sin(stt.Params().alpha)
    kw = dict(floor=0.45, img_pixels=float(chip_smoke.UHD_H
                                           * chip_smoke.UHD_W))
    grid = wk._resident_grid(cr[0].numel(), True, dev)
    others = {p: p for p in base.paths.values() if p != base.paths[
        wk.KERNEL_WRITE_FLOOR]}
    kernels = {"committed": base}
    kernels.update({name: _build.Kernels({**others, lib: lib})
                    for name, lib in libs.items()})

    def call(name, frm=rep, **extra):
        def fn():
            _build._kernels = kernels[name]
            wk._GRIDS.clear()
            return wk._write_floor(cr, ci, maps[0], frm, ca, sa, **kw,
                                   **extra)
        return fn

    runs = {name: (call(name, ifft_operands=True), 10) for name in kernels}
    runs["committed, u8 frame"] = (call("committed", frame,
                                        ifft_operands=True), 10)
    runs["committed, f32"] = (call("committed"), 10)
    runs["committed, two-pass, u8 frame"] = (call(
        "committed", frame, ifft_operands=True, schedule="two_pass"), 10)
    times = chip_smoke._turns(runs, rounds=3)
    what = {name: drop for name, drop, _, _ in VARIANTS}
    for name in kernels:
        ns = torch.zeros((grid, len(wk.PHASES)), dtype=torch.int64,
                         device=dev)
        call(name, ifft_operands=True, phase_ns=ns)()
        torch.cuda.synchronize()
        ms = (ns.double().mean(0) / 1e6).tolist()
        phases = ", ".join(f"{p} {m!r}" for p, m in zip(wk.PHASES, ms))
        log(f"K3 {name}" + (f" (drops {what[name]})" if name in what
                            else "") + f": {times[name]!r} ms; phases, ms "
            f"a block: {phases} ({card})")
    for name in runs:
        if name not in kernels:
            log(f"K3 {name}: {times[name]!r} ms ({card})")
    _build._kernels = base
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
