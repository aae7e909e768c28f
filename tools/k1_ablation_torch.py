"""What stage 2's prep costs inside K1's epilogue, on one CUDA card: K1 (the
forward DFT's stage 1) with and without the prep, beside the prep pass it
replaces.

    python3 tools/k1_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shapes (4K B=64, the bench covers of chip_smoke.py, and
the same covers cropped to 2160x3839: the TMA and the load route) it first
checks that K1's outputs with and without the prep are bit-equal, the
copies equal .to(bf16), the energies equal stage1_energy_plain's and lie
within 2^-24 of the exact sum, and counts the planes whose top-64 band
differs from the prep pass's. Then, by CUDA events, in turns: K1 alone
(prep 0); K1 writing the bf16 copies (prep 1, the bf16 and mix_split
modes); K1 writing the copies and the energies' partials (prep 2,
mix_adaptive); the prep pass (stage2_prep) and the reduce (prep_reduce);
K1 + prep pass against K1 (prep 2) + reduce. Each difference that matters
is also timed in launches paired back to back (chip_smoke._paired), which
the card's drift over a call does not move as it moves turns. Variants
(text edits of the committed source, built beside it) take one piece of
the epilogue's work away: they compute a wrong result by design and are
timed, never used. With --parent REV (more than once for several) it also
builds commit REV's corner_stage1_wgmma.cu (tools/parent_kernels_torch.py:
from git, or from build/parents/REV/ where the checkout has no history,
or a source put there by hand as revision REV), checks that its ar and ai
equal the committed K1's bit for bit and times it beside K1 (and, where
it takes the committed signature, with the prep beside the committed
prep); a parent up to 5b99743 (an exr-then-exi table, no prep) binds
through parent_kernels_torch.OLD_SIGNATURES with its own table layout
(parent_launcher). First each build's ptxas report. Prints one line each
with the card's name and power limit, and writes them to OUT (default
build/k1_ablation.txt).
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SOURCE = "corner_stage1_wgmma.cu"

# (name, what the edits take away, [(the committed text, its replacement)])
VARIANTS = [
    ("no f32 stores", "ar and ai not stored (what the f32 stores cost; the "
     "copies and energies still made)",
     [("              *reinterpret_cast<float4*>(o.ar + m * Kx + c) = "
       "v[u][0];\n"
       "              *reinterpret_cast<float4*>(o.ai + m * Kx + c) = "
       "v[u][1];\n", "")]),
    ("no bf16 stores", "the copies not stored (what their stores cost)",
     [("              if (live && c + 8 <= Kx) {\n"
       "                *reinterpret_cast<uint4*>(dst) = row;\n"
       "              } else if (live && c + 4 <= Kx) {  // Kx % 8 == 4\n"
       "                *reinterpret_cast<uint2*>(dst) = make_uint2(row.x, "
       "row.y);\n"
       "              }\n", "")]),
    ("energies without the f64 converts", "each energy's bits taken as an "
     "f64's high word in place of its conversion (what the converts cost)",
     [("          const double ea = inA ? (double)sq2(d[j], d[j + 64]) : 0.0;\n"
       "          const double eb = inB ? (double)sq2(d[j + 2], d[j + 66]) : "
       "0.0;",
       "          const double ea = inA ? __hiloint2double(__float_as_int("
       "sq2(d[j], d[j + 64])), 0) : 0.0;\n"
       "          const double eb = inB ? __hiloint2double(__float_as_int("
       "sq2(d[j + 2], d[j + 66])), 0) : 0.0;")]),
    ("energies not run", "the energies' code built but skipped at run "
     "time (what their code costs the rest of the kernel)",
     [("      if constexpr (kPrep == PREP_ENERGIES)\n"
       "        energy_partials(d, red, o.part, m0, (int)mA, (int)mB, M, H, "
       "Kx, k0);",
       "      if constexpr (kPrep == PREP_ENERGIES)\n"
       "        if (Kx < 0)\n"
       "          energy_partials(d, red, o.part, m0, (int)mA, (int)mB, M, "
       "H, Kx, k0);")]),
    ("energies without their terms", "each lane's two-row sums replaced by "
     "a constant (what the squares, converts and first adds cost)",
     [("          v[2 * i + e] = ea + eb;",
       "          v[2 * i + e] = (double)(i + e);")]),
    ("energies without the cross-warp sum", "the shared-memory sum of the "
     "8 warps and its two barriers a round: each warp's own sums stored",
     [("      consumer_sync();\n      const int c = k0 + 64 * r + "
       "(int)threadIdx.x;\n      if (threadIdx.x < RED_COLS && c < Kx) {",
       "      const int c = k0 + 64 * r + (int)threadIdx.x;\n"
       "      if (threadIdx.x < RED_COLS && c < Kx) {"),
      ("        out[c] = s;\n      }\n      consumer_sync();",
       "        out[c] = s;\n      }")]),
    ("energies without the shuffles", "the warps' butterfly: each lane "
     "stores its own two rows' sums",
     [("        w[k] = (b4 ? v[8 + k] : v[k]) +\n"
       "               __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[8 + k], 16);",
       "        w[k] = (b4 ? v[8 + k] : v[k]);"),
      ("        y[k] = (b3 ? w[4 + k] : w[k]) +\n"
       "               __shfl_xor_sync(0xffffffffu, b3 ? w[k] : w[4 + k], 8);",
       "        y[k] = (b3 ? w[4 + k] : w[k]);"),
      ("        z[k] = (b2 ? y[2 + k] : y[k]) +\n"
       "               __shfl_xor_sync(0xffffffffu, b2 ? y[k] : y[2 + k], 4);",
       "        z[k] = (b2 ? y[2 + k] : y[k]);")]),
]
ROUNDS = 5  # turns of every run
PAIRS = 24   # launch pairs of each paired comparison


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _args(argv):
    """(the revisions of each --parent REV, in order; the other
    arguments)."""
    parents, rest, it = [], [], iter(argv)
    for a in it:
        if a == "--parent":
            parents.append(next(it))
        else:
            rest.append(a)
    return parents, rest


def old_table(t, Kx: int):
    """stage1_tables' paired table t (2 Kxh, Wp) laid out as K1 took it up to
    5b99743: exr rows [0, Kx), exi rows [Kxp, Kxp + Kx), Kxp = Kx rounded
    up to 64, zeros elsewhere (the same k_order columns)."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    Kxp = ck._pad64(Kx)
    rr, ri = (r.to(t.device) for r in ck.stage1_rows(Kx))
    out = torch.zeros((2 * Kxp, t.shape[1]), dtype=t.dtype, device=t.device)
    out[:Kx] = t[rr]
    out[Kxp:Kxp + Kx] = t[ri]
    return out


def parent_launcher(kernels, source, x, t, Kx: int, center: bool, ar, ai,
                    copies=None, part=None):
    """A function that launches K1 of a parent build (`kernels`, its .cu
    `source`) on images x (..., H, W) u8 into ar, ai (..., H, Kx) f32, with
    stage1_tables' table t (the centered one where `center`), on the route
    the committed wrapper picks. A parent that takes OLD_SIGNATURES' form
    gets old_table(t), built once here; one that takes the committed form
    also writes the bf16 copies into `copies` (corner_kernels._copies) and
    the energies' partials into `part` where they are given."""
    import torch

    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    H, W = x.shape[-2:]
    P = x.numel() // (H * W)
    tma = int(ck.route_for(W, x.data_ptr()) == ck.KERNEL_TMA)
    if pk.takes_old_signature(source, "corner_stage1_wgmma"):
        entry = pk.old_entry(kernels.paths["corner_stage1_wgmma"],
                             "corner_stage1_wgmma")
        t = old_table(t, Kx)
        args = (x.data_ptr(), t.data_ptr(), ar.data_ptr(), ai.data_ptr(), P,
                H, W, Kx, t.shape[0] // 2, t.shape[1], int(center), tma)
    else:
        entry = kernels.corner_stage1_wgmma
        prep = 0 if copies is None else 1 if part is None else 2
        ptrs = (0, 0) if copies is None else (copies.data_ptr(),
                                               copies[1].data_ptr())
        args = (x.data_ptr(), t.data_ptr(), ar.data_ptr(), ai.data_ptr(),
                *ptrs, 0 if part is None else part.data_ptr(), P, H, W, Kx,
                t.shape[0] // 2, t.shape[1],
                0 if copies is None else copies.shape[-1], int(center), tma,
                prep)

    def launch():
        rc = entry(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent K1: CUDA error {rc}")
    launch.table = t  # keeps the table alive as long as the launcher
    return launch


def parent_stage1(kernels, source, x, t, Kx: int, center: bool):
    """parent_launcher's K1 run once: ((..., H, Kx) ar, ai)."""
    import torch

    ar, ai = (torch.empty((*x.shape[:-1], Kx), dtype=torch.float32,
                          device=x.device) for _ in range(2))
    parent_launcher(kernels, source, x, t, Kx, center, ar, ai)()
    return ar, ai


def main(argv=None) -> int:
    import torch

    parents, rest = _args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    missing = [r for r in parents if pk.parent_source(r, SOURCE) is None]
    if missing:
        print(f"k1_ablation_torch: no {SOURCE} of {missing[0]}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_ablation_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    out = pathlib.Path(rest[0]) if rest else (
        REPO / "build" / "k1_ablation.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    card = chip_smoke.phase_probe()
    base = _build.kernel_library()
    src = _build.CSRC / SOURCE
    work = REPO / "build" / "k1_ablation"
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
        cu = work / (name.replace(" ", "_").replace("-", "_") + ".cu")
        cu.write_text(t)
        sources[name] = cu
    pnames = {f"parent {r[:12]}": pk.parent_source(r, SOURCE)
              for r in parents}
    sources.update(pnames)
    kernels, reports = _build.build_variants(SOURCE, sources, work)
    for name, report in reports.items():
        keep = [s.strip() for s in report.splitlines()
                if "Used" in s or "spill" in s or "Compiling entry" in s]
        log(f"K1 {name}: ptxas {'; '.join(keep)}")
    kernels["committed"] = base

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    covers = chip_smoke._grid_nchw(dev, B, H, W)
    for w in (W, W - 1):
        x = covers[..., :w].contiguous()
        Ky, Kx = corner.corner_dims(H, w, stt.Params().rmax)
        tabs = corner.dft_tables_device(H, Ky, w, Kx, dev)
        route = ck.route_for(w, x.data_ptr())
        what = f"4K B={B} at {w} ({route})"
        planes = x.reshape(-1, H, w)
        P = planes.shape[0]
        t = tabs.stage1[0]
        ar, ai = ck.fwd_stage1(planes, tabs.exr16, tabs.exi16, False,
                               tabs.stage1)
        fr, fi, (f16r, f16i, energy) = ck.fwd_stage1(
            planes, tabs.exr16, tabs.exi16, False, tabs.stage1, "energies")
        torch.cuda.synchronize()
        same = torch.equal(ar, fr) and torch.equal(ai, fi)
        copies = (torch.equal(f16r, ar.to(torch.bfloat16))
                  and torch.equal(f16i, ai.to(torch.bfloat16)))
        del fr, fi
        prep = ck.stage2_prep(ar, ai)
        worst, twin, moved = 0.0, True, 0
        for p0 in range(0, P, 16):  # the exact sums 16 planes at a time
            a, b = ar[p0:p0 + 16], ai[p0:p0 + 16]
            exact = torch.sum((a * a + b * b).double(), dim=1)
            e = energy[p0:p0 + 16]
            worst = max(worst, ((e.double() - exact).abs()
                                / exact).max().item())
            twin = twin and torch.equal(e, ck.stage1_energy_plain(a, b))
        mine = corner.band_topk(energy, 64).sort(1).values
        theirs = corner.band_topk(prep[2], 64).sort(1).values
        moved = int((mine != theirs).any(1).sum().item())
        log(f"K1 {what}: ar, ai with the prep bit-equal to K1's alone "
            f"{same}; copies equal .to(bf16) {copies}; energies equal "
            f"stage1_energy_plain's {twin}, worst relative error against "
            f"the exact sum {worst!r} (bound 2^-24 = {2.0 ** -24!r}); "
            f"planes whose top-64 band differs from the prep pass's: "
            f"{moved} of {P}")
        for pname, psrc in pnames.items():
            pr, pi = parent_stage1(kernels[pname], psrc, planes, t, Kx,
                                   False)
            torch.cuda.synchronize()
            log(f"K1 {what}: committed against {pname}: ar, ai bit-equal "
                f"{torch.equal(ar, pr) and torch.equal(ai, pi)}")
            del pr, pi
        del prep
        torch.cuda.empty_cache()

        copies_buf = ck._copies(P, H, Kx, dev)
        part = torch.empty((ck.energy_slots(P, H), Kx), dtype=torch.float64,
                           device=dev)

        def k1(lib, prep_flag):
            kern = kernels[lib]
            ptrs = {0: (0, 0, 0),
                    1: (copies_buf.data_ptr(), copies_buf[1].data_ptr(), 0),
                    2: (copies_buf.data_ptr(), copies_buf[1].data_ptr(),
                        part.data_ptr())}[prep_flag]

            def fn():
                rc = kern.corner_stage1_wgmma(
                    planes.data_ptr(), t.data_ptr(), ar.data_ptr(),
                    ai.data_ptr(), *ptrs, P, H, w, Kx, t.shape[0] // 2,
                    t.shape[1], copies_buf.shape[-1], 0,
                    int(route == ck.KERNEL_TMA), prep_flag,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{lib} prep {prep_flag}: CUDA "
                                       f"error {rc}")
            return fn

        launch = {"K1": k1("committed", 0),
                  "K1 + copies": k1("committed", 1),
                  "K1 + copies + energies": k1("committed", 2)}
        for name, _, _ in VARIANTS:
            launch[f"K1 + copies + energies, {name}"] = k1(name, 2)
        for pname, psrc in pnames.items():
            launch[pname] = parent_launcher(kernels[pname], psrc, planes, t,
                                            Kx, False, ar, ai)
            if not pk.takes_old_signature(psrc, "corner_stage1_wgmma"):
                launch[f"{pname} + copies + energies"] = parent_launcher(
                    kernels[pname], psrc, planes, t, Kx, False, ar, ai,
                    copies_buf, part)
        prep_pass = lambda: ck.stage2_prep(ar, ai)  # noqa: E731
        reduce = lambda: ck.prep_reduce(part, P, H)  # noqa: E731
        launch["K1, then the prep pass"] = lambda: (launch["K1"](),
                                                    prep_pass())
        launch["K1 + copies + energies, then the reduce"] = lambda: (
            launch["K1 + copies + energies"](), reduce())
        runs = {name: (fn, 3) for name, fn in launch.items()}
        runs.update({"prep pass": (prep_pass, 10), "reduce": (reduce, 50)})
        times = chip_smoke._turns(runs, rounds=ROUNDS)
        for name in runs:
            log(f"K1 {what}, {name}: median {_median(times[name])!r} of "
                f"{times[name]!r} ms ({card})")
        # the differences that matter, each from launches paired back to
        # back (chip_smoke._paired): what the epilogue adds to K1, what each
        # piece of it costs, and what the fused route saves against the
        # prep pass
        pairs = [("K1", "K1 + copies"), ("K1 + copies",
                                        "K1 + copies + energies"),
                 ("K1", "K1 + copies + energies"),
                 ("K1 + copies + energies, then the reduce",
                  "K1, then the prep pass")]
        pairs += [(f"K1 + copies + energies, {name}", "K1 + copies + energies")
                  for name, _, _ in VARIANTS]
        pairs += [(pname, "K1") for pname in pnames]
        pairs += [(f"{pname} + copies + energies", "K1 + copies + energies")
                  for pname in pnames
                  if f"{pname} + copies + energies" in launch]
        for a, b in pairs:
            got = chip_smoke._paired(launch[a], launch[b], PAIRS)
            qa = sorted(x[0] for x in got)
            qb = sorted(x[1] for x in got)
            dq = sorted(y - x for x, y in got)
            n = len(got)
            log(f"K1 {what}, paired ({n} pairs): [{b}] - [{a}]: median "
                f"{dq[n // 2]!r} ms, quartiles {dq[n // 4]!r} .. "
                f"{dq[3 * n // 4]!r}; medians {qa[n // 2]!r} / {qb[n // 2]!r} "
                f"ms ({card})")
        del copies_buf, part, ar, ai, energy, f16r, f16i
        torch.cuda.empty_cache()
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
