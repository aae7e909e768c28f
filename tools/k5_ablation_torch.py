"""Where K5 (the extract's walk read and decode) spends its time on one
CUDA card: its design's choices, each against the committed build.

    python3 tools/k5_ablation_torch.py [--parent REV ...] [OUT]

At the main path's shape (4K, B=64: the forward corner spectrum of
chip_smoke.py's bench covers as the extract computes it, and phase 4's
16 KB walk with its read plan) it builds variants of
steganosaurus_tpu_torch/csrc/corner_read_decode.cu, each a few text edits
of the committed source and, where a variant needs it, read_kernels
constants to match, and times them in turns with the committed build and
the lone gather ci[:, plane, y, x] by CUDA events, as the fused pass calls
K5 (hard and bf16 soft rows). A variant that drops work ("no soft row",
the "phase ... alone" diagnostics) or races ("no grid barriers") computes
a wrong result by design: it is timed, never used; every other variant's
rows are checked equal to the committed build's. With --parent REV it
also builds REV's corner_read_decode.cu (tools/parent_kernels_torch.py:
from git, or a source put by hand under build/parents/REV/), binds its C
entry with the signature of the commits whose K5 was the gather alone
(parent_kernels_torch.OLD_SIGNATURES: the walk's int64 indices, no plan),
launches it as their wrapper did, times it in the same turns and checks
its rows. Then at each B of SMALL_B (the first images) the committed build,
each parent and the lone gather in turns; and the serve worker's single
extract (its hinted extract_batch of one 4K stego, 16 KB, from host
memory: pipeline/serve.py _extract_one) end to end by the host's clock,
with K5 the committed build's and each parent's in turns. First each
build's ptxas report (registers, spills). Prints one line each with the
card's name and power limit, and writes them to OUT (default
build/k5_ablation.txt).
"""

from __future__ import annotations

import pathlib
import re
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "corner_read_decode.cu"

# (name, what the edits change, [(the committed text, its replacement)],
# whether its rows are the committed build's, {read_kernels constant: its
# value for the variant})
VARIANTS = [
    ("chunks of 4", "4 images a chunk: a slot's scratch entry 16 bytes, "
     "16 chunks at B=64",
     [("constexpr int CHUNK = 8;", "constexpr int CHUNK = 4;")], True,
     {"CHUNK_IMAGES": 4}),
    ("L2 policies off", "no evict-first hint on the stream's copies, no "
     "evict-last on the scratch's stores",
     [('"cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\\n"',
       '"cp.async.cg.shared.global [%0], [%1], 16;\\n"'),
      ('"st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\\n"',
       '"st.global.v4.f32 [%0], {%1, %2, %3, %4};\\n"')], True, {}),
    ("3 stages", "a ring of 3 stages (two rows ahead)",
     [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")], True, {}),
    ("1 block an SM", "a grid of one block an SM",
     [("o.sms * o.per_sm[jit][vec]", "o.sms")], True, {}),
    ("tiles of 2048", "plan tiles of 2048 floats, blocks of 512 threads "
     "(one an SM)",
     [("constexpr int WARPS = 8;", "constexpr int WARPS = 16;"),
      ("constexpr int TILE = 1024;", "constexpr int TILE = 2048;")], True,
     {"TILE": 2048, "MASK_WORDS": 8}),
    ("phase A alone", "no decode (a diagnostic: no rows)",
     [("    decode_chunk(a, c, reinterpret_cast<float4*>(smem));\n", "")],
     False, {}),
    ("phase B alone", "no stream: the decode from a scratch left as it was "
     "(a diagnostic)",
     [("    stream_chunk<JIT, VEC>(a, c, smem);\n", "")], False, {}),
    ("phase A alone, no scratch stores", "phase A alone without its "
     "scratch stores (a diagnostic)",
     [("    decode_chunk(a, c, reinterpret_cast<float4*>(smem));\n", ""),
      ("  store16(a.scratch + (long long)s * CHUNK + part * 4,",
       "  if (s < 0) store16(a.scratch + (long long)s * CHUNK + part * 4,")],
     False, {}),
    ("phase A alone, no stream", "phase A alone without its copies of the "
     "spectrum (a diagnostic)",
     [("    decode_chunk(a, c, reinterpret_cast<float4*>(smem));\n", ""),
      ("        copy16(dst, src, pol);",
       "        if (a.B < 0) copy16(dst, src, pol);")],
     False, {}),
    ("no grid barriers", "a block barrier in place of each grid barrier "
     "(a diagnostic: the blocks' phases race)",
     [("    grid_barrier(a.arrive, target);\n    decode_chunk",
       "    __syncthreads();\n    decode_chunk"),
      ("if (c + 1 < chunks) grid_barrier(a.arrive, target);",
       "if (c + 1 < chunks) __syncthreads();")], False, {}),
    ("no soft row", "the soft row's rounding, sums, ballot and store",
     [("  if (a.soft_mode) {", "  if (a.soft_mode && a.B < 0) {")], False,
     {}),
]

ROUNDS = 5  # turns of every build
SMALL_B = (1, 2, 3, 4, 8)  # batches timed on the committed build and parents
SERVE_CALLS = 10  # single extracts a turn
# the gather's launch (read_kernels of the commits whose K5 it was): output
# words (warps) a block, and image groups (grid.y) for about GRID_FILL
# blocks an SM
GATHER_WORDS_PER_BLOCK = 32
GATHER_GRID_FILL = 2


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _gather_read_decode(entry):
    """read_decode as the commits whose K5 was the gather alone launched
    it, through their C entry `entry` (bound with their signature); the
    plan is not read."""
    import torch

    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    def ptr(t):
        return None if t is None else t.data_ptr()

    def read_decode(ci, plane, y, x, ssa, cr=None, cjd=None, sjd=None, *,
                    hdr_stream_bits, payload_rep, hard=True, soft=None,
                    plan=None):
        n = plane.shape[0]
        B, _, Ky, Kx = ci.shape
        hw, pw, cw = rk.row_words(n, hdr_stream_bits, payload_rep,
                                  bool(soft))
        dev = ci.device
        hard_rows = (torch.empty((B, hw + pw), dtype=torch.int32, device=dev)
                     if hard else None)
        soft_rows = (torch.empty((B, hw + pw + cw), dtype=torch.int32,
                                 device=dev) if soft else None)
        blocks = (-(-hw // GATHER_WORDS_PER_BLOCK)
                  + -(-pw // GATHER_WORDS_PER_BLOCK))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        groups = max(1, min(B, GATHER_GRID_FILL * sms // blocks))
        rc = entry(ci.data_ptr(), ptr(cr if cjd is not None else None),
                   plane.data_ptr(), y.data_ptr(), x.data_ptr(), ptr(cjd),
                   ptr(sjd), ptr(hard_rows), ptr(soft_rows), B, Ky, Kx, n,
                   hdr_stream_bits, payload_rep, rk.SOFT_MODES[soft], groups,
                   float(ssa), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's K5 failed: CUDA error {rc}")
        return hard_rows, soft_rows

    return read_decode


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
    sources = {}
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
    gathers = {pname: _gather_read_decode(pk.old_entry(
        kernels[pname].paths["corner_read_decode"], "corner_read_decode"))
        for pname in pnames}

    dev = torch.device("cuda", 0)
    B, H, W = chip_smoke.UHD_B, chip_smoke.UHD_H, chip_smoke.UHD_W
    covers = chip_smoke._grid_nchw(dev, B, H, W)
    p = stt.Params()
    pl, yy, xx, _, Ky, Kx, _ = chip_smoke._read_walk(dev, H, W,
                                                     chip_smoke.UHD_SECRET)
    plans = {}

    def plan_for(tile: int):  # the plan of the variant's tile size
        if tile not in plans:
            plans[tile] = rk.read_plan(pl, yy, xx, Ky, Kx)
        return plans[tile]

    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    _, ci = corner.fwd_corner(covers, p.center, Ky, Kx, tabs,
                              corner.precision())
    del covers, tabs
    ssa = pb._sign_sin(p.alpha)
    kw = dict(hdr_stream_bits=912, payload_rep=7, soft="bf16")

    patches = {name: patch for name, _, _, _, patch in VARIANTS}
    defaults = {k: getattr(rk, k) for patch in patches.values()
                for k in patch}

    def call(name, spec=ci):
        if name in gathers:
            return lambda: gathers[name](spec, pl, yy, xx, ssa, **kw)

        def fn():
            _build._kernels = kernels[name]
            for k, v in {**defaults, **patches.get(name, {})}.items():
                setattr(rk, k, v)
            return rk.read_decode(spec, pl, yy, xx, ssa,
                                  plan=plan_for(rk.TILE), **kw)
        return fn

    def check(name, spec=ci, what=""):
        want = call("committed", spec)()
        got = call(name, spec)()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K5 {name!r}: rows differ from the "
                                 f"committed build's{what}")

    for name in [name for name, _, _, same, _ in VARIANTS if same] + pnames:
        check(name)
    runs = {name: (call(name), 10) for name in kernels}
    runs["lone gather"] = (lambda: ci[:, pl, yy, xx], 10)
    for name, (fn, _) in runs.items():  # a fault names its build
        print(f"K5 {name}: a first call", flush=True)
        fn()
        torch.cuda.synchronize()
    times = chip_smoke._turns(runs, rounds=ROUNDS)
    what = {name: change for name, change, _, _, _ in VARIANTS}
    for name in runs:
        log(f"K5 {name}" + (f" (changes {what[name]})" if name in what
                            else "") + f": median {_median(times[name])!r} "
            f"of {times[name]!r} ms at 4K B={B} ({card})")

    for b in SMALL_B:
        few = ci[:b]
        runs = {"committed": (call("committed", few), 20)}
        for pname in pnames:
            check(pname, few, f" at B={b}")
            runs[pname] = (call(pname, few), 20)
        runs["lone gather"] = (lambda: few[:, pl, yy, xx], 20)
        times = chip_smoke._turns(runs, rounds=ROUNDS)
        for name in runs:
            log(f"K5 B={b} {name}: median {_median(times[name])!r} of "
                f"{times[name]!r} ms at 4K B={b} ({card})")
    _build._kernels = base
    for k, v in defaults.items():
        setattr(rk, k, v)
    del ci, plans
    torch.cuda.empty_cache()

    # the serve worker's single extract, end to end
    cover = chip_smoke.make_covers(1, H, W)
    secret = chip_smoke.secrets_for(1, chip_smoke.UHD_SECRET)
    stego = stt.embed_batch(cover, secret, master_key=chip_smoke.MASTER_KEY,
                            params=p, device=dev).stego
    stego = stego.cpu().numpy() if torch.is_tensor(stego) else stego
    committed = rk.read_decode
    builds = {"committed": committed, **gathers}

    def extract():
        got = stt.extract_batch(stego, master_key=chip_smoke.MASTER_KEY,
                                params=p, clen_hint=chip_smoke.UHD_SECRET,
                                device=dev)
        if got != secret:
            raise AssertionError("the single extract lost its secret")

    wall = {name: [] for name in builds}
    n = dict(rk.LAUNCHES)
    try:
        for name, fn in builds.items():  # warm: the walk, its plan, K1
            rk.read_decode = fn
            extract()
        for _ in range(ROUNDS):
            for name, fn in builds.items():
                rk.read_decode = fn
                t = time.perf_counter()
                for _ in range(SERVE_CALLS):
                    extract()
                wall[name].append((time.perf_counter() - t) * 1e3
                                  / SERVE_CALLS)
    finally:
        rk.read_decode = committed
    if rk.LAUNCHES[rk.KERNEL_READ_DECODE] - n[rk.KERNEL_READ_DECODE] != \
            SERVE_CALLS * ROUNDS + 1:
        raise AssertionError("the committed build's turns did not launch K5 "
                             "once an extract")
    for name in builds:
        log(f"serve single extract (4K, 16 KB, hinted extract_batch from "
            f"host memory), K5 {name}: median {_median(wall[name])!r} of "
            f"{wall[name]!r} ms a call, host wall ({card})")
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
