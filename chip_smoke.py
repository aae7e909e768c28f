"""Smoke run of the PyTorch + CUDA port (steganosaurus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It builds
the port's kernels and the host native library from the checkout's sources,
holds every kernel of the main path against its plain PyTorch version,
drives the main path (embed_batch -> extract_batch) at 4K UHD, B=64, 16 KB
secrets, then the serving surface (streams, rotating salts and keys, the
channel report and quality, the soft-decision retry, ragged secrets with
verify and jitter), every corner wire mode (soft write, alpha spread, QIM,
RS, padding, per-image walks, Params.stealth() at 4K), the single-image
embed_array -> extract_array in every wire mode, the full-grid
adaptive_alpha batch and a batch extraction with coherent rows, then the
user-facing surface (the `turtlefft serve` worker in process and as a
process of its own, and the `turtlefft` CLI's one-shot modes), and prints
one line per measurement. The last two lines
are JSON: the per-kernel record, then the device record. Any failure raises,
and the process exits non-zero without printing them. Without CUDA, or
without the package beside this file, it exits non-zero at once.

Phases:
  1. probe   card name, power limit, CUDA and nvcc versions
  2. build   host native library + csrc/*.cu kernel library, timed
  3. K1      both routes of the stage-1 kernel (csrc/corner_stage1_wgmma.cu)
             vs their plain version, max|kernel - plain| <= 1e-5 *
             max|plain|: the TMA route (W % 16 == 0, aligned base) at the
             main path's shape, at 1080p B=8, at the 512x512 B=8 grid of
             phase 4 and at edge shapes; the load route (any other W or
             base) at the 4K batch cropped to 3839 columns, forced at the
             main path's shape, at the 1079x1917 B=4 grid of 4b, at a phone
             screenshot (1170x2532 B=8), at odd-width edge shapes and at
             views whose base is not 16-byte aligned. cuobjdump shows HGMMA
             and UTMALDG in both instantiations; both routes and the
             library call torch.mm(x_bf16, T.T, out_dtype=f32), with and
             without the u8 -> bf16 cast, timed in turns at 4K (3840 and
             3839 columns) beside the bound; the load route, its plain
             version and the library call again at the 4b grid; the TMA
             route at the serve worker's shapes (4K B=1 and B=32: P=3 and
             P=96) against its plain version, then timed in turns with it
             and the library call. The load route must beat the library
             call at 3839 and at the 4b grid
  4. path    512x512, B=8, 100 B round trip (also held against the port on
             the CPU), then 2160x3840, B=64, 16 KB: all secrets recovered,
             K1 launched on the TMA route alone, warm timings, PSNR, peak
             memory
  4b. ragged 1079x1917, B=4, 1 KB round trip: W % 16 != 0, so stage 1
             goes through the load route alone
  4c. odd 4K phase 4's covers cropped to 2160x3839, B=64, 16 KB: 64/64
             through the load route alone, warm embed and extract ms beside
             phase 4's, PSNR, peak memory
  5a. stream embed_stream -> extract_stream of the 4K batch, depth 2,
             fixed salts: 64/64 every batch, images/s beside the serialized
             loop's, peak memory with two batches in flight; first one
             embed + extract dispatch under torch.cuda sync debug mode
             "error" (queuing a batch must not wait for the card)
  5b. rotate the stream with fresh salts every batch and a second master
             key from the second half on: recovery must be 1.0
  5c. BER    channel_report and quality_device on the stego of 5a: payload
             post-ECC BER 0, raw BER, header post-ECC, PSNR and SSIM
  5d. soft   the soft-decision margin workload (256x256 noise cover, 240 B,
             B=8): the soft decode must recover more than the hard one
  5e. ragged 1080p, B=8, 100 B to 4 KB secrets, verify=True, then jitter
             0.2: all verified and read back; card stegos held against the
             port's CPU stegos of the same inputs (+-1, cross-decode)
  5f. modes  1080p, B=8, 4 KB, fixed salts, one Params per wire mode
             (soft_write, alpha_spread=0.5, qim=3, rs, pad_quantum=1024,
             per_image_walk, Params.stealth()): 8/8 on the card, card vs
             CPU port stego +-1 (ripple planes of threshold rules counted
             and bounded; none when the CPU port writes on the card's own
             spectrum), cross-decode 8/8 both ways; planted faults of the
             QIM write held against the same bounds; then a mixed batch of
             every jitter-0 mode read in one extract_batch call, 8/8
  5g. stealth Params.stealth() at 4K, B=16, 16 KB: 16/16, warm embed and
             extract ms, host walk seconds cold and warm, PSNR beside the
             default write's, peak memory; then a 3-batch stealth stream
             beside the serialized loop (images/s, host CPU seconds, walk
             cache left empty)
  5h. RS pad Params(rs=True, pad_quantum=4096) at 4K, B=64, 16 KB: 64/64,
             warm round trip with its host RS coding timed inside it,
             channel_report payload post-ECC BER 0, PSNR
  7a. single embed_array -> extract_array of a 4K bench cover, 16 KB,
             default Params, at salts 0, 1 and 2: the header misses at
             salts 0 and 1 and reads back at salt 2 (SINGLE_SALT_READS),
             on the card and in the CPU port alike, on the card's stegos
             and the CPU port's; each miss has one Rep-3 header group with
             two of its three slots read wrong, the same slots at both
             salts and on both readers, on weak cover bins (|F| printed
             beside the per-bin u8 rounding noise); extract_batch (its
             soft header) reads the missed stegos. Then cold and warm
             ms, device busy vs host wall, PSNR within 0.01 dB of the CPU
             port's on the same cover, torch.kthvalue vs the bisection
             median, bit-equal
  7b. single 1080p, 4 KB (1 KB coherent), one Params per wire mode
             (coherent, coherent + QIM, adaptive_alpha,
             cover_dependent_path and complex128 included), one salt
             each: round trip on the card (every embed pass on the card's
             TorchBackend; complex128 in f64 there), the CPU port reads
             each card stego, card vs CPU port bytes, coherent refine
             passes; cover-hash feature mismatches card vs CPU at 1080p
             and 4K
  7c. full-grid adaptive_alpha batch at 4K, B=16, 16 KB with verify=True:
             16/16, ms, PSNR, peak memory
  7d. mixed  extract_batch over standard stegos, coherent stegos and a plain
             cover at 1080p: every secret, None for the cover
  7e. wrong key  extract_batch of the 4K B=64 stegos under another key:
             every row fails both header parses and goes through
             extract_array, all None; cold and warm ms
  8a. serve  the `turtlefft serve` worker in process (serve_loop on a
             scripted request stream), warm-up 2160x3840:16384: embed and
             extract by PNG and by .npy, embed_batch of 8 PNGs, then
             extract_batch, stats; then a worker pinned to
             Params(cover_dependent_path=True): one embed and extract of
             a 4K midstep_cover. Every secret back; K1 counted per request
  8b. worker `python -m steganosaurus_tpu_torch.cli serve --key K --warmup
             2160x3840:16384` as its own process
             (tools/serve_latency_torch.measure): seconds to its ready line
             and its warm-up, warm client-side p50/p95 over 5 rounds of
             PNG embed, PNG extract, .npy embed and .npy extract at 4K 16
             KB, each round trip verified; its stats; exit code 0
  8c. CLI    the one-shot modes at 1080p, each its own process: gen-key
             --key-out --wrap-pass; embed and extract with that wrapped
             --key on the card and on the CPU (STEGANOSAURUS_PLATFORM=cpu),
             each reading the other's stego; extract under a wrong
             passphrase (rc 1, "Magic not found"); check (rc 0);
             batch-embed and batch-extract of 4 covers
Every path of phases 4-5, 7d-7e and the serve worker's B=1 and batch ops
(8a) must launch K1 (on the TMA route, corner_stage1_wgmma, or in 4b and
4c on the load route, corner_stage1_wgmma_ldg); the single-image paths,
the full-grid batch cores (7a-7c) and the cover-dependent worker (8a) run
torch.fft and must launch none. The launches are counted
per path and per route, and each (planes, H, W, Kx, center, route) the
paths hand the stage-1 wrapper is recorded.
  6. K1 shapes  every recorded shape that phase 3 did not check is held
             against the plain version, through the wrapper, on seeded u8
             images on the same route
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
PKG = REPO / "steganosaurus_tpu_torch"

UHD_H, UHD_W, UHD_B, UHD_BASE, UHD_SECRET = 2160, 3840, 64, 32, 16384
SMALL_H, SMALL_W, SMALL_B, SMALL_SECRET = 512, 512, 8, 100
MASTER_KEY = bytes(range(32))
MASTER_KEY2 = bytes(range(1, 33))
STREAM_BATCHES = 4
FHD_H, FHD_W, FHD_B = 1080, 1920, 8
K1_REL_TOL = 1e-5
# CPU reference check of the small phase: the card's bf16 products and the
# CPU's bf16 emulation round in different places, so a few pixels may land
# one step apart (the same bound as the CPU tests against the JAX package)
SMALL_MAX_DIFF_FRAC = 1e-3
# The same check at 1080p, B=8, 4 KB: more terms per pixel in every DFT
# sum and 448 bf16 columns per plane in forward stage 2 (192 at 512x512),
# so more pixels land one step apart. On the CPU the port and the JAX
# package already differ in 0.12% of these bytes, the card and the CPU
# port in 0.23%; every difference is +-1 and the stegos cross-decode.
FHD_MAX_DIFF_FRAC = 5e-3
# 5f, the wire modes at 1080p: 4 KB secrets. A write rule with a threshold
# (a QIM bin whose lattice coordinate sits on a half-step, a soft-write bin
# on its margin) can send one bin to another target when the card's and
# the CPU's forward spectra differ in the last bits; the decoded bit is
# the same, but its image-plane takes a low-frequency ripple that moves
# more than RIPPLE_FRAC of the plane's bytes by 1 (a "ripple plane"). 5f
# shows the cause each run: the CPU port fed the card's own forward
# spectrum writes a stego with no ripple plane against the card's. A
# ripple plane may move at most RIPPLE_MAX_FRAC of its bytes, and a
# threshold mode may show at most MODE_MAX_RIPPLE_PLANES of its 24 planes;
# both bounds sit between the readings of the correct rules and those of
# planted faults of the card-side QIM rule, which 5f also runs and which
# must fail them. First readings: the correct rules showed at most 7
# ripple planes, each with at most 3.0% of its bytes moved; the dither
# shift and floor-for-round faults 24 of 24, 88-92%, max |diff| 18-27;
# the CPU port on the card's spectrum no ripple plane.
MODE_SECRET = 4096
RIPPLE_FRAC = 0.01
RIPPLE_MAX_FRAC = 0.05
MODE_MAX_RIPPLE_PLANES = 12
# 5g: Params.stealth() at 4K, 16 KB: per-image walks cost one salt-keyed
# host expansion per image at embed and again at extract (8 threads); the
# stealth stream runs STEALTH_BATCHES batches with fresh salts
STEALTH_B = 16
STEALTH_BATCHES = 3
# 4b: a grid whose width is not a multiple of 16 (B, H, W)
RAGGED_GRID = (4, 1079, 1917)
# 7a: the single-image path's key (a fresh one, so its cold run pays the
# walk expansion) and the card-vs-CPU PSNR bound: the write is the same math
SINGLE_KEY = bytes(range(2, 34))
PSNR_TOL_DB = 0.01
# 7a: salt index -> whether the 4K round trip reads back. The header's walk
# is keyed by the key alone, so every salt writes its header on the same
# bins; under SINGLE_KEY two slots of one Rep-3 group (a bit of the magic)
# sit on weak cover bins, where the written phase's margin |F| sin(alpha)
# is within about 1.5x the per-bin u8 rounding noise, and where the salt's
# header bits make both read wrong, extract_array (in either package: it
# has no soft header trial) finds no magic. tests/test_torch_single.py
# holds the same mechanism against the JAX package on a smaller cover.
SINGLE_SALT_READS = {0: False, 1: False, 2: True}
# 7c: the adaptive_alpha batch (full-grid cores): B at 4K, 16 KB
ADAPTIVE_B = 16
# 7b, 7d: a coherent bit takes a whole (y, x) site, three plane-bins, so a
# 1080p cover carries ~1.6 KB coherently; the coherent rows carry 1 KB
COHERENT_SECRET = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def make_covers(B: int, h: int, w: int):
    """(B, h, w, 3) u8 gradient + [-18, 18] noise covers, seed 42: the
    benchmark recipe of the JAX package's bench (its first 32 4K covers are
    the pairs its record verified). Disk-cached under .cache/."""
    import numpy as np

    path = REPO / ".cache" / f"covers_{B}x{h}x{w}.npy"
    if path.exists():
        return np.load(path)
    rng = np.random.default_rng(42)
    base = np.linspace(150, 235, w)
    rows = []
    for _ in range(B):
        noise = rng.integers(-18, 19, (h, w, 3))
        rows.append(np.clip(base[None, :, None] + noise, 0, 255)
                    .astype(np.uint8))
    out = np.stack(rows)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, out)
    return out


def secrets_for(B: int, n: int) -> list[bytes]:
    import numpy as np

    rng = np.random.default_rng(7)
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for _ in range(B)]


def cuda_ms(fn, n: int) -> float:
    """Mean device milliseconds of fn() over n launches after one warm-up,
    by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_probe() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    from steganosaurus_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(card)
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    return card


def phase_build() -> None:
    from steganosaurus_tpu_torch import _build

    t = time.perf_counter()
    _build.ensure_native()
    log(f"build: host native library ready in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    _build.kernel_library()
    log(f"build: kernel library (nvcc, sm_90a) ready in "
        f"{time.perf_counter() - t:.3f} s")


# The card's peak rates for a kernel's bound (NVIDIA H100 SXM data sheet,
# dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Edge shapes of the stage-1 kernel: rows P*H not a multiple of its 128-row
# tile, Kx not a multiple of its 256-column tile, W a multiple of 16 but not
# of its 64-wide K block (the TMA route), P = 1, centering on and off; then
# widths that are not a multiple of 16 (the load route): W % 64 < 16,
# W < 16, W < 4 with P*H < 16, and the 4b grid's width at a small P*H.
K1_EDGES = [((1, 1, 67, 528), 45, True), ((2, 3, 67, 528), 1000, False),
            ((1, 3, 100, 256), 45, False), ((2, 3, 67, 512), 1000, True),
            ((1, 3, 37, 64), 64, True), ((2, 3, 67, 203), 45, True),
            ((2, 3, 100, 250), 130, False), ((1, 3, 37, 17), 17, True),
            ((1, 1, 5, 3), 3, False), ((1, 3, 301, 1917), 512, True)]
# A phone screenshot (landscape iPhone 12-14: 2532 x 1170), B=8
PHONE_GRID = (8, 1170, 2532)
# The serve worker's batch sizes at 4K (phase 8): a single embed or extract
# rides the batch path at B=1, a batch op runs batches of up to 32
SERVE_K1_B = (1, 32)
# 8a: PNG covers of the worker's embed_batch, and the cover-dependent
# worker's secret (a 4K midstep_cover, the single-image path)
SERVE_PNG_BATCH = 8
CDP_SECRET = 4096
# 8b: measured rounds of the four request classes; 8c: covers of the CLI's
# batch modes
SERVE_ROUNDS = 5
CLI_BATCH_B = 4


def _k1_err(out, ref):
    """(max_abs_err, max|plain|) of a kernel's (ar, ai) against the plain
    version's."""
    err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    scale = max(r.abs().max().item() for r in ref)
    return err, scale


def _k1_check(what: str, out, ref) -> float:
    err, scale = _k1_err(out, ref)
    log(f"K1 {what}: max_abs_err {err!r} max|plain| {scale!r} "
        f"rel {err / scale!r}")
    if not err <= K1_REL_TOL * scale:
        raise AssertionError(f"K1 {what} disagrees with its plain version: "
                             f"{err} > {K1_REL_TOL}*{scale}")
    return err


def k1_on_route(x, tables, Kx: int, center: bool, route: str):
    """The stage-1 kernel on `route`, through the wrapper's private
    launcher: the load route at a shape the wrapper sends to the TMA route,
    to time what loading A costs apart from the width."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    out = [torch.empty((*x.shape[:-1], Kx), dtype=torch.float32,
                       device=x.device) for _ in range(2)]
    ck._launch(x, tables[1] if center else tables[0], *out, Kx, center,
               route)
    return out


def k1_bound(P: int, H: int, W: int, Kx: int) -> tuple[float, str]:
    """(ms, bound_by): least time of the stage-1 function on the card, the
    larger of its operations over the bf16 peak and its bytes (u8 images
    read once, both bf16 tables once, ar and ai written once) over the HBM
    rate, and which of the two it is."""
    M = P * H
    flops = 2.0 * M * W * 2 * Kx
    nbytes = M * W + 2 * Kx * W * 2 + 2 * M * Kx * 4
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _k1_key(x, Kx: int, center: bool) -> tuple:
    """(planes, H, W, Kx, center, route) of one stage-1 call on images x."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    H, W = x.shape[-2:]
    return (x.numel() // (H * W), H, W, Kx, bool(center),
            ck.route_for(W, x.data_ptr()))


def _grid_nchw(dev, B: int, h: int, w: int):
    """make_covers(B, h, w) on the card as contiguous (B, 3, h, w) u8."""
    import torch

    return (torch.from_numpy(make_covers(B, h, w)).to(dev)
            .permute(0, 3, 1, 2).contiguous())


def _offset_u8(rng, shape, dev, offset: int):
    """Seeded u8 images of `shape` on the card, `offset` bytes into their
    storage, the last row ending at the storage's last byte: a view whose
    base is not 16-byte aligned (for offset % 16 != 0)."""
    import numpy as np
    import torch

    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.integers(0, 256, offset + n,
                                        dtype=np.uint8)).to(dev)
    return buf[offset:].view(shape)


def _turns(runs: dict, rounds: int = 2) -> dict:
    """{name: [ms per round]} of each (fn, n) in runs, by CUDA events, the
    runs taken in turns, `rounds` times."""
    times: dict = {k: [] for k in runs}
    for _ in range(rounds):
        for k, (fn, n) in runs.items():
            times[k].append(cuda_ms(fn, n))
    return times


def phase_k1(covers_d, card: str):
    """Both routes of the stage-1 kernel against their plain version: the
    TMA route at the main path's shape (the whole 4K batch, P = 192 planes),
    at 1080p B=8, at phase 4's 512x512 B=8 grid and at the edge shapes; the
    load route at the 4K batch cropped to 3839 columns (phase 4c's covers),
    forced at the main path's shape, at 4b's 1079x1917 B=4 grid, at the
    odd-width edge shapes, at a phone screenshot (1170x2532 B=8) and at
    views whose base is not 16-byte aligned. cuobjdump shows HGMMA in both
    instantiations. Timed in turns at 4K: the TMA route at 3840, the load
    route at 3839 and forced at 3840, and torch.mm at both widths with and
    without the u8 -> bf16 cast; at the 4b grid the load route, its plain
    version and torch.mm; at the serve worker's shapes (the first 1 and 32
    covers: P=3 and P=96) the TMA route, its plain version and torch.mm
    with and without the cast. Returns the routes' records, the _k1_key of
    every shape checked here, and the 3839-column covers."""
    import numpy as np
    import torch

    from steganosaurus_tpu_torch import _build
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    TMA, LDG = ck.KERNEL_TMA, ck.KERNEL_LDG
    dev = covers_d.device
    B, _, H, W = covers_d.shape
    Ky, Kx = corner.corner_dims(H, W, 0.45)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    main = (covers_d, tabs.exr16, tabs.exi16, False)
    odd_d = covers_d[..., :W - 1].contiguous()
    oky, okx = corner.corner_dims(H, W - 1, 0.45)
    otabs = corner.dft_tables_device(H, oky, W - 1, okx, dev)
    odd = (odd_d, otabs.exr16, otabs.exi16, False)

    def new(x, er, ei, c, tables=None):
        return ck.fwd_stage1(x, er, ei, c, tables)

    def check(what, args, tables=None, route=None):
        """args through the wrapper, which must take `route` there."""
        x = args[0]
        got = ck.route_for(x.shape[-1], x.data_ptr())
        if route is not None and got != route:
            raise AssertionError(f"{what} {tuple(x.shape)} routes to {got}")
        err = _k1_check(f"{got} {what} {tuple(x.shape)} "
                        f"Kx={args[1].shape[0]} center={args[3]}",
                        new(*args, tables), ck.fwd_stage1_plain(*args))
        checked.add(_k1_key(x, args[1].shape[0], args[3]))
        return err

    checked: set = set()
    err_tma = check("main path", main, tabs.stage1, TMA)
    _k1_check(f"{LDG} forced {tuple(covers_d.shape)} Kx={Kx}",
              k1_on_route(covers_d, tabs.stage1, Kx, False, LDG),
              ck.fwd_stage1_plain(*main))
    err_ldg = check("4K cropped to 3839 (4c)", odd, otabs.stage1, LDG)
    torch.cuda.empty_cache()

    # the other grids the paths give K1, at their own B, Kx and centering
    # (off by default), through the wrapper: phase 4's 512x512 B=8 (the TMA
    # route), 4b's 1079x1917 B=4 and a phone screenshot (the load route)
    grids = {}
    for (b, h, w), route in (((SMALL_B, SMALL_H, SMALL_W), TMA),
                             (RAGGED_GRID, LDG), (PHONE_GRID, LDG)):
        x = _grid_nchw(dev, b, h, w)
        gky, gkx = corner.corner_dims(h, w, 0.45)
        gt = corner.dft_tables_device(h, gky, w, gkx, dev)
        check("path grid", (x, gt.exr16, gt.exi16, False), gt.stage1, route)
        grids[w] = (x, gt, gkx)

    rng = np.random.default_rng(5)
    fky, fkx = corner.corner_dims(FHD_H, FHD_W, 0.45)
    ft = corner.dft_tables_device(FHD_H, fky, FHD_W, fkx, dev)
    x = torch.from_numpy(rng.integers(0, 256, (FHD_B, 3, FHD_H, FHD_W),
                                      dtype=np.uint8)).to(dev)
    check("1080p", (x, ft.exr16, ft.exi16, False), ft.stage1, TMA)
    for shape, kx, center in K1_EDGES:
        x = torch.from_numpy(rng.integers(0, 256, shape,
                                          dtype=np.uint8)).to(dev)
        er, ei = (torch.from_numpy(t).to(dev).to(torch.bfloat16)
                  for t in corner._dft_tables(shape[-1], kx))
        check("edge", (x, er, ei, center),
              route=TMA if shape[-1] % 16 == 0 else LDG)
    # views whose base is not 16-byte aligned, each ending at the last byte
    # of its storage: W % 16 == 0 there goes to the load route too
    for shape, kx, offset in (((2, 3, 67, 512), 300, 1), ((3, 45, 203), 64, 3),
                              ((3, 301, 1917), 512, 7)):
        x = _offset_u8(rng, shape, dev, offset)
        er, ei = (torch.from_numpy(t).to(dev).to(torch.bfloat16)
                  for t in corner._dft_tables(shape[-1], kx))
        check(f"view at +{offset} B", (x, er, ei, True), route=LDG)

    for route, fn in ((TMA, "corner_stage1_tma_kernel"),
                      (LDG, "corner_stage1_ldg_kernel")):
        sass = _build.sass_counts(TMA, fn)
        log(f"K1 {route} SASS ({fn}, cuobjdump -sass): {sass}")
        if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
            raise AssertionError(f"{route} is not wgmma + TMA: {sass}")

    # in turns, one process, CUDA events: both routes and the library call,
    # torch.mm(x_bf16, T.T, out_dtype=f32), with and without the u8 -> bf16
    # cast, at both widths
    f32, bf16 = torch.float32, torch.bfloat16
    T = torch.cat([tabs.exr16, tabs.exi16])
    oT = torch.cat([otabs.exr16, otabs.exi16])
    rows, orows = covers_d.reshape(-1, W), odd_d.reshape(-1, W - 1)
    rows16, orows16 = rows.to(bf16), orows.to(bf16)
    times = _turns({
        TMA: (lambda: new(*main, tabs.stage1), 5),
        LDG: (lambda: new(*odd, otabs.stage1), 5),
        f"{LDG} forced at {W}": (
            lambda: k1_on_route(covers_d, tabs.stage1, Kx, False, LDG), 5),
        "library": (lambda: torch.mm(rows.to(bf16), T.T, out_dtype=f32), 5),
        "library_no_cast": (lambda: torch.mm(rows16, T.T, out_dtype=f32), 5),
        f"library at {W - 1}": (
            lambda: torch.mm(orows.to(bf16), oT.T, out_dtype=f32), 2),
        f"library_no_cast at {W - 1}": (
            lambda: torch.mm(orows16, oT.T, out_dtype=f32), 2),
    })
    del rows16, orows16
    torch.cuda.empty_cache()
    plain = _turns({TMA: (lambda: ck.fwd_stage1_plain(*main), 2),
                    LDG: (lambda: ck.fwd_stage1_plain(*odd), 2)}, rounds=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    plain_ms = {k: v[0] for k, v in plain.items()}
    bounds = {TMA: k1_bound(B * 3, H, W, Kx),
              LDG: k1_bound(B * 3, H, W - 1, okx)}
    for k, v in times.items():
        log(f"K1 time at 4K B={B} Kx={Kx}, {k}: {v!r} ms, mean {ms[k]!r} ms")
    for k in (TMA, LDG):
        log(f"K1 {k}: plain version {plain_ms[k]!r} ms; bound "
            f"{bounds[k][0]!r} ms ({bounds[k][1]}), at "
            f"{bounds[k][0] / ms[k]:.3f} of it")

    # the load route where a path launches it first: the 4b grid, in turns
    # with its plain version and the library call
    x, gt, gkx = grids[RAGGED_GRID[2]]
    args = (x, gt.exr16, gt.exi16, False)
    r4 = x.reshape(-1, x.shape[-1])
    T4 = torch.cat([gt.exr16, gt.exi16])
    rtimes = _turns({
        LDG: (lambda: new(*args, gt.stage1), 20),
        "plain": (lambda: ck.fwd_stage1_plain(*args), 20),
        "library": (lambda: torch.mm(r4.to(bf16), T4.T, out_dtype=f32), 20),
    })
    rms = {k: sum(v) / len(v) for k, v in rtimes.items()}
    rbound, rbound_by = k1_bound(x.shape[0] * 3, *x.shape[-2:], gkx)
    for k, v in rtimes.items():
        log(f"K1 time at the 4b grid {tuple(x.shape)} Kx={gkx}, {k}: {v!r} "
            f"ms, mean {rms[k]!r} ms")
    log(f"K1 {LDG} at the 4b grid: bound {rbound!r} ms ({rbound_by}), at "
        f"{rbound / rms[LDG]:.3f} of it")
    # the serve worker's shapes (phase 8) on the TMA route: a single embed
    # or extract is B=1 (P=3), a batch op up to B=32 (P=96); each held to
    # the plain version, then timed in turns with it and the library call
    for b in SERVE_K1_B:
        x = covers_d[:b]
        args = (x, tabs.exr16, tabs.exi16, False)
        check(f"serve B={b}", args, tabs.stage1, TMA)
        r = x.reshape(-1, W)
        r16 = r.to(bf16)
        n = 200 if b == 1 else 10
        st = _turns({
            TMA: (lambda a=args: new(*a, tabs.stage1), n),
            "plain": (lambda a=args: ck.fwd_stage1_plain(*a), max(2, n // 20)),
            "library": (lambda r=r: torch.mm(r.to(bf16), T.T, out_dtype=f32),
                        n),
            "library_no_cast": (lambda r16=r16: torch.mm(r16, T.T,
                                                         out_dtype=f32), n),
        })
        sms = {k: sum(v) / len(v) for k, v in st.items()}
        sb, sb_by = k1_bound(3 * b, H, W, Kx)
        for k, v in st.items():
            log(f"K1 serve shape P={3 * b} {H}x{W} Kx={Kx}, {k}: {v!r} ms, "
                f"mean {sms[k]!r} ms ({card})")
        log(f"K1 {TMA} at P={3 * b}: bound {sb!r} ms ({sb_by}), at "
            f"{sb / sms[TMA]:.3f} of it; {sms['library'] / sms[TMA]:.3f}x "
            f"the library call's time ({card})")
        del r16
    torch.cuda.empty_cache()
    if not ms[LDG] < ms[f"library at {W - 1}"]:
        raise AssertionError(f"{LDG} is not faster than torch.mm at "
                             f"{W - 1}: {times}")
    if not rms[LDG] < rms["library"]:
        raise AssertionError(f"{LDG} is not faster than torch.mm at the 4b "
                             f"grid: {rtimes}")
    source = "steganosaurus_tpu_torch/csrc/corner_stage1_wgmma.cu"
    replaces = "steganosaurus_tpu/spectral/corner_pallas.py:55"
    records = [
        {"name": TMA, "route": "cuda", "source": source,
         "replaces": replaces, "max_abs_err": err_tma, "ms": ms[TMA],
         "plain_ms": plain_ms[TMA], "bound_ms": bounds[TMA][0],
         "bound_by": bounds[TMA][1], "library_ms": ms["library"]},
        {"name": LDG, "route": "cuda", "source": source,
         "replaces": replaces, "max_abs_err": err_ldg, "ms": ms[LDG],
         "plain_ms": plain_ms[LDG], "bound_ms": bounds[LDG][0],
         "bound_by": bounds[LDG][1],
         "library_ms": ms[f"library at {W - 1}"]},
    ]
    return records, checked, odd_d


def psnr_mean(stego, covers) -> float:
    import torch

    d = stego.to(torch.float32) - covers.to(torch.float32)
    mse = (d * d).flatten(1).mean(1)
    return float((10.0 * torch.log10(255.0 ** 2 / mse)).mean().item())


def phase_small(dev) -> None:
    """512x512, B=8, 100 B round trip on the card, held against the port's
    plain CPU path on the same inputs."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt

    covers = make_covers(SMALL_B, SMALL_H, SMALL_W)
    nchw = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    secrets = secrets_for(SMALL_B, SMALL_SECRET)
    salts = [bytes([i]) * 16 for i in range(SMALL_B)]
    covers_d = torch.from_numpy(nchw).to(dev)
    res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                          salts=salts, device_resident=True, layout="nchw")
    got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                            clen_hint=SMALL_SECRET, layout="nchw")
    torch.cuda.synchronize()
    n_ok = sum(g == s for g, s in zip(got, secrets))
    if n_ok != SMALL_B:
        raise AssertionError(f"small phase recovered {n_ok}/{SMALL_B}")
    ref = stt.embed_batch(nchw, secrets, master_key=MASTER_KEY, salts=salts,
                          layout="nchw", device="cpu").stego
    diff = res.stego.cpu().numpy().astype(np.int16) - ref.astype(np.int16)
    n_diff = int(np.count_nonzero(diff))
    frac = n_diff / diff.size
    log(f"small {SMALL_H}x{SMALL_W} B={SMALL_B} {SMALL_SECRET} B: recovered "
        f"{n_ok}/{SMALL_B}; stego vs CPU port: {n_diff} of {diff.size} "
        f"bytes differ, max |diff| {int(np.abs(diff).max())}")
    if np.abs(diff).max() > 1 or frac > SMALL_MAX_DIFF_FRAC:
        raise AssertionError("card stego disagrees with the CPU reference")


def phase_uhd(covers_d, what: str = "4K", route: str = "") -> tuple:
    """The main path at 4K UHD, B=64, 16 KB, on covers_d (phase 4; 4c: the
    same covers cropped by one column). Every secret must come back, and
    stage 1 must launch on `route` only (by default the TMA route). Returns
    the kernels' launch counts of the counted (warm) round trip and its
    (embed ms, extract ms)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    route = route or ck.KERNEL_TMA
    B = covers_d.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]

    def round_trip():
        t0 = time.perf_counter()
        res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                              salts=salts, device_resident=True,
                              layout="nchw")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                                clen_hint=UHD_SECRET, layout="nchw")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_ok = sum(g == s for g, s in zip(got, secrets))
        if n_ok != B:
            bad = [i for i, (g, s) in enumerate(zip(got, secrets)) if g != s]
            raise AssertionError(f"{what} round trip recovered {n_ok}/{B}; "
                                 f"failed images {bad}")
        return res.stego, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    _, e_ms, x_ms = round_trip()
    log(f"{what} first round trip (walk expansion, tables): embed {e_ms!r} "
        f"ms, extract {x_ms!r} ms, recovered {B}/{B}")
    torch.cuda.reset_peak_memory_stats()
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    stego, e_ms, x_ms = round_trip()
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if stego.shape != covers_d.shape or stego.dtype != torch.uint8:
        raise AssertionError(f"stego {stego.dtype} {tuple(stego.shape)}")
    psnr = psnr_mean(stego, covers_d)
    if not math.isfinite(psnr):
        raise AssertionError(f"PSNR {psnr}")
    total = e_ms + x_ms
    H, W = covers_d.shape[-2:]
    log(f"{what} {H}x{W} B={B} {UHD_SECRET} B warm round trip: embed "
        f"{e_ms!r} ms, extract {x_ms!r} ms, total {total!r} ms, "
        f"{B / (total / 1e3)!r} img/s, recovered {B}/{B}, mean PSNR "
        f"{psnr!r} dB, peak memory {peak / 2**30!r} GiB")
    log(f"launches in the counted round trip: {launches}")
    if launches[route] <= 0 or any(n for k, n in launches.items()
                                   if k != route):
        raise AssertionError(f"the {what} path did not launch {route} "
                             f"alone: {launches}")
    return launches, (e_ms, x_ms)


def phase_ragged_grid(dev, launches: dict) -> None:
    """A round trip at a width that is not a multiple of 16 (a user PNG of
    any size): stage 1 goes through the load route only, and the batch must
    read back B/B."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    B, h, w = RAGGED_GRID
    covers = torch.from_numpy(make_covers(B, h, w)).to(dev)
    secrets = secrets_for(B, 1024)

    def run():
        res = stt.embed_batch(covers, secrets, master_key=MASTER_KEY,
                              device_resident=True)
        return stt.extract_batch(res.stego, master_key=MASTER_KEY)

    path = f"ragged grid {h}x{w}"
    got = count_launches(path, launches, run, kernel=ck.KERNEL_LDG)
    n_ok = sum(g == s for g, s in zip(got, secrets))
    log(f"ragged grid {h}x{w} B={B} 1 KB: recovered {n_ok}/{B}, launches "
        f"{launches[path]}")
    if n_ok != B:
        raise AssertionError(f"ragged grid recovered {n_ok}/{B}")
    if launches[path][ck.KERNEL_TMA]:
        raise AssertionError(f"the ragged grid launched {ck.KERNEL_TMA}")


def timed(name: str, fn, *args):
    """fn(*args), its wall time logged once the card is idle again."""
    import torch

    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    return out


def count_launches(path: str, launches: dict, fn, kernel: str = ""):
    """Run fn() with every kernel count set to 0, record the counts for
    `path` and fail if `kernel` (the route of the path's K1 launches; by
    default the TMA route, which every grid of the smoke but the ragged one
    and 4c takes) was not launched. Returns fn()'s result."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    kernel = kernel or ck.KERNEL_TMA
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    out = fn()
    torch.cuda.synchronize()
    if ck.LAUNCHES[kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched on the {path} "
                             f"path")
    launches[path] = dict(ck.LAUNCHES)
    return out


def run_stream(covers_d, secrets, salts_of, keys) -> tuple:
    """embed_stream -> extract_stream over len(keys) copies of the batch,
    depth 2, nchw; batch k embeds under salts_of(k) and keys[k]. Returns
    (per-batch recovered counts, wall s, the last batch's stego)."""
    import torch

    import steganosaurus_tpu_torch as stt

    B = covers_d.shape[0]
    last = {}

    def stegos(embeds):
        for k, res in enumerate(embeds):
            last["stego"] = res.stego
            yield res.stego, keys[k]

    t = time.perf_counter()
    embeds = stt.embed_stream(
        ((covers_d, secrets, salts_of(k), keys[k]) for k in range(len(keys))),
        master_key=MASTER_KEY, depth=2, layout="nchw")
    n_ok = [sum(g == s for g, s in zip(got, secrets))
            for got in stt.extract_stream(stegos(embeds),
                                          master_key=MASTER_KEY,
                                          clen_hint=len(secrets[0]), depth=2,
                                          layout="nchw")]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    if len(n_ok) != len(keys) or any(n > B for n in n_ok):
        raise AssertionError(f"stream returned {n_ok} for {len(keys)} "
                             f"batches of {B}")
    return n_ok, dt, last["stego"]


def phase_stream(covers_d, launches: dict):
    """5a: the 4K stream with fixed salts against the serialized loop.
    Returns the last streamed stego (5c reads it)."""
    import torch

    import steganosaurus_tpu_torch as stt

    B = covers_d.shape[0]
    n = STREAM_BATCHES
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]

    # queuing a batch must not wait for the card: no stream sync, no
    # blocking copy anywhere in embed_batch or extract_dispatch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                              salts=salts, device_resident=True,
                              layout="nchw")
        job = stt.extract_dispatch(res.stego, master_key=MASTER_KEY,
                                   clen_hint=UHD_SECRET, layout="nchw")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if job.finalize() != secrets:
        raise AssertionError("round trip under sync debug mode failed")
    log("sync debug mode 'error': embed_batch + extract_dispatch queued "
        "without a host sync")
    del res, job

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_ok, dt, stego = count_launches("stream", launches, lambda: run_stream(
        covers_d, secrets, lambda k: salts, [MASTER_KEY] * n))
    peak = torch.cuda.max_memory_allocated()
    if n_ok != [B] * n:
        raise AssertionError(f"4K stream recovered {n_ok} of {B} per batch")
    stream_ips = n * B / dt

    t = time.perf_counter()
    for _ in range(n):
        res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                              salts=salts, device_resident=True,
                              layout="nchw")
        got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                                clen_hint=UHD_SECRET, layout="nchw")
        if got != secrets:
            raise AssertionError("serialized loop recovery failed")
    torch.cuda.synchronize()
    loop_ips = n * B / (time.perf_counter() - t)
    log(f"4K stream, fixed salts, depth 2, {n} batches of {B}: recovered "
        f"{n_ok} per batch; {stream_ips!r} img/s (wall {dt!r} s); "
        f"serialized loop {loop_ips!r} img/s; peak memory with two batches "
        f"in flight {peak / 2**30!r} GiB")
    return stego


def phase_rotating(covers_d, launches: dict) -> None:
    """5b: fresh salts every batch (the JAX bench's rotating-salt recipe,
    bench.py:724-726) and a second master key from the second half of the
    batches on. Recovery is counted; anything under 1.0 fails."""
    B = covers_d.shape[0]
    n = STREAM_BATCHES
    secrets = secrets_for(B, UHD_SECRET)
    keys = [MASTER_KEY] * (n // 2) + [MASTER_KEY2] * (n - n // 2)

    def salts_of(k):
        return [bytes([i % 256, 200 + k % 56]) * 8 for i in range(B)]

    n_ok, dt, _ = count_launches("rotating stream", launches,
                                 lambda: run_stream(covers_d, secrets,
                                                    salts_of, keys))
    rate = sum(n_ok) / (n * B)
    log(f"4K rotating-salt stream, key rotated at batch {n // 2}: recovered "
        f"{n_ok} per batch, recovery rate {rate!r}; {n * B / dt!r} img/s "
        f"(wall {dt!r} s, the new key's walk expansion included)")
    if rate < 1.0:
        raise AssertionError(f"rotating-salt recovery {rate} < 1.0")


# The JAX package's own record on the same 4K covers (BENCH_r03.json)
JAX_QUALITY = {"payload_ber_raw": 0.001595, "header_ber_raw": 0.001302,
               "payload_ber_post_ecc": 0.0, "psnr_db": 36.34,
               "ssim": 0.9486}


def phase_quality(covers_d, stego, launches: dict) -> dict:
    """5c: channel_report and quality_device on the stego of 5a. The
    payload's post-ECC BER must be 0, as in the JAX record, and every image
    must read back; an image whose Rep-3 header keeps a flipped bit is
    listed (the soft decode recovers its header)."""
    import steganosaurus_tpu_torch as stt

    B = covers_d.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    t = time.perf_counter()
    rep = count_launches("channel report", launches, lambda: stt.channel_report(
        stego, secrets, salts, master_key=MASTER_KEY, layout="nchw",
        per_image=True))
    t_rep = time.perf_counter() - t
    t = time.perf_counter()
    psnr, ssim = stt.quality_device(covers_d, stego)
    t_q = time.perf_counter() - t
    hdr_bad = [i for i, r in enumerate(rep.pop("per_image"))
               if r["header_ber_post_ecc"] > 0]
    log(f"4K channel report ({t_rep!r} s): payload raw BER "
        f"{rep['payload_ber_raw']!r}, header raw BER "
        f"{rep['header_ber_raw']!r}, payload post-ECC "
        f"{rep['payload_ber_post_ecc']!r}, header post-ECC "
        f"{rep['header_ber_post_ecc']!r} (images {hdr_bad}); "
        f"quality_device ({t_q!r} s): PSNR {psnr!r} dB, SSIM {ssim!r}; the "
        f"JAX record on these covers: {JAX_QUALITY}")
    if rep["payload_ber_post_ecc"] != 0.0:
        raise AssertionError(f"payload post-ECC BER is not 0: {rep}")
    if stt.extract_batch(stego, master_key=MASTER_KEY, clen_hint=UHD_SECRET,
                         layout="nchw") != secrets:
        raise AssertionError("the reported stego does not read back")
    if not (math.isfinite(psnr) and 0.0 < ssim <= 1.0):
        raise AssertionError(f"PSNR {psnr}, SSIM {ssim}")
    return {**rep, "psnr_db": psnr, "ssim": ssim}


def phase_soft(dev, launches: dict) -> None:
    """5d: the soft-decision margin workload of tests/test_soft_decode.py:
    one 256x256 full-range noise cover, 240-byte secrets, B=8, salts
    bytes([i])*16. The soft decode must recover strictly more than the hard
    one, and only true secrets."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt

    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    B = 8
    covers = torch.from_numpy(np.stack([cover] * B)).to(dev)
    hard_p = stt.Params(soft_decode_fallback=False)

    def run():
        st = stt.embed_batch(covers, [secret] * B, master_key=MASTER_KEY,
                             params=hard_p, salts=[bytes([i]) * 16
                                                   for i in range(B)],
                             device_resident=True).stego
        return (stt.extract_batch(st, master_key=MASTER_KEY, params=hard_p),
                stt.extract_batch(st, master_key=MASTER_KEY))

    hard, soft = count_launches("soft", launches, run)
    ok_h = [i for i, g in enumerate(hard) if g is not None]
    ok_s = [i for i, g in enumerate(soft) if g is not None]
    log(f"soft margin workload (256x256 noise, 240 B, B={B}): hard decode "
        f"recovered {len(ok_h)}/{B} {ok_h}, soft {len(ok_s)}/{B} {ok_s}")
    if any(g is not None and g != secret for g in soft + hard):
        raise AssertionError("a decode returned a wrong secret")
    if not set(ok_h) <= set(ok_s) or len(ok_s) <= len(ok_h):
        raise AssertionError("the soft decode did not recover more than "
                             "the hard one")


def phase_ragged(dev, launches: dict) -> None:
    """5e: 1080p, B=8, secrets of 100 B to 4 KB; embed_batch(verify=True,
    max_retries=4) must verify every image and the stego must read back,
    without and with jitter 0.2. The card's stego of a plain embed under
    fixed salts is held against the port's CPU stego of the same inputs:
    +-1 on at most FHD_MAX_DIFF_FRAC of the bytes, and each reads the
    other's stego."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt

    rng = np.random.default_rng(31)
    base = np.linspace(140, 230, FHD_W)
    covers = np.clip(base[None, None, :, None]
                     + rng.integers(-25, 26, (FHD_B, FHD_H, FHD_W, 3)), 0,
                     255).astype(np.uint8)
    covers = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    lens = [int(n) for n in np.linspace(100, 4096, FHD_B)]
    secrets = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in lens]
    salts = [bytes([i + 60]) * 16 for i in range(FHD_B)]
    covers_d = torch.from_numpy(covers).to(dev)
    for jitter in (0.0, 0.2):
        p = stt.Params(jitter=jitter)

        def run():
            res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                                  params=p, salts=salts, verify=True,
                                  max_retries=4, device_resident=True,
                                  layout="nchw")
            got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                                    params=p, clen_hint=max(lens),
                                    layout="nchw")
            return res, got

        res, got = count_launches(f"ragged verify jitter={jitter}",
                                  launches, run)
        resalted = [i for i, (a, b) in enumerate(zip(res.salts, salts))
                    if a != b]
        n_ok = sum(g == s for g, s in zip(got, secrets))
        card = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                               params=p, salts=salts, layout="nchw")
        cpu = stt.embed_batch(covers, secrets, master_key=MASTER_KEY,
                              params=p, salts=salts, layout="nchw",
                              device="cpu")
        diff = card.stego.astype(np.int16) - cpu.stego.astype(np.int16)
        n_diff = int(np.count_nonzero(diff))
        cross = (stt.extract_batch(card.stego, master_key=MASTER_KEY,
                                   params=p, layout="nchw", device="cpu"),
                 stt.extract_batch(cpu.stego, master_key=MASTER_KEY,
                                   params=p, layout="nchw", device=dev))
        n_cross = [sum(g == s for g, s in zip(got, secrets))
                   for got in cross]
        log(f"1080p B={FHD_B} ragged {lens[0]}..{lens[-1]} B, jitter "
            f"{jitter}: verified {res.verified}, re-salted {resalted}, read "
            f"back {n_ok}/{FHD_B}; card stego vs CPU port: {n_diff} of "
            f"{diff.size} bytes differ, max |diff| {int(np.abs(diff).max())}"
            f"; CPU reads the card's stego {n_cross[0]}/{FHD_B}, the card "
            f"the CPU's {n_cross[1]}/{FHD_B}")
        if not all(res.verified) or n_ok != FHD_B:
            raise AssertionError(f"ragged verify failed at jitter {jitter}")
        if (np.abs(diff).max() > 1 or n_diff / diff.size > FHD_MAX_DIFF_FRAC
                or n_cross != [FHD_B, FHD_B]):
            raise AssertionError("card stego disagrees with the CPU port")


def _fhd_mode_covers():
    """(8, 3, 1080, 1920) u8 gradient + [-25, 25] noise covers, seed 41."""
    import numpy as np

    rng = np.random.default_rng(41)
    base = np.linspace(140, 230, FHD_W)
    covers = np.clip(base[None, None, :, None]
                     + rng.integers(-25, 26, (FHD_B, FHD_H, FHD_W, 3)), 0,
                     255).astype(np.uint8)
    return np.ascontiguousarray(covers.transpose(0, 3, 1, 2))


def _stego_diff(card, cpu) -> dict:
    """Card stego vs CPU port stego of the same inputs ((B, 3, H, W) u8):
    bytes differing, max |diff|, the ripple planes (image-planes with more
    than RIPPLE_FRAC of their bytes differing), the largest share of
    differing bytes in one plane, and the bytes differing outside the
    ripple planes."""
    import numpy as np

    diff = card.astype(np.int16) - cpu.astype(np.int16)
    per_plane = np.mean(diff != 0, axis=(2, 3))                # (B, 3)
    ripple = per_plane > RIPPLE_FRAC
    return {"n": int(np.count_nonzero(diff)), "size": diff.size,
            "max": int(np.abs(diff).max()), "planes": int(ripple.sum()),
            "of": ripple.size, "plane_max": float(per_plane.max()),
            "out": int(np.count_nonzero(diff[~ripple]))}


def _diff_line(d: dict) -> str:
    return (f"{d['n']} of {d['size']} bytes differ, max |diff| {d['max']}, "
            f"ripple planes {d['planes']} of {d['of']} (largest plane "
            f"share {d['plane_max']!r}), {d['out']} outside them")


def _within_bounds(d: dict, discontinuous: bool) -> bool:
    """Every byte within +-1; at most FHD_MAX_DIFF_FRAC of the bytes
    differ outside the ripple planes; no plane moves more than
    RIPPLE_MAX_FRAC of its bytes; at most MODE_MAX_RIPPLE_PLANES ripple
    planes for a threshold write rule (QIM, soft write), none for the
    continuous hard write."""
    return (d["max"] <= 1 and d["out"] <= FHD_MAX_DIFF_FRAC * d["size"]
            and d["plane_max"] <= RIPPLE_MAX_FRAC
            and d["planes"] <= (MODE_MAX_RIPPLE_PLANES if discontinuous
                                else 0))


def _with_card_spectrum(run_card, run_cpu):
    """(run_card(), run_cpu()), where the CPU embed run_cpu() takes the
    forward corner spectrum the card embed run_card() computed in place of
    its own; the write rules, the floor, the inverse DFT and the epilogue
    still run on the CPU. Each embed computes the spectrum once."""
    from steganosaurus_tpu_torch.spectral import corner

    real = corner.fwd_corner
    seen = []

    def capture(*a, **k):
        out = real(*a, **k)
        seen.append(tuple(t.cpu() for t in out))
        return out

    def replay(imgs_u8, *a, **k):
        cr, ci = seen[0]
        if cr.shape[:-2] != imgs_u8.shape[:-2]:
            raise AssertionError(f"spectrum {tuple(cr.shape)} for images "
                                 f"{tuple(imgs_u8.shape)}")
        return cr.clone(), ci.clone()

    corner.fwd_corner = capture
    try:
        card = run_card()
    finally:
        corner.fwd_corner = real
    if len(seen) != 1:
        raise AssertionError(f"the card embed computed {len(seen)} spectra")
    corner.fwd_corner = replay
    try:
        cpu = run_cpu()
    finally:
        corner.fwd_corner = real
    return card, cpu


def _planted_faults():
    """(name, patch) pairs of deliberate faults of the card-side QIM write;
    patch() applies one and returns the function that undoes it. The
    static-map cache is emptied both ways, so no faulty map outlives its
    run."""
    import torch

    from steganosaurus_tpu_torch.pipeline import batch as tbatch

    def patched(obj, name, fn):
        def apply():
            real = getattr(obj, name)
            tbatch._CORNER_STATICS_CACHE.clear()
            setattr(obj, name, fn(real))

            def undo():
                setattr(obj, name, real)
                tbatch._CORNER_STATICS_CACHE.clear()
            return undo
        return apply

    def shifted(real):  # slot k takes slot k + 1's dither
        return lambda kind, *a, **k: (torch.roll(real(kind, *a, **k), -1)
                                      if kind == "dither"
                                      else real(kind, *a, **k))

    return [
        ("dither shifted by one slot",
         patched(tbatch, "_slot_values_device", shifted)),
        # the other centroid of the same bit's coset for about half the
        # bins: every bit still decodes
        ("floor in place of round in the lattice",
         patched(torch, "round", lambda real: torch.floor)),
        ("round half away from zero in the lattice",
         patched(torch, "round", lambda real: lambda q: torch.where(
             q < 0, -torch.floor(0.5 - q), torch.floor(q + 0.5)))),
    ]


def phase_modes(dev, launches: dict) -> None:
    """5f: every corner wire mode at 1080p, B=8, 4 KB secrets, fixed salts:
    the card embeds and reads back 8/8; its stego is held against the CPU
    port's stego of the same inputs (_within_bounds); the CPU reads the
    card's stego and the card the CPU's, 8/8 each. For each threshold
    write rule the CPU embed is run again on the card's own forward
    spectrum, which must leave no ripple plane: the ripples come from the
    two spectra, not from the rules. Planted faults of the card-side QIM
    rule are held against the same bounds and must fail them. Then one
    mixed batch — row i from mode i's card stego, one row per jitter-0
    mode plus the default and a composite — read in a single
    extract_batch call."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.pipeline import batch as tbatch

    covers = _fhd_mode_covers()
    covers_d = torch.from_numpy(covers).to(dev)
    secrets = secrets_for(FHD_B, MODE_SECRET)
    salts = [bytes([i + 120]) * 16 for i in range(FHD_B)]
    Params = stt.Params
    modes = {
        "soft_write": Params(soft_write=True),
        "alpha_spread=0.5": Params(alpha_spread=0.5),
        "qim=3": Params(qim=3),
        "rs": Params(rs=True),
        "pad_quantum=1024": Params(pad_quantum=1024),
        "per_image_walk": Params(per_image_walk=True),
        "stealth": Params.stealth(),
    }
    kw = dict(master_key=MASTER_KEY, layout="nchw")
    card_stegos = {}
    cpu_stegos = {}
    for name, p in modes.items():
        hint = tbatch._wire_clen(MODE_SECRET, p)

        def run(p=p, hint=hint):
            t = time.perf_counter()
            st = stt.embed_batch(covers_d, secrets, params=p, salts=salts,
                                 device_resident=True, **kw).stego
            got = stt.extract_batch(st, params=p, clen_hint=hint, **kw)
            torch.cuda.synchronize()
            return st, got, time.perf_counter() - t

        st, got, dt = count_launches(f"5f {name}", launches, run)
        n_ok = sum(g == s for g, s in zip(got, secrets))
        card = st.cpu().numpy()
        cpu = stt.embed_batch(covers, secrets, params=p, salts=salts,
                              device="cpu", **kw).stego
        cross = (stt.extract_batch(card, params=p, device="cpu", **kw),
                 stt.extract_batch(cpu, params=p, device=dev, **kw))
        n_cross = [sum(g == s for g, s in zip(c, secrets)) for c in cross]
        threshold = bool(p.qim or p.soft_write)
        d = _stego_diff(card, cpu)
        log(f"5f 1080p B={FHD_B} {MODE_SECRET} B {name}: card round trip "
            f"{n_ok}/{FHD_B} ({dt!r} s wall); card vs CPU port: "
            f"{_diff_line(d)}; CPU reads the card's stego "
            f"{n_cross[0]}/{FHD_B}, the card the CPU's {n_cross[1]}/{FHD_B}")
        if (n_ok != FHD_B or n_cross != [FHD_B, FHD_B]
                or not _within_bounds(d, threshold)):
            raise AssertionError(f"5f {name}: recovery {n_ok}, cross "
                                 f"{n_cross}, card vs CPU port "
                                 f"{_diff_line(d)}")
        if threshold:
            card2, cpu2 = _with_card_spectrum(
                lambda p=p: stt.embed_batch(covers_d, secrets, params=p,
                                            salts=salts, **kw).stego,
                lambda p=p: stt.embed_batch(covers, secrets, params=p,
                                            salts=salts, device="cpu",
                                            **kw).stego)
            d2 = _stego_diff(card2, cpu2)
            log(f"5f {name}, the CPU port on the card's forward spectrum: "
                f"{_diff_line(d2)}")
            if d2["planes"] != 0 or not _within_bounds(d2, False):
                raise AssertionError(f"5f {name}: ripple planes remain on "
                                     f"the card's own spectrum: "
                                     f"{_diff_line(d2)}")
        card_stegos[name] = st
        cpu_stegos[name] = cpu

    p = modes["qim=3"]
    for fault, apply in _planted_faults():
        undo = apply()
        try:
            bad = stt.embed_batch(covers_d, secrets, params=p, salts=salts,
                                  device_resident=True, **kw).stego
        finally:
            undo()
        got = stt.extract_batch(bad, params=p, clen_hint=MODE_SECRET, **kw)
        bad = bad.cpu().numpy()
        d = _stego_diff(bad, cpu_stegos["qim=3"])
        moved = int(np.count_nonzero(bad != card_stegos["qim=3"].cpu()
                                     .numpy()))
        caught = not _within_bounds(d, True)
        log(f"5f planted fault in the card's qim=3 write, {fault}: card vs "
            f"CPU port {_diff_line(d)}; within the bounds {not caught}; "
            f"{moved} bytes differ from the correct card stego; the card "
            f"reads it back {sum(g == s for g, s in zip(got, secrets))}"
            f"/{FHD_B}")
        # a fault that leaves the stego as it was cannot be seen at this
        # shape; any other must fall outside the bounds
        if moved and not caught:
            raise AssertionError(f"5f planted fault {fault!r} passes the "
                                 f"card vs CPU port bounds")

    composite = Params(per_image_walk=True, rs=True, qim=4, pad_quantum=512,
                       alpha_spread=0.5, soft_write=True)
    card_stegos["composite"] = stt.embed_batch(
        covers_d, secrets, params=composite, salts=salts,
        device_resident=True, **kw).stego
    mixed_modes = [None, "soft_write", "alpha_spread=0.5", "qim=3", "rs",
                   "pad_quantum=1024", "per_image_walk", "composite"]
    default = stt.embed_batch(covers_d[:1], secrets[:1], salts=salts[:1],
                              device_resident=True, **kw).stego
    mixed = torch.cat([default] + [card_stegos[m][i:i + 1]
                                   for i, m in enumerate(mixed_modes)
                                   if m is not None])
    got = count_launches("5f mixed", launches, lambda: stt.extract_batch(
        mixed, params=Params(), clen_hint=MODE_SECRET, **kw))
    n_ok = sum(g == s for g, s in zip(got, secrets))
    log(f"5f mixed batch (default, {', '.join(mixed_modes[1:])}), one "
        f"extract_batch call: {n_ok}/{FHD_B}")
    if n_ok != FHD_B:
        raise AssertionError(f"5f mixed batch recovered {n_ok}/{FHD_B}")


def _timed_attr(obj, name: str, times: list):
    """Patch obj.<name> to append each call's host seconds to `times`;
    returns the function that undoes it."""
    real = getattr(obj, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            times.append(time.perf_counter() - t)

    setattr(obj, name, timed)
    return lambda: setattr(obj, name, real)


def phase_stealth(covers_d, launches: dict) -> None:
    """5g: Params.stealth() at 4K UHD, B=STEALTH_B, 16 KB, master key — the
    slice's full-width path: recovery, warm embed and extract ms (host
    walks included), the per-image walks' host seconds apart (the first
    call expands the shared header prefix too; each later batch expands
    its B salt-keyed payload walks again, at embed and at extract), mean
    PSNR beside the default write's on the same covers, peak memory, K1
    launches. Then the stealth stream: STEALTH_BATCHES batches with fresh
    salts through embed_stream -> extract_stream, beside the serialized
    loop of as many batches, with the host CPU seconds of each and the
    per-image walk cache left after the stream (the stream's prefetches
    must all be consumed)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.pipeline import batch as tbatch

    covers = covers_d[:STEALTH_B].contiguous()
    B = covers.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i + 7]) * 16 for i in range(B)]
    p = stt.Params.stealth()
    kw = dict(master_key=MASTER_KEY, layout="nchw")
    walk_s: list[float] = []
    undo = _timed_attr(tbatch, "_piw_walk_arrays", walk_s)
    try:
        def round_trip():
            t0 = time.perf_counter()
            res = stt.embed_batch(covers, secrets, params=p, salts=salts,
                                  device_resident=True, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = stt.extract_batch(res.stego, params=p,
                                    clen_hint=UHD_SECRET, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_ok = sum(g == s for g, s in zip(got, secrets))
            if n_ok != B:
                raise AssertionError(f"5g stealth recovered {n_ok}/{B}")
            return res.stego, (t1 - t0) * 1e3, (t2 - t1) * 1e3

        _, e0, x0 = round_trip()
        cold = list(walk_s)
        walk_s.clear()
        torch.cuda.reset_peak_memory_stats()
        stego, e_ms, x_ms = count_launches("5g stealth 4K", launches,
                                           round_trip)
        peak = torch.cuda.max_memory_allocated()
    finally:
        undo()
    psnr = psnr_mean(stego, covers)
    plain = stt.embed_batch(covers, secrets, salts=salts,
                            device_resident=True, **kw).stego
    psnr_plain = psnr_mean(plain, covers)
    log(f"5g stealth 4K {UHD_H}x{UHD_W} B={B} {UHD_SECRET} B: recovered "
        f"{B}/{B}; first round trip embed {e0!r} ms, extract {x0!r} ms; "
        f"warm embed {e_ms!r} ms, extract {x_ms!r} ms "
        f"({B / ((e_ms + x_ms) / 1e3)!r} img/s); host walk s "
        f"(embed, extract): cold {cold!r}, warm {walk_s!r}; mean PSNR "
        f"{psnr!r} dB (default write on the same covers {psnr_plain!r} "
        f"dB); peak memory {peak / 2**30!r} GiB; K1 launches "
        f"{launches['5g stealth 4K']}")
    if not (math.isfinite(psnr) and stego.shape == covers.shape):
        raise AssertionError(f"5g PSNR {psnr}, shape {tuple(stego.shape)}")
    del stego, plain

    n = STEALTH_BATCHES

    def stream():
        embeds = stt.embed_stream(((covers, secrets) for _ in range(n)),
                                  params=p, depth=2, **kw)
        return [sum(g == s for g, s in zip(got, secrets))
                for got in stt.extract_stream((r.stego for r in embeds),
                                              params=p, clen_hint=UHD_SECRET,
                                              depth=2, **kw)]

    tbatch._PIW_CACHE.clear()
    t, c = time.perf_counter(), time.process_time()
    n_ok = count_launches("5g stealth stream", launches, stream)
    s_wall, s_cpu = time.perf_counter() - t, time.process_time() - c
    left = len(tbatch._PIW_CACHE)
    t, c = time.perf_counter(), time.process_time()
    for _ in range(n):
        res = stt.embed_batch(covers, secrets, params=p,
                              device_resident=True, **kw)
        if stt.extract_batch(res.stego, params=p, clen_hint=UHD_SECRET,
                             **kw) != secrets:
            raise AssertionError("5g serialized stealth loop failed")
    torch.cuda.synchronize()
    l_wall, l_cpu = time.perf_counter() - t, time.process_time() - c
    log(f"5g stealth stream, fresh salts, depth 2, {n} batches of {B}: "
        f"recovered {n_ok} per batch; {n * B / s_wall!r} img/s (wall "
        f"{s_wall!r} s, host CPU {s_cpu!r} s, {s_cpu / s_wall!r} cores "
        f"busy); serialized loop {n * B / l_wall!r} img/s (wall {l_wall!r} "
        f"s, host CPU {l_cpu!r} s, {l_cpu / l_wall!r} cores busy); "
        f"per-image walk cache entries left after the stream: {left}; "
        f"{os.cpu_count()} host CPUs")
    if n_ok != [B] * n or left != 0:
        raise AssertionError(f"5g stealth stream recovered {n_ok} of {B} "
                             f"per batch, {left} cache entries left")


def phase_rs_padded(covers_d, launches: dict) -> None:
    """5h: Params(rs=True, pad_quantum=4096) at 4K, B=64, 16 KB: recovery,
    warm round trip with the host's RS encode and decode and its frame
    build timed inside it (the path's own calls, on its own frames), the
    channel_report with the RS payload (post-ECC BER must be 0), mean
    PSNR."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.pipeline import batch as tbatch

    B = covers_d.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    p = stt.Params(rs=True, pad_quantum=4096)
    hint = tbatch._wire_clen(UHD_SECRET, p)
    kw = dict(master_key=MASTER_KEY, layout="nchw")

    def round_trip():
        t0 = time.perf_counter()
        res = stt.embed_batch(covers_d, secrets, params=p, salts=salts,
                              device_resident=True, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = stt.extract_batch(res.stego, params=p, clen_hint=hint, **kw)
        torch.cuda.synchronize()
        n_ok = sum(g == s for g, s in zip(got, secrets))
        if n_ok != B:
            raise AssertionError(f"5h RS padded recovered {n_ok}/{B}")
        t2 = time.perf_counter()
        return res, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    round_trip()
    enc_s: list[float] = []
    dec_s: list[float] = []
    frames_s: list[float] = []
    undos = [_timed_attr(tbatch.rs_mod, "rs_encode_interleaved", enc_s),
             _timed_attr(tbatch.rs_mod, "rs_decode_interleaved", dec_s),
             _timed_attr(tbatch, "_host_frames", frames_s)]
    try:
        res, e_ms, x_ms = count_launches("5h rs+pad 4K", launches,
                                         round_trip)
    finally:
        for undo in undos:
            undo()
    ms = e_ms + x_ms
    rep = count_launches("5h channel report", launches,
                         lambda: stt.channel_report(res.stego, secrets,
                                                    salts, params=p, **kw))
    psnr = psnr_mean(res.stego, covers_d)
    log(f"5h host work inside the warm round trip: RS encode {len(enc_s)} "
        f"calls {sum(enc_s) * 1e3!r} ms (inside the frame build, "
        f"{sum(frames_s) * 1e3!r} ms), RS decode {len(dec_s)} calls "
        f"{sum(dec_s) * 1e3!r} ms, of {B} x {hint + 16} B messages")
    log(f"5h RS + pad_quantum=4096 4K B={B} {UHD_SECRET} B (wire clen "
        f"{hint}, {res.written_bits[0]} frame bits): recovered {B}/{B}, "
        f"warm round trip {ms!r} ms (embed {e_ms!r}, extract {x_ms!r}; "
        f"{B / (ms / 1e3)!r} img/s), mean PSNR "
        f"{psnr!r} dB; channel_report: payload raw BER "
        f"{rep['payload_ber_raw']!r}, post-ECC {rep['payload_ber_post_ecc']!r}"
        f", header raw {rep['header_ber_raw']!r}, post-ECC "
        f"{rep['header_ber_post_ecc']!r}")
    if rep["payload_ber_post_ecc"] != 0.0 or not math.isfinite(psnr):
        raise AssertionError(f"5h: {rep}, PSNR {psnr}")
    # one encode per image; one hard decode per image, more where a row's
    # soft header re-parses differently
    if len(enc_s) != B or len(dec_s) < B:
        raise AssertionError(f"5h: {len(enc_s)} RS encodes and {len(dec_s)} "
                             f"decodes for {B} images")


def count_no_launches(path: str, launches: dict, fn):
    """Run fn() with every kernel count set to 0 and record the counts for
    `path`, a path with no hand kernel (the single-image path and the
    full-grid batch cores run torch.fft, never the corner DFT): any K1
    launch there means the path took the wrong route. Returns fn()'s
    result."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    out = fn()
    torch.cuda.synchronize()
    launches[path] = dict(ck.LAUNCHES)
    if any(launches[path].values()):
        raise AssertionError(f"the {path} path launched K1: "
                             f"{launches[path]}")
    return out


def read_back(stego, **kw):
    """extract_array's secret, or None where it raises StegoError (a header
    whose Rep-3 majority fails reads as "Magic not found": the single-image
    extract has no soft header trial, in either package)."""
    import steganosaurus_tpu_torch as stt

    try:
        return stt.extract_array(stego, **kw)
    except stt.StegoError:
        return None


def device_busy(fn) -> tuple:
    """(fn()'s result, host wall ms ending in synchronize, device busy ms):
    the sum of the device time of every kernel and copy torch.profiler saw
    while fn() ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return out, wall, busy


def _psnr_hwc(stego, cover) -> float:
    """PSNR in dB of one (H, W, 3) u8 stego against its cover (numpy)."""
    import numpy as np

    d = stego.astype(np.float64) - cover.astype(np.float64)
    return float(10.0 * np.log10(255.0 ** 2 / np.mean(d * d)))


def _header_slot_errors(stego, secret: bytes, salt: bytes, p, backend):
    """(the slots of the 912-slot Rep-3 header stream that `backend` reads
    wrong off `stego`, the header walk (plane, y, x, jitter)). The true
    bits are rebuilt from SINGLE_KEY, the salt and the secret: the sealed
    header is a function of them."""
    import numpy as np

    from steganosaurus_tpu_torch import crypto, keystream, spectral
    from steganosaurus_tpu_torch.pipeline import frame, header

    H, W = stego.shape[:2]
    n = frame.HEADER_STREAM_BITS
    kw, kr, kg, kb = crypto.derive_turtle_keys(
        crypto.derive_path_key(None, SINGLE_KEY))
    walk = keystream.turtle_expand(kw, (kr, kg, kb), H, W, p.rmin, p.rmax,
                                   p.density, p.jitter, n)
    with crypto.derive_keys_vault(None, SINGLE_KEY, salt=salt,
                                  iters=p.pbkdf2_iter) as km:
        hb, ct, tag = header.seal_stream(secret, km, 0, p.pad_quantum)
    want = frame.frame_bits(hb + ct + tag)[:n]
    spec = backend.analyze(spectral.to_planes(stego), p, lazy=True)[0]
    got = backend.read_bits(spec, None, walk[:3], walk[3], p.alpha, p)
    return np.flatnonzero(got != want), walk


def _double_groups(errs) -> list[int]:
    """Rep-3 header groups with two or three of their slots in `errs`."""
    import numpy as np

    g, n = np.unique(np.asarray(errs) // 3, return_counts=True)
    return g[n >= 2].tolist()


def phase_single_4k(dev, launches: dict) -> None:
    """7a: embed_array -> extract_array of one 4K bench cover (seed 42,
    cover 0), 16 KB, default Params, on the card at the salts of
    SINGLE_SALT_READS: each salt reads back or misses as listed, on the
    card and in the CPU port alike (each reads both's stegos); a miss has
    a Rep-3 header group with two slots read wrong, the same group at
    every missed salt and on both readers; extract_batch reads the missed
    stegos. Then at the salt that reads back: cold (salt 0: a fresh key's
    walk expansion, cuFFT plans) and warm wall ms, the warm run's device
    busy ms against its host wall, PSNR beside the CPU port's on the same
    cover (within PSNR_TOL_DB), and the exact median of that spectrum:
    torch.kthvalue against the bisection twin, bit for bit."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.ops import stats
    from steganosaurus_tpu_torch.pipeline import device as device_mod

    cover = make_covers(UHD_BASE, UHD_H, UHD_W)[0]
    secret = secrets_for(1, UHD_SECRET)[0]
    p = stt.Params()
    cover_d = torch.from_numpy(cover).to(dev)
    kw = dict(master_key=SINGLE_KEY, params=p)

    def round_trip(salt):
        t0 = time.perf_counter()
        res = stt.embed_array(cover_d, secret, salt=salt, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = read_back(res.stego, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return res, got == secret, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    card_be = device_mod.TorchBackend(dev)
    cpu_be = device_mod.TorchBackend("cpu")
    sigma = math.sqrt(UHD_H * UHD_W / 12.0)  # u8 rounding noise per bin
    walk_mags = None
    tries, missed, groups_seen = [], [], set()
    for i, want in SINGLE_SALT_READS.items():
        salt = bytes([i]) * 16
        res, ok, e_ms, x_ms = count_no_launches(
            "7a single 4K cold" if i == 0 else f"7a single 4K salt {i}",
            launches, lambda salt=salt: round_trip(salt))
        card = res.stego.cpu().numpy()
        cpu = stt.embed_array(cover, secret, salt=salt, device="cpu",
                              **kw).stego
        reads = (ok, read_back(card, device="cpu", **kw) == secret,
                 count_no_launches(
                     f"7a card reads the CPU port's salt {i}", launches,
                     lambda cpu=cpu: read_back(torch.from_numpy(cpu).to(dev),
                                               **kw)) == secret,
                 read_back(cpu, device="cpu", **kw) == secret)
        errs_card, walk = _header_slot_errors(res.stego, secret, salt, p,
                                              card_be)
        errs_cpu, _ = _header_slot_errors(card, secret, salt, p, cpu_be)
        g_card, g_cpu = _double_groups(errs_card), _double_groups(errs_cpu)
        if walk_mags is None:
            spec = spectral.fft2(spectral.to_planes(cover_d))
            walk_mags = spec[tuple(torch.from_numpy(a).long().to(dev)
                                   for a in walk[:3])].abs().cpu().numpy()
            del spec
        weak = [(int(s), float(walk_mags[s])) for g in g_card
                for s in range(3 * g, 3 * g + 3)]
        log(f"7a salt {i}: reads back (card/card, CPU/card, card/CPU, "
            f"CPU/CPU, reader/stego) {reads}, expected {want}; embed "
            f"{e_ms!r} ms, extract {x_ms!r} ms; header slots read wrong "
            f"on the card {errs_card.tolist()}, by the CPU port "
            f"{errs_cpu.tolist()}; groups with two: card {g_card}, CPU "
            f"port {g_cpu}; their slots' cover |F| {weak} (rounding noise "
            f"{sigma!r} per bin)")
        if any(r != want for r in reads) or g_card != g_cpu or (
                bool(g_card) == want):
            raise AssertionError(f"7a salt {i}: reads {reads}, expected "
                                 f"{want}; groups {g_card} / {g_cpu}")
        groups_seen |= set(g_card)
        tries.append((i, e_ms, x_ms))
        if want:
            read_i, read_salt, cpu_read = i, salt, cpu
        else:
            missed.append(res.stego)
    if len(groups_seen) != 1:
        raise AssertionError(f"7a: the misses come from groups "
                             f"{sorted(groups_seen)}, not one weak group")
    got = count_launches(
        "7a batch read of the missed salts", launches,
        lambda: stt.extract_batch(torch.stack(missed), clen_hint=UHD_SECRET,
                                  **kw))
    log(f"7a extract_batch reads the {len(missed)} missed stegos: "
        f"{sum(g == secret for g in got)}/{len(missed)}")
    if any(g != secret for g in got):
        raise AssertionError("7a: extract_batch lost a missed stego")
    ce, cx = tries[0][1], tries[0][2]
    torch.cuda.reset_peak_memory_stats()
    (res, ok, e_ms, x_ms), wall, busy = count_no_launches(
        "7a single 4K", launches,
        lambda: device_busy(lambda: round_trip(read_salt)))
    if not ok:
        raise AssertionError("7a: the warm round trip lost the secret")
    peak = torch.cuda.max_memory_allocated()
    stego = res.stego
    if stego.device != cover_d.device or stego.shape != cover_d.shape:
        raise AssertionError(f"7a stego {stego.device} {tuple(stego.shape)}")
    card = stego.cpu().numpy()
    ps_card, ps_cpu = _psnr_hwc(card, cover), _psnr_hwc(cpu_read, cover)
    diff = card.astype(np.int16) - cpu_read.astype(np.int16)
    log(f"7a single image 4K {UHD_H}x{UHD_W} {UHD_SECRET} B default Params: "
        f"recovered 1/1 at salt index {read_i}; salt 0 (cold) "
        f"embed {ce!r} ms, extract {cx!r} ms; warm "
        f"embed {e_ms!r} ms, extract {x_ms!r} ms (under the profiler: wall "
        f"{wall!r} ms, device busy {busy!r} ms, idle share "
        f"{max(0.0, 1.0 - busy / wall)!r}); PSNR {ps_card!r} dB, CPU port "
        f"{ps_cpu!r} dB; card vs CPU port {int(np.count_nonzero(diff))} of "
        f"{diff.size} bytes differ, max |diff| {int(np.abs(diff).max())}; "
        f"peak memory {peak / 2**30!r} GiB")
    if abs(ps_card - ps_cpu) > PSNR_TOL_DB or np.abs(diff).max() > 1:
        raise AssertionError(f"7a: card PSNR {ps_card} vs CPU {ps_cpu}, "
                             f"max |diff| {np.abs(diff).max()}")
    spec = spectral.fft2(spectral.to_planes(cover_d))
    mags = spec.abs().reshape(3, -1)
    k = mags.shape[1] // 2
    t = time.perf_counter()
    kth = stats.median_upper(mags)
    torch.cuda.synchronize()
    t_kth = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    twin = stats.kth_smallest_nonneg(mags, k)
    torch.cuda.synchronize()
    t_twin = (time.perf_counter() - t) * 1e3
    equal = torch.equal(kth.view(torch.int32), twin.view(torch.int32))
    log(f"7a median of |F| (3 x {mags.shape[1]}): kthvalue {kth.tolist()} "
        f"({t_kth!r} ms), bisection twin {twin.tolist()} ({t_twin!r} ms), "
        f"bit-equal {equal}")
    if not equal:
        raise AssertionError("7a: torch.kthvalue disagrees with the "
                             "bisection twin")


def _count_embeds(fn):
    """(fn()'s result, {backend class name: embed_apply calls}): an
    embed_array makes 1 + its coherent refine passes, all on one backend."""
    from steganosaurus_tpu_torch.pipeline import device as device_mod

    n: dict = {}
    real = {cls: cls.embed_apply for cls in (device_mod.TorchBackend,
                                             device_mod.NumpyBackend)}

    def counted(real_fn):
        def embed_apply(self, *a, **k):
            key = type(self).__name__
            n[key] = n.get(key, 0) + 1
            return real_fn(self, *a, **k)
        return embed_apply

    for cls, fn_ in real.items():
        cls.embed_apply = counted(fn_)
    try:
        out = fn()
    finally:
        for cls, fn_ in real.items():
            cls.embed_apply = fn_
    return out, n


def _feature_mismatches(dev, covers) -> tuple[int, int]:
    """(feature bytes that differ, feature bytes) between the card's and
    the CPU port's cover-hash features of each (H, W, 3) cover."""
    import numpy as np

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.pipeline import device as device_mod

    p = stt.Params()
    n = total = 0
    for c in covers:
        planes = spectral.to_planes(np.ascontiguousarray(c))
        f_card = device_mod.TorchBackend(dev).analyze(planes, p)[3]
        f_cpu = device_mod.TorchBackend("cpu").analyze(planes, p)[3]
        n += int(np.count_nonzero(f_card != f_cpu))
        total += f_cpu.size
    return n, total


def phase_single_modes(dev, launches: dict) -> None:
    """7b: embed_array -> extract_array at 1080p, 4 KB (1 KB coherent), one
    Params per wire mode and one salt each, on the card: every embed pass
    on the card's TorchBackend (complex128 in f64 there; the CPU port runs
    it in the f64 NumpyBackend). The CPU port reads each card stego, and
    the card stego is held against the CPU port's stego of the same inputs
    (bytes differing, max |diff|: hard-write modes and complex128 +-1,
    threshold and coherent modes counted). cover_dependent_path runs on
    midstep_cover. Then the cover-hash features of the card and the CPU
    port on the 8 1080p mode covers and 4 4K bench covers: mismatched
    bytes."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.utils.covers import midstep_cover

    covers = np.ascontiguousarray(_fhd_mode_covers().transpose(0, 2, 3, 1))
    Params = stt.Params
    modes = {
        "default": Params(), "jitter=0.3": Params(jitter=0.3),
        "soft_write": Params(soft_write=True),
        "alpha_spread=0.5": Params(alpha_spread=0.5),
        "qim=3": Params(qim=3),
        "rs+pad_quantum=1024": Params(rs=True, pad_quantum=1024),
        "per_image_walk": Params(per_image_walk=True),
        "stealth": Params.stealth(),
        "coherent": Params(coherent=True),
        "coherent+qim=4": Params(coherent=True, qim=4),
        "adaptive_alpha": Params(adaptive_alpha=True),
        "cover_dependent_path": Params(cover_dependent_path=True),
        "complex128": Params(fft_dtype="complex128"),
    }
    loose = {"soft_write", "qim=3", "stealth", "coherent", "coherent+qim=4"}
    cdp_cover = midstep_cover(FHD_H, FHD_W, 43)
    for i, (name, p) in enumerate(modes.items()):
        cover = (cdp_cover if name == "cover_dependent_path"
                 else covers[i % FHD_B])
        # a coherent bit takes a whole site (three planes): at 1080p the
        # capacity holds COHERENT_SECRET, not MODE_SECRET
        secret = secrets_for(1, COHERENT_SECRET if p.coherent
                             else MODE_SECRET)[0]
        cover_d = torch.from_numpy(cover).to(dev)

        salt = bytes([16 * i + 1]) * 16

        def run(cover_d=cover_d, p=p, secret=secret, salt=salt):
            t = time.perf_counter()
            res, passes = _count_embeds(lambda: stt.embed_array(
                cover_d, secret, master_key=MASTER_KEY, params=p, salt=salt))
            got = read_back(res.stego, master_key=MASTER_KEY, params=p)
            torch.cuda.synchronize()
            return res.stego, got, passes, time.perf_counter() - t

        st, got, passes, dt = count_no_launches(f"7b {name}", launches, run)
        kw = dict(master_key=MASTER_KEY, params=p, salt=salt)
        card = st.cpu().numpy()
        cpu_reads = read_back(card, master_key=MASTER_KEY, params=p,
                              device="cpu")
        cpu, cpu_passes = _count_embeds(lambda kw=kw, cover=cover, s=secret:
                                        stt.embed_array(cover, s,
                                                        device="cpu", **kw))
        cpu = cpu.stego
        diff = card.astype(np.int16) - cpu.astype(np.int16)
        n, mx = int(np.count_nonzero(diff)), int(np.abs(diff).max())
        log(f"7b single image 1080p {len(secret)} B {name}: card round trip "
            f"{int(got == secret)}/1 ({dt!r} s wall), the CPU port reads "
            f"the card's stego {int(cpu_reads == secret)}/1; card vs CPU "
            f"port {n} of {diff.size} bytes differ, max |diff| {mx}; embed "
            f"passes (1 + coherent refines) card {passes}, CPU port "
            f"{cpu_passes}; PSNR {_psnr_hwc(card, cover)!r} dB")
        bad = (got != secret or cpu_reads != secret
               or set(passes) != {"TorchBackend"})
        if name not in loose:
            bad = bad or mx > 1 or n > FHD_MAX_DIFF_FRAC * diff.size
        if bad:
            raise AssertionError(f"7b {name}: recovery {got == secret}, CPU "
                                 f"{cpu_reads == secret}, {n} bytes, max {mx}")
    n, total = _feature_mismatches(dev, covers)
    log(f"7b cover-hash features, card vs CPU port, 8 1080p covers: {n} of "
        f"{total} bytes differ")
    uhd = make_covers(UHD_BASE, UHD_H, UHD_W)[:4]
    n, total = _feature_mismatches(dev, uhd)
    log(f"7b cover-hash features, card vs CPU port, 4 4K covers: {n} of "
        f"{total} bytes differ")


def phase_adaptive_batch(covers_d, launches: dict) -> None:
    """7c: an adaptive_alpha batch at 4K, B=16, 16 KB (nhwc: the full-grid
    cores), embed with verify=True, then extract_batch: 16/16 verified and
    read back, warm wall ms, PSNR, peak memory."""
    import torch

    import steganosaurus_tpu_torch as stt

    B = ADAPTIVE_B
    covers = covers_d[:B].permute(0, 2, 3, 1).contiguous()
    secrets = secrets_for(B, UHD_SECRET)
    p = stt.Params(adaptive_alpha=True)
    salts = [bytes([i + 70]) * 16 for i in range(B)]

    def run():
        t0 = time.perf_counter()
        res = stt.embed_batch(covers, secrets, master_key=MASTER_KEY,
                              params=p, salts=salts, device_resident=True,
                              verify=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = stt.extract_batch(res.stego, master_key=MASTER_KEY, params=p,
                                clen_hint=UHD_SECRET)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return res, got, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    count_no_launches("7c adaptive cold", launches, run)
    torch.cuda.reset_peak_memory_stats()
    res, got, e_ms, x_ms = count_no_launches("7c adaptive 4K", launches, run)
    peak = torch.cuda.max_memory_allocated()
    n_ok = sum(g == s for g, s in zip(got, secrets))
    psnr = psnr_mean(res.stego.permute(0, 3, 1, 2), covers_d[:B])
    log(f"7c adaptive_alpha 4K B={B} {UHD_SECRET} B: verified "
        f"{sum(res.verified)}/{B}, recovered {n_ok}/{B}; warm embed with "
        f"verify {e_ms!r} ms, extract {x_ms!r} ms; mean PSNR {psnr!r} dB; "
        f"peak memory {peak / 2**30!r} GiB")
    if n_ok != B or not all(res.verified) or not math.isfinite(psnr):
        raise AssertionError(f"7c: verified {res.verified}, recovered "
                             f"{n_ok}/{B}")


def phase_mixed_coherent(dev, launches: dict) -> None:
    """7d: one extract_batch over 1080p rows: two standard stegos
    (embed_batch), a coherent and a coherent + QIM stego (embed_array), and
    a plain cover: every secret comes back through the fused pass and the
    single-image extract of the rows it cannot read, the cover as None."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt

    covers = np.ascontiguousarray(
        _fhd_mode_covers()[:5].transpose(0, 2, 3, 1))
    covers_d = torch.from_numpy(covers).to(dev)
    secrets = (secrets_for(2, MODE_SECRET)
               + secrets_for(2, COHERENT_SECRET))
    Params = stt.Params
    std = stt.embed_batch(covers_d[:2], secrets[:2], master_key=MASTER_KEY,
                          device_resident=True).stego
    coh = [stt.embed_array(covers_d[2 + i], secrets[2 + i],
                           master_key=MASTER_KEY,
                           params=Params(coherent=True, qim=q),
                           salt=bytes([200 + 8 * i]) * 16).stego
           for i, q in enumerate((0, 4))]
    batch = torch.cat([std, torch.stack(coh), covers_d[4:5]])
    want = secrets + [None]

    def run():
        t = time.perf_counter()
        got = stt.extract_batch(batch, master_key=MASTER_KEY,
                                clen_hint=MODE_SECRET)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t

    got, dt = count_launches("7d mixed coherent", launches, run)
    log(f"7d mixed 1080p batch (2 standard, coherent, coherent+qim=4, a "
        f"plain cover), one extract_batch call ({dt!r} s): "
        f"{sum(g == w for g, w in zip(got, want))}/5 as expected, the cover "
        f"{'None' if got[4] is None else 'READ'}")
    if got != want:
        raise AssertionError(f"7d: {[g == w for g, w in zip(got, want)]}")


def phase_wrong_key(covers_d, launches: dict) -> None:
    """7e: the main path's 4K B=64 stegos through extract_batch under
    another key: no header parses, so every row also goes through the
    single-image extract_array (one FFT and two header reads each, as in
    the JAX package), and all come back None. Cold and warm wall ms."""
    import torch

    import steganosaurus_tpu_torch as stt

    secrets = secrets_for(UHD_B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(UHD_B)]
    stego = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                            salts=salts, device_resident=True,
                            layout="nchw").stego

    def run():
        t = time.perf_counter()
        got = stt.extract_batch(stego, master_key=MASTER_KEY2,
                                clen_hint=UHD_SECRET, layout="nchw")
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t) * 1e3

    got, cold = count_launches("7e wrong key cold", launches, run)
    got2, warm = count_launches("7e wrong key 4K", launches, run)
    log(f"7e wrong-key extract_batch 4K B={UHD_B}: {got.count(None)}/"
        f"{UHD_B} and {got2.count(None)}/{UHD_B} None; cold {cold!r} ms, "
        f"warm {warm!r} ms ({warm / UHD_B!r} ms per row)")
    if any(g is not None for g in got + got2):
        raise AssertionError("7e: a wrong-key row read as a secret")


def _scripted(reqs, counts: dict):
    """serve_loop's stdin for [(name, request)]: each request's line, with
    every K1 count set to 0 just before it; the counts of each request land
    in counts[name] once the loop has answered it (when it asks for the
    next line, or for the end of the input)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    prev = None
    for name, req in reqs:
        if prev is not None:
            counts[prev] = dict(ck.LAUNCHES)
        for k in ck.LAUNCHES:
            ck.LAUNCHES[k] = 0
        prev = name
        yield json.dumps(req) + "\n"
    if prev is not None:
        counts[prev] = dict(ck.LAUNCHES)


def _serve(reqs, params, warmup=()) -> tuple:
    """(replies, K1 counts per request) of one in-process serve_loop on the
    card under MASTER_KEY; the loop must answer every request and end 0."""
    import io

    from steganosaurus_tpu_torch.pipeline.serve import serve_loop

    counts: dict = {}
    out = io.StringIO()
    rc = serve_loop(None, MASTER_KEY, params, stdin=_scripted(reqs, counts),
                    stdout=out, warmup=warmup)
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    if rc != 0 or replies[0].get("op") != "ready" \
            or len(replies) != len(reqs) + 1:
        raise AssertionError(f"8a: rc {rc}, replies {replies}")
    return replies[1:], counts


def phase_serve(launches: dict, card: str) -> None:
    """8a: the serve worker in process at 4K, under --warmup 2160x3840:16384:
    embed / extract by PNG and by .npy, embed_batch of 8 PNGs, then
    extract_batch, stats; then a second worker pinned to
    Params(cover_dependent_path=True), one embed / extract of a 4K
    midstep_cover. Every secret comes back; K1 counted per request: the
    B=1 and batch ops must launch it, the cover-dependent ops must not."""
    import base64

    import numpy as np

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.io import image as image_io
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.utils.covers import midstep_cover

    B = SERVE_PNG_BATCH
    covers = make_covers(UHD_BASE, UHD_H, UHD_W)[:B]
    secrets = secrets_for(B, UHD_SECRET)
    b64 = [base64.b64encode(s).decode() for s in secrets]
    with tempfile.TemporaryDirectory(prefix="stt_serve_") as tmp:
        cov = [os.path.join(tmp, f"c{i}.png") for i in range(B)]
        out = [os.path.join(tmp, f"s{i}.png") for i in range(B)]
        for p, c in zip(cov, covers):
            image_io.save_png(p, c)
        np.save(os.path.join(tmp, "c.npy"), covers[1])
        reqs = [
            ("embed png", {"op": "embed", "in": cov[0], "out": out[0],
                           "secret_b64": b64[0]}),
            ("extract png", {"op": "extract", "in": out[0]}),
            ("embed npy", {"op": "embed", "in_npy": os.path.join(tmp, "c.npy"),
                           "out_npy": os.path.join(tmp, "s.npy"),
                           "secret_b64": b64[1]}),
            ("extract npy", {"op": "extract",
                             "in_npy": os.path.join(tmp, "s.npy")}),
            ("embed_batch", {"op": "embed_batch", "jobs": [
                {"in": c, "out": o, "secret_b64": s}
                for c, o, s in zip(cov, out, b64)]}),
            ("extract_batch", {"op": "extract_batch", "ins": out}),
            ("stats", {"op": "stats"}),
        ]
        t = time.perf_counter()
        rs, counts = _serve(reqs, stt.Params(),
                            warmup=[(UHD_H, UHD_W, UHD_SECRET)])
        wall = time.perf_counter() - t
        cdp = midstep_cover(UHD_H, UHD_W, 44)
        np.save(os.path.join(tmp, "m.npy"), cdp)
        cdp_secret = secrets[2][:CDP_SECRET]
        cdp_reqs = [
            ("cover-dependent embed", {
                "op": "embed", "in_npy": os.path.join(tmp, "m.npy"),
                "out_npy": os.path.join(tmp, "ms.npy"),
                "secret_b64": base64.b64encode(cdp_secret).decode()}),
            ("cover-dependent extract", {
                "op": "extract", "in_npy": os.path.join(tmp, "ms.npy")})]
        crs, ccounts = _serve(cdp_reqs,
                              stt.Params(cover_dependent_path=True))
    if not all(r["ok"] for r in rs + crs):
        raise AssertionError(f"8a: a request failed: {rs + crs}")
    got = [base64.b64decode(rs[1]["secret_b64"]),
           base64.b64decode(rs[3]["secret_b64"])]
    got_b = [base64.b64decode(r["secret_b64"]) for r in rs[5]["results"]]
    got_c = base64.b64decode(crs[1]["secret_b64"])
    if got != secrets[:2] or got_b != secrets or rs[4]["n_ok"] != B \
            or got_c != cdp_secret:
        raise AssertionError("8a: a secret did not come back")
    for name, n in counts.items():
        launches[f"8a {name}"] = n
        if name != "stats" and n[ck.KERNEL_TMA] <= 0:
            raise AssertionError(f"8a: {name} launched no K1: {n}")
    for name, n in ccounts.items():
        launches[f"8a {name}"] = n
        if any(n.values()):
            raise AssertionError(f"8a: {name} launched K1: {n}")
    log(f"8a serve in process, 4K, 16 KB, warmup + {len(reqs)} requests "
        f"in {wall:.1f} s; ms per request " + ", ".join(
            f"{name} {r['ms']!r}" for (name, _), r in zip(reqs, rs))
        + f"; cover-dependent {crs[0]['ms']!r} / {crs[1]['ms']!r}; K1 "
        f"launches per request {counts}, cover-dependent {ccounts}; "
        f"worker stats {rs[6]['ops']} ({card})")


def phase_serve_worker(card: str) -> dict:
    """8b: `python -m steganosaurus_tpu_torch.cli serve --key K --warmup
    2160x3840:16384` as a process of its own, through
    tools/serve_latency_torch.measure: seconds to its ready line and its
    warm-up, then warm client-side p50/p95 over SERVE_ROUNDS rounds of the
    four request classes (PNG embed and extract, .npy embed and extract) on
    a 4K bench cover with a 16 KB secret, every round trip verified; the
    worker's stats; shutdown, exit code 0."""
    import base64

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import serve_latency_torch
    finally:
        sys.path.remove(str(REPO / "tools"))
    cmd = [sys.executable, "-m", "steganosaurus_tpu_torch.cli", "serve",
           "--key", base64.b64encode(MASTER_KEY).decode(),
           "--warmup", f"{UHD_H}x{UHD_W}:{UHD_SECRET}"]
    cover = make_covers(UHD_BASE, UHD_H, UHD_W)[2]
    secret = secrets_for(3, UHD_SECRET)[2]
    with tempfile.TemporaryDirectory(prefix="stt_worker_") as tmp:
        rec = serve_latency_torch.measure(cmd, cover, secret, SERVE_ROUNDS,
                                          tmp)
    log(f"8b worker: ready line after {rec['ready_s']!r} s (process start, "
        f"imports, warm-up {rec['warmup_s']} s) ({card})")
    for k, v in rec["client"].items():
        log(f"8b warm client-side {k} at 4K 16 KB over n={SERVE_ROUNDS}: "
            f"p50 {v['p50'] * 1e3!r} ms, p95 {v['p95'] * 1e3!r} ms, min "
            f"{v['min'] * 1e3!r} ms ({card})")
    log(f"8b worker stats: {rec['worker_stats']} ({card})")
    return rec


def _cli(args, platform: str = "") -> subprocess.Popen:
    """`python -m steganosaurus_tpu_torch.cli *args` on the card (or with
    STEGANOSAURUS_PLATFORM=platform), output captured."""
    env = {k: v for k, v in os.environ.items()
           if k != "STEGANOSAURUS_PLATFORM"}
    env["PYTHONPATH"] = str(REPO)
    if platform:
        env["STEGANOSAURUS_PLATFORM"] = platform
    return subprocess.Popen(
        [sys.executable, "-m", "steganosaurus_tpu_torch.cli", *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))


def _cli_all(runs: dict) -> dict:
    """{name: (args, platform)} run all at once -> {name: (rc, stdout,
    stderr, s)}; every process is waited for or killed."""
    procs = {}
    try:
        t = time.perf_counter()
        for name, (args, plat) in runs.items():
            procs[name] = _cli(args, plat)
        out = {}
        for name, p in procs.items():
            o, e = p.communicate(timeout=600)
            out[name] = (p.returncode, o, e, time.perf_counter() - t)
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_cli(card: str) -> None:
    """8c: the CLI one-shots at 1080p, each its own process: gen-key
    --key-out F --wrap-pass W; then at once an embed on the card and one
    with STEGANOSAURUS_PLATFORM=cpu (--key F's text --wrap-pass W), `check`
    and batch-embed of 4 covers; then at once the card's and the CPU's
    extract of each other's stego and of the card's own, an extract under a
    wrong passphrase (rc 1, "Magic not found") and batch-extract. Every
    secret comes back."""
    from steganosaurus_tpu_torch.io import image as image_io

    n = CLI_BATCH_B
    covers = make_covers(n, FHD_H, FHD_W)
    secret = "phase 8c one-shot secret"
    iters = ["--pbkdf2_iter", "5000"]
    with tempfile.TemporaryDirectory(prefix="stt_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "in").mkdir()
        for i, c in enumerate(covers):
            image_io.save_png(str(tmp / "in" / f"c{i}.png"), c)
        (tmp / "secrets.txt").write_text(
            "".join(f"batch secret {i}\n" for i in range(n)))
        cover = tmp / "in" / "c0.png"
        r = _cli_all({"gen-key": (["gen-key", "--key-out", tmp / "key",
                                   "--wrap-pass", "wp", *iters], "")})
        if r["gen-key"][0] != 0:
            raise AssertionError(f"8c gen-key: {r}")
        key = ["--key", (tmp / "key").read_text().strip(),
               "--wrap-pass", "wp"]
        r1 = _cli_all({
            "embed card": (["embed", "--in", cover, "--out", tmp / "card.png",
                            "--secret", secret, *key, *iters], ""),
            "embed cpu": (["embed", "--in", cover, "--out", tmp / "cpu.png",
                           "--secret", secret, *key, *iters], "cpu"),
            "check": (["check", "--in", cover, "--secret", secret, *key,
                       *iters], ""),
            "batch-embed": (["batch-embed", "--in-dir", tmp / "in",
                             "--out-dir", tmp / "out", "--secrets-file",
                             tmp / "secrets.txt", "--verify", "1", *key,
                             *iters], ""),
        })
        r2 = _cli_all({
            "extract card/card": (["extract", "--in", tmp / "card.png", *key,
                                   *iters], ""),
            "extract card/cpu": (["extract", "--in", tmp / "cpu.png", *key,
                                  *iters], ""),
            "extract cpu/card": (["extract", "--in", tmp / "card.png", *key,
                                  *iters], "cpu"),
            "extract wrong pass": (["extract", "--in", tmp / "card.png",
                                    "--pass", "wrong", *iters], ""),
            "batch-extract": (["batch-extract", "--in-dir", tmp / "out",
                               *key, *iters], ""),
        })
    res = {**r, **r1, **r2}
    for name, (rc, o, e, s) in res.items():
        log(f"8c {name}: rc {rc}, done {s:.1f} s into its round; stdout "
            f"{o.strip().splitlines()[-1:]} ({card})")
    bad = []
    for name in ("embed card", "embed cpu", "check", "batch-embed",
                 "extract card/card", "extract card/cpu", "extract cpu/card",
                 "batch-extract"):
        if res[name][0] != 0:
            bad.append(name)
    for name in ("extract card/card", "extract card/cpu", "extract cpu/card"):
        if res[name][1] != secret + "\n":
            bad.append(name)
    if "round-trip: ok" not in res["check"][1]:
        bad.append("check")
    if not res["batch-embed"][1].startswith(f"Embedded {n}/{n}"):
        bad.append("batch-embed")
    if res["batch-extract"][1].splitlines() != [
            f"c{i}.png\tbatch secret {i}" for i in range(n)]:
        bad.append("batch-extract")
    rc, _, err, _ = res["extract wrong pass"]
    if rc != 1 or "Magic not found" not in err:
        bad.append("extract wrong pass")
    if bad:
        raise AssertionError(f"8c failed: {bad}: " + "; ".join(
            f"{k}: {res[k][0]} {res[k][1][-300:]!r} {res[k][2][-1500:]!r}"
            for k in dict.fromkeys(bad)))


def record_k1_shapes(seen: set):
    """Wrap the stage-1 wrapper so that the _k1_key of every call on the
    card, the route it launched included, lands in `seen`; returns the
    function that undoes it. The wrapped call is the wrapper itself, so
    launches are counted as before."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    real = ck.fwd_stage1

    def recorded(imgs_u8, exr_bf16, exi_bf16, center, tables=None):
        if imgs_u8.is_cuda:
            seen.add(_k1_key(imgs_u8, exr_bf16.shape[0], center))
        return real(imgs_u8, exr_bf16, exi_bf16, center, tables)

    ck.fwd_stage1 = recorded
    return lambda: setattr(ck, "fwd_stage1", real)


def phase_k1_shapes(dev, seen: set, checked: set) -> None:
    """6: each (planes, H, W, Kx, center, route) that the paths gave the
    stage-1 wrapper and phase 3 did not check, held against the plain
    version through the wrapper on seeded u8 images on the same route (the
    load route at W % 16 == 0 on a view whose base is not 16-byte
    aligned), with the tables the path builds for it."""
    import numpy as np
    import torch

    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(6)
    todo = sorted(k for k in seen if k not in checked)
    log(f"K1 shapes the paths gave the wrapper: {len(seen)}, of which "
        f"{len(seen) - len(todo)} checked in phase 3: {sorted(seen)}")
    for key in todo:
        P, H, W, Kx, center, route = key
        offset = 1 if route == ck.KERNEL_LDG and W % 16 == 0 else 0
        x = _offset_u8(rng, (P, H, W), dev, offset)
        if ck.route_for(W, x.data_ptr()) != route:
            raise AssertionError(f"{key}: the check would not take {route}")
        er, ei = (torch.from_numpy(t).to(dev).to(torch.bfloat16)
                  for t in corner._dft_tables(W, Kx))
        _k1_check(f"{route} path shape {key}",
                  ck.fwd_stage1(x, er, ei, center),
                  ck.fwd_stage1_plain(x, er, ei, center))
        del x
        torch.cuda.empty_cache()


def main() -> int:
    if not (PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG} is missing; run from a checkout of the "
              f"repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    with tempfile.TemporaryDirectory(prefix="stt_walk_") as walk_cache:
        os.environ["STEGANOSAURUS_WALK_CACHE"] = walk_cache
        from steganosaurus_tpu_torch import runtime
        from steganosaurus_tpu_torch.spectral import corner_kernels as ck

        runtime.configure_precision()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        t_all = time.perf_counter()
        card = phase_probe()
        torch.cuda.synchronize()
        phase_build()
        torch.cuda.synchronize()

        t = time.perf_counter()
        base = make_covers(UHD_BASE, UHD_H, UHD_W)
        reps = -(-UHD_B // UHD_BASE)
        covers_d = torch.from_numpy(base).to(dev).permute(0, 3, 1, 2)
        covers_d = covers_d.repeat(reps, 1, 1, 1)[:UHD_B].contiguous()
        torch.cuda.synchronize()
        log(f"covers: {UHD_BASE} x {UHD_H}x{UHD_W} made and tiled to "
            f"{tuple(covers_d.shape)} on the card in "
            f"{time.perf_counter() - t:.1f} s")

        k1, checked, odd_d = timed("K1", phase_k1, covers_d, card)
        launches: dict = {}
        seen: set = set()
        undo = record_k1_shapes(seen)
        try:
            count_launches("small", launches, lambda: phase_small(dev))
            launches["round trip"], ms4 = phase_uhd(covers_d)
            torch.cuda.synchronize()
            timed("ragged grid", phase_ragged_grid, dev, launches)
            launches["4c round trip"], ms4c = timed(
                "4K at 3839", phase_uhd, odd_d, "4c 4K cropped", ck.KERNEL_LDG)
            log(f"4c against phase 4, warm ms: embed {ms4c[0]!r} vs "
                f"{ms4[0]!r}, extract {ms4c[1]!r} vs {ms4[1]!r}, round trip "
                f"{sum(ms4c)!r} vs {sum(ms4)!r} ({sum(ms4c) / sum(ms4):.3f}x)")
            del odd_d
            torch.cuda.empty_cache()
            stego = timed("stream", phase_stream, covers_d, launches)
            timed("rotating", phase_rotating, covers_d, launches)
            timed("quality", phase_quality, covers_d, stego, launches)
            del stego
            timed("soft", phase_soft, dev, launches)
            timed("ragged", phase_ragged, dev, launches)
            timed("modes", phase_modes, dev, launches)
            timed("stealth", phase_stealth, covers_d, launches)
            timed("rs padded", phase_rs_padded, covers_d, launches)
            timed("single 4K", phase_single_4k, dev, launches)
            timed("single modes", phase_single_modes, dev, launches)
            timed("adaptive batch", phase_adaptive_batch, covers_d, launches)
            timed("mixed coherent", phase_mixed_coherent, dev, launches)
            timed("wrong key", phase_wrong_key, covers_d, launches)
            del covers_d
            torch.cuda.empty_cache()
            timed("serve", phase_serve, launches, card)
            torch.cuda.empty_cache()
            timed("serve worker", phase_serve_worker, card)
            timed("cli", phase_cli, card)
        finally:
            undo()
        log(f"K1 launches per path: {launches}")
        timed("K1 shapes", phase_k1_shapes, dev, seen, checked)
        for k in k1:
            k["launches"] = sum(n[k["name"]] for n in launches.values())
        log(f"smoke wall time {time.perf_counter() - t_all:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
