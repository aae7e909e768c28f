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
process of its own, and the `turtlefft` CLI's one-shot modes), then the
parallel layer (mesh= over the cards and over logical shards of one card,
the sharded single-image FFT) and the cost model, then the graft entry
(its forward step and its multichip dry run), and prints one line per
measurement. The last two lines
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
             call at 3839 and at the 4b grid. Stage 2's prep in K1's
             epilogue (the copies, the energies and their reduce) timed at
             4K on both routes in launches paired back to back against K1
             then the prep pass (the route before), K1 alone and K1
             writing the copies alone
  3b. K3 K4e the embed's write, write floor and u8 epilogue kernels
             (csrc/corner_write_floor.cu: write_floor and floor_only;
             csrc/corner_epilogue.cu) against their plain versions
             (spectral/write_kernels.py) at the main path's 4K B=64, 1080p
             B=8, 512x512 B=8, 256x256 B=1, the 4b grid, 4c's crop and a
             2560x2560 B=2 corner too large for write_floor's resident
             schedule, on each grid's forward corner spectrum, a seeded
             walk of a 16 KB frame's bins and the frame of seeded stream
             words: hard, soft, jittered and spread writes and QIM (floor
             only), floor 0, 0.45, boosting (b range printed; every image
             must boost) and clipping at 32; K3 bit-equal to its ordered
             twin (the plain version summing the floor's terms in the
             kernel's order) in every case, and against the eager plain
             version (torch.sum) bit-equal wherever b == 1, else within
             1e-5 of its output's scale, b within 1e-5 relative, the same
             bits read back at every walk bin;
             write_floor's bf16 operand mode bit-equal to its f32 output
             cast (bf16(dr), bf16(-di)), its RepFrame (stream words) and,
             on resident corners, its two-pass schedule bit-equal to the
             u8-frame resident output, the schedule each grid must take;
             K4e on the inverse DFT of K3's output, centering on and off,
             NCHW and NHWC, bit-equal. At 4K B=64, in turns beside each
             bound (utils/cost.py): write_floor as the main path calls it
             (RepFrame, bf16 operands) and its plain version, in f32, on
             the u8 frame, on the two-pass schedule; floor_only and K4e and
             their plain versions; then the resident schedule's phases by
             its own clock
  3c. K4     the inverse DFT's x-stage with the u8 epilogue fused
             (csrc/corner_ifft_epilogue.cu) against its plain version (the
             two cuBLAS x-stage products, their difference, K4e's
             arithmetic in eager torch) on the main path's inputs (K3's
             bf16 operands of each grid's forward spectrum, then the
             y-stage) at 4K B=64, 1080p B=8, 512x512 B=8, 256x256 B=1, the
             4b grid, 4c's crop, a phone screenshot (1170x2532 B=8) and
             512x512 views one element off their alignment; HGMMA and
             UTMALDG in the SASS of its NCHW and NHWC instantiations,
             UTMASTG (the store warp's TMA stores) in the NCHW ones;
             centering on and off, NCHW and NHWC: its f32 check
             mode within 1e-5 of max|plain|, every u8 byte off by one and
             at a plain value within that bound of a .5 boundary. At 4K
             B=64 and at 2160x3839, in turns beside the bound: K4 NCHW and
             NHWC, the plain version, the library composition it replaced
             (cuBLAS products, t -=, K4e) and one torch.mm of the
             concatenated operands
  3d. K2     forward stage 2's prep pass, band kernel and K2
             (csrc/corner_stage2.cu) against their plain versions on 3c's
             grids' stage-1 output (K1 on each grid's covers; the 512x512
             views one element off their alignment): the prep's bf16 copies
             bit-equal to .to(bf16), its energies within 1e-6 relative of
             torch.sum's (band_columns') and of the exact f64 sum, the band
             sets they pick beside band_columns' (differences counted and
             printed); the band operand and mask bit-equal; K2 within 1e-5
             of max|twin| against fwd_stage2_plain(band="bf16x6") on the
             same band; HGMMA and UTMALDG in K2's SASS; K1 with the prep
             in its epilogue on each grid: ar, ai and the copies bit-equal
             to K1 alone and the prep pass's, its energies within 2^-24 of
             the exact sum, band differences against the prep pass's
             counted. At 4K B=64, in turns beside the bounds: the three
             kernels and the prep's reduce, their plain versions, the
             eager composition they replace
             (corner._fwd_y_split), the new stage as a whole (prep, topk,
             band, K2) and one torch.bmm of T with the bf16 operands into
             f32 (the bulk without the band)
  3e. K6     the inverse DFT's y-stage (csrc/corner_ifft_y.cu) against
             its plain version (the eager chain it replaced: four cuBLAS
             bf16 products into f32, their difference and sum, two casts)
             on 3c's grids' main-path operands (K3's bf16 operands of each
             grid's forward spectrum; the 512x512 views one element off
             their alignment, through the wrapper's staging copy): its f32
             check mode within 1e-5 of max|plain|, its bf16 outputs the
             round-to-nearest-even casts of those sums and, against the
             plain's, equal or one bf16 ulp apart, or where an ulp is below
             that bound within it and one ulp (each count printed); HGMMA and
             UTMALDG in its SASS. At 4K B=64 the RMS error of its f32 sums
             and of the plain chain's against the exact sum of the same
             bf16 products (24 planes), and, in turns beside the bound
             (utils/cost.py ifft_y_cost): K6, the plain chain and one
             torch.bmm of the real table (expanded) with the stacked
             (P, 2Ky, Kx) operands into bf16 (stacking not timed)
  3f. K5     the extract's walk read and Rep-3/Rep-7 decode
             (csrc/corner_read_decode.cu, through the walk's read plan)
             against its plain version (spectral/read_kernels.py
             read_decode_plain): at 4K B=64 on phase 4's forward spectrum
             and walk, then on seeded spectra with planted ties (+0.0,
             -0.0, a group summing to +0.0, a tiny negative that rounds to
             -0.0 in bf16) at the 4K walk (B=1), 1080p (B=5 and B=9) and
             512x512 (B=3 and B=1); every flag combination (header 912 or
             0, Rep-7 or RS, hard and soft rows, bf16 or f32 soft values,
             jitter, raw bits, sign(sin alpha) +1, -1, 0) bit-equal, and at
             4K B=64 bit-equal to the eager chain it replaced. The 4K
             walk's touched 32-byte sectors beside a uniform walk's share;
             at 4K B=64, in turns beside the bound (utils/cost.py
             read_decode_cost over this walk's sectors and its plan's
             bytes): K5, the plain version, the eager chain (gather,
             decision values, _decode_sections[_soft]) and the lone gather
             ci[:, plane, y, x], which K5 must beat; at 4K B=1 (the serve
             worker's hinted extract) K5, the plain version and the lone
             gather
  4. path    512x512, B=8, 100 B round trip (also held against the port on
             the CPU), then 2160x3840, B=64, 16 KB: all secrets recovered,
             K1 launched on the TMA route alone, with stage 2's prep in its
             epilogue, the prep's reduce, the band kernel and K2 once per
             forward DFT (two per round trip), the prep pass and the eager
             stage 2 (corner._fwd_y_split) never, K5 once (the extract's
             one fused pass) and the eager read never, no read plan built,
             warm timings, PSNR, peak memory, the sha256 of the warm round
             trip's stego (4c too); the 4K stego against the prep pass's
             route (bytes that differ, planes whose band moved: bytes may
             differ only where a band did)
  4b. ragged 1079x1917, B=4, 1 KB round trip: W % 16 != 0, so stage 1
             goes through the load route alone
  4c. odd 4K phase 4's covers cropped to 2160x3839, B=64, 16 KB: 64/64
             through the load route alone, warm embed and extract ms beside
             phase 4's, PSNR, peak memory (4 and 4c print the stego's
             sha256, peak memory and warm round trip beside the parent's
             record, RECORDED)
  4d. highest phase 4's 512x512 B=8 round trip under
             STEGANOSAURUS_MM_PRECISION=highest: 8/8, K3 and K4e once (no
             K1, no K4), the stego within +-1 of the CPU port's
  4e. modes  the other precision modes (STEGANOSAURUS_MM_PRECISION, set
             per round trip and restored): K2 at band widths 0 (bf16), 64
             (mix_split's static band) and Kx (every column, no bulk: the
             HIGH modes) on phase 4's spectrum, each within 1e-5 of
             max|twin| of fwd_stage2_plain(bf16x6) on 12 planes and timed
             in turns beside its bound, the bf16 torch.bmm of the bulk and
             (all band) the f32 torch.bmm of the stage; the f32 stages
             of the HIGH modes at 4K B=16 (stage 1, stage 2 under
             highest, the inverse's y-stage, mix2's cast, its x-stage),
             each beside its bound and the kernel the default path runs
             for it, timed in turns; 4K 16 KB round
             trips under mix_split and mix at B=64 (64/64, payload post-ECC
             0, raw BER) and under mix2, mix_conservative and high at B=16
             (B/B), each with warm ms, PSNR, peak memory and K2's launches
             by band width, its launches checked against its mode's route;
             bf16 at 4K B=16 reported, not gated, and its 512x512 B=8
             stego within +-1 of the CPU port's
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
  9a. mesh   make_mesh() over the machine's cards (one here): the 4K B=64
             16 KB round trip with mesh=, phase 4's covers and salts:
             64/64, the stego byte-equal to phase 4's, K1 once per shard
             per pass, warm ms beside phase 4's
  9b. shards 4 logical shards of the one card (the sharded arithmetic, not
             the interconnect), the same batch: 64/64, the stego within +-1
             of phase 4's on at most 0.5% of bytes (counted), K1 once per
             shard per pass; embed_stream -> extract_stream over the mesh,
             depth 2, 2 batches; verify=True with 3 rows made to fail their
             first read-back: the retry runs unsharded (4 does not divide 3)
  9c. fft_dist one 4K bench cover's spectrum over 4 logical shards:
             embed_core_distributed on a 16 KB frame's walk bins within
             2e-3 of the unsharded full-grid embed's planes, at most 4000
             u8 bytes rounding apart, its u8 stego
             read back by read_core_distributed (< 5% raw errors), the
             sharded median equal to the bisection median; ms of both
  9d. cost   utils/cost.py at the 4K headline: per-stage FLOPs, bytes and
             bounds on the card's data-sheet peaks, the round trip's bound,
             measure_device_step's core times and the share of the bound
             (above 1.0 fails), measure_link with a 256 MiB pinned buffer;
             the 32-byte sectors the main path's walk touches beside the
             uniform walk's share the model counts for the read
  9e. dry run  the graft entry (steganosaurus_tpu_torch/graft_entry.py):
             entry()'s forward step (2x128x128, the full-grid core) on the
             card against the CPU, +-1 on at most 0.5% of bytes (counted);
             dryrun_multichip(4) on 4 logical shards of the card and, with
             2 or more cards, dryrun_multichip(cards) over them: axes 1,
             1b, 1c round trips at 128x128 B=n, the flat-scaling bound, the
             sharded single-image FFT's exact and u8 reads; each part's
             wall time and K1 / K3 / K4 / K4e launches
At the end every counted path (4-5, 7, 8a, 9) must have launched K4 once
for each K3 launch and no K4e (4d: K4e, no K4). Every path of phases 4-5,
7d-7e, 9a, 9b, 9d, 9e's dry runs and the serve
worker's B=1 and batch ops (8a) must launch K1 (on the TMA route,
corner_stage1_wgmma, or in 4b and 4c on the load route,
corner_stage1_wgmma_ldg); the single-image paths, the full-grid batch
cores (7a-7c, 9e's entry()), the cover-dependent worker (8a) and fft_dist
(9c) run torch.fft and must launch no kernel of the port. Each corner
embed must launch K4 once (K4e only under highest, 4d) and K3 once:
write_floor on its resident schedule (phases 4, 4c, 9a, 9b, 8a's embeds,
the shared-walk modes of 5f), or floor_only where the write stays eager
(5f's QIM and per-image walks, 5g).
The launches are counted per path and per kernel, and each (planes, H, W,
Kx, center, route, prep) the paths hand the stage-1 wrapper is recorded.
  6. K1 shapes  every recorded shape that phase 3 did not check is held
             against the plain version, through the wrapper, on seeded u8
             images on the same route, with the prep the path asked for
             (copies against .to(bf16), energies against
             stage1_energy_plain)
"""

from __future__ import annotations

import functools
import hashlib
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
# the card against the CPU port under the other precision modes (4e): the
# bound of PERF.md section 2, +-1 on at most 0.5% of the bytes (the bf16
# stages sum in other orders on the card)
MODE_MAX_DIFF_FRAC = 5e-3
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


def zero_counts() -> None:
    """Set every hand kernel's launch count to 0: K1's routes, the prep and
    K2 (corner_kernels.LAUNCHES, and K2's by band width,
    corner_kernels.BAND_WIDTHS), the embed's K3 / K4 / K4e entry points
    (write_kernels.LAUNCHES) and the extract's K5 with the eager read
    chain's calls (read_kernels.LAUNCHES)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import read_kernels as rk
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    for counts in (ck.LAUNCHES, wk.LAUNCHES, rk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ck.BAND_WIDTHS.clear()


# the precision mode (STEGANOSAURUS_MM_PRECISION) of each counted path
# that does not run the default, mix_adaptive
PATH_MODES = {"4d highest": "highest"}


def path_mode(path: str):
    """The resolved precision mode a counted path ran under."""
    from steganosaurus_tpu_torch.spectral import corner

    return corner.resolve(PATH_MODES.get(path, "mix_adaptive"))


def read_counts() -> dict:
    """{kernel name: launches since zero_counts()} of every hand kernel."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import read_kernels as rk
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    return {**ck.LAUNCHES, **wk.LAUNCHES, **rk.LAUNCHES}


def _inverse_launches(mode, embeds: int) -> tuple:
    """(K6, K4, K4e) launches of `embeds` corner embeds under the resolved
    precision mode: K6 where the inverse's y-stage is bf16 (K4 then takes
    its output; under mix2 the f32 y-stage's, cast), K4 where its x-stage
    is bf16, else K4e after the f32 inverse."""
    x16 = mode.inv_x == "bf16"
    return ((embeds if x16 and mode.inv_y == "bf16" else 0),
            embeds if x16 else 0, 0 if x16 else embeds)


def check_embed_kernels(path: str, counts: dict, embeds: int,
                        floor_only: bool = False,
                        mode: str = "mix_adaptive") -> None:
    """`embeds` corner embeds on `path`, each through K3's write_floor on
    its resident schedule, or (QIM, per-image walks: floor_only) its
    floor_only, then, as the precision `mode` routes the inverse
    (_inverse_launches), through K6 (the y-stage, no staging copy) and K4
    (the x-stage with the u8 epilogue), or K4e alone."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    k6, k4, k4e = _inverse_launches(corner.resolve(mode), embeds)
    want = {wk.KERNEL_WRITE_FLOOR: 0 if floor_only else embeds,
            wk.KERNEL_WRITE_FLOOR_TWO_PASS: 0,
            wk.KERNEL_FLOOR_ONLY: embeds if floor_only else 0,
            wk.KERNEL_IFFT_Y: k6,
            wk.KERNEL_IFFT_Y_PADDED: 0,
            wk.KERNEL_IFFT_EPILOGUE: k4,
            wk.KERNEL_EPILOGUE: k4e}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: K3 / K6 / K4 / K4e launches {got}, "
                             f"want {want}")


def check_epilogues(launches: dict) -> None:
    """Every counted path ends each corner embed in K6 and K4, one launch
    each for each K3 launch (write_floor or floor_only: one per corner
    embed), and launches no K4e; the paths of other precision modes
    (PATH_MODES: 4d, 4e) as their mode routes the inverse
    (_inverse_launches)."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    bad = {}
    for path, c in launches.items():
        k3 = c[wk.KERNEL_WRITE_FLOOR] + c[wk.KERNEL_FLOOR_ONLY]
        want = _inverse_launches(path_mode(path), k3)
        got = (c[wk.KERNEL_IFFT_Y], c[wk.KERNEL_IFFT_EPILOGUE],
               c[wk.KERNEL_EPILOGUE])
        if got != want:
            bad[path] = (got, want)
    if bad:
        raise AssertionError(f"(K6, K4, K4e) launches against the corner "
                             f"embeds' K3 launches, (got, want) by path: "
                             f"{bad}")


def _stage2_launches(mode, k1: int, k2: int) -> tuple:
    """(K1 with the prep, the prep's reduce, the prep pass, band, K2)
    launches of a path under the resolved precision mode whose K1 launched
    k1 times and K2 k2 times (the forward DFTs: K1's count where stage 1 is
    bf16). Where stage 2 has a bulk its bf16 copies come from K1's
    epilogue after a bf16 stage 1, with the energies and their reduce
    where they pick the band (adaptive), and from the prep pass after an
    f32 stage 1; the band pass runs where stage 2 has a band (every corner
    of the smoke is wider than the default band); none under highest."""
    n = k1 if mode.stage1 == "bf16" else k2
    if mode.fwd2 == "highest":
        return 0, 0, 0, 0, 0
    bulk = mode.fwd2 != "high"
    fused = bulk and mode.stage1 == "bf16"
    return (n if fused else 0, n if fused and mode.fwd2 == "adaptive" else 0,
            n if bulk and not fused else 0, 0 if mode.fwd2 == "bf16" else n,
            n)


def _stage2_counts(c: dict) -> tuple:
    """(K1 with the prep, the prep's reduce, the prep pass, band, K2)
    launches in the counts c, as _stage2_launches orders them."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    return (c[ck.KERNEL_K1_PREP], c[ck.KERNEL_PREP_REDUCE], c[ck.KERNEL_PREP],
            c[ck.KERNEL_BAND], c[ck.KERNEL_STAGE2])


def check_stage2(launches: dict) -> None:
    """Every counted path's forward DFTs run stage 2 as _stage2_launches
    says for its precision mode (PATH_MODES; mix_adaptive by default: K1
    with the prep in its epilogue, the prep's reduce, the band kernel and
    K2, one launch each for each K1 launch, and the prep pass never; none
    under highest, 4d)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    bad = {}
    for path, c in launches.items():
        k1 = sum(c[k] for k in ck.K1_ROUTES)
        got = _stage2_counts(c)
        want = _stage2_launches(path_mode(path), k1, c[ck.KERNEL_STAGE2])
        if got != want or (path_mode(path).stage1 != "bf16" and k1):
            bad[path] = (got, want)
    if bad:
        raise AssertionError(f"(K1 with the prep, reduce, prep pass, band, "
                             f"K2) launches against K1's, (got, want) by "
                             f"path: {bad}")


def count_eager_stage2(fn):
    """(fn(), how often corner._fwd_y_split, the eager stage 2 that K2
    replaced, ran during it)."""
    from steganosaurus_tpu_torch.spectral import corner

    real, calls = corner._fwd_y_split, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    corner._fwd_y_split = counted
    try:
        return fn(), calls[0]
    finally:
        corner._fwd_y_split = real


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
# 3b: the embed's write, write floor (K3) and u8 epilogue (K4e) against
# their plain versions, on (name, B, H, W) grids: the main path's, 1080p
# B=8, phase 4's 512x512 B=8, 4b's grid and 4c's crop. K3 bit-equal to its
# ordered twin; against the eager plain version (the three per-image sums
# by torch.sum, in another order) within WRITE_REL of its output's scale
# and b within WRITE_REL relative, bit-equal wherever b == 1, the same bits
# read back; K4e bit-equal.
WRITE_GRIDS = (("4K", UHD_B, UHD_H, UHD_W), ("1080p", FHD_B, FHD_H, FHD_W),
               ("512x512", SMALL_B, SMALL_H, SMALL_W),
               ("256x256 B=1", 1, 256, 256),
               ("4b", *RAGGED_GRID), ("4c", UHD_B, UHD_H, UHD_W - 1),
               ("2560x2560", 2, 2560, 2560))
WRITE_REL = 1e-5
# K3's write_floor at each grid: the f32 delta held against the plain
# version as above; the bf16 operand mode bit-equal to the f32 output cast
# (bf16(dr), bf16(-di)) and its boost equal; with a floor, the two-pass
# schedule bit-equal to the resident one (the same sums in the same order).
# The 2560x2560 corner (1280 x 1280) is too large for the resident
# schedule: its write_floor runs the two-pass schedule by itself.
WRITE_TWO_PASS_GRIDS = ("2560x2560",)
# (write rule, floor) cases: all at the main path's grid, the first
# WRITE_CASES_SMALL at the others. "boost" is twice the largest spatial
# RMS the write reaches alone (every image boosts), "clip" a floor no boost
# of at most 32 reaches; a "qim" rule writes in eager torch and takes K3's
# floor_only
WRITE_CASES = (("hard", "0.45"), ("soft+jitter", "boost"),
               ("spread", "0.45"), ("qim", "boost"), ("hard", "0"),
               ("hard", "boost"), ("hard", "clip"), ("soft", "0.45"),
               ("jitter", "0.45"), ("spread+jitter+soft", "boost"),
               ("qim+soft+jitter", "0.45"))
WRITE_CASES_SMALL = 4
WRITE_QIM_LEVELS = 3
# 3c: K4, the inverse DFT's x-stage with the u8 epilogue, against its plain
# version on the main path's inputs at 3b's grids but the 2560x2560 one,
# at the phone screenshot's (W % 16 == 4) and at 512x512 on views one
# element off their alignment. The f32 check
# mode within K4_REL of the plain values' scale (K1's bound: f32 sums of
# the same exact bf16 products in another order); u8 bytes equal but for
# bytes one apart, each where the plain value lies within that bound of a
# .5 boundary.
K4_GRIDS = WRITE_GRIDS[:6] + (("phone", *PHONE_GRID),
                              ("512x512 unaligned", SMALL_B, SMALL_H,
                               SMALL_W))
K4_REL = 1e-5
# 3d: the prep pass and K2 on 3c's grids. The prep's bf16 copies bit-equal
# to .to(bf16); its energies (f64 sums of the f32 terms, rounded once)
# within STAGE2_ENERGY_REL relative of torch.sum's f32 sums and of the
# exact (f64) sum; K2 within K2_REL of max|twin| against its plain twin
# (band="bf16x6") on the same band: the same exact bf16 products summed in
# f32 in another order (K1's and K4's bound). K2's band columns on their
# own scale (corner_kernels.band_error: the RMS of the error against the
# f64 product, each element over its sum_h |T||a|) within the three-term
# split's bound SPLIT_REL["bf16x6"], which a two-term band exceeds (held
# at 4K through the plain bf16x3 version). At 4K B=64 the bulk's RMS error
# against the exact sum of the same bf16 products (bulk_error, 24 planes)
# within K2_BULK_RMS: K2 with its f32 promotion sum measured 0.0045, the
# same kernel with the tensor cores summing the whole contraction 0.0926
# and cuBLAS's bf16 products 0.0434 (tools/k2_ablation_torch.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W); the unpromoted sum moved a Rep-7
# group of phase 5c's stego to a wrong bit
STAGE2_GRIDS = K4_GRIDS
# 3e: K6 on 3c's grids: its f32 check mode within K6_REL of max|plain| (f32
# sums of the same exact bf16 products in another order: K1's and K4's
# bound); its bf16 outputs equal to the plain's or one bf16 ulp apart, but
# for elements whose ulp is below that bound (small sums, whose two
# roundings may then lie several ulps apart): those within the bound and
# one ulp
K6_GRIDS = K4_GRIDS
K6_REL = 1e-5
# 3f: K5, the extract's read and decode, on (name, B, H, W, secret bytes):
# the main path's 4K B=64 on phase 4's forward spectrum, then seeded
# spectra with READ_PLANTED's values at the 4K walk (B=1), 1080p (B=5, and
# B=9: a whole chunk of 8 images and a partial one) and 512x512 (B=3,
# B=1); each flag combination of READ_FLAGS (header slots, payload rep,
# hard row, soft row, jitter, sign(sin alpha)) bit-equal to
# read_decode_plain
READ_GRIDS = [("4K", UHD_B, UHD_H, UHD_W, UHD_SECRET),
              ("4K seeded", 1, UHD_H, UHD_W, UHD_SECRET),
              ("1080p", 5, 1080, 1920, 4096), ("1080p", 9, 1080, 1920, 4096),
              ("512", 3, 512, 512, 200), ("512", 1, 512, 512, 200)]
READ_FLAGS = {
    "main": (912, 7, True, "bf16", False, 1.0),
    "hard only": (912, 7, True, None, False, 1.0),
    "no header": (0, 7, True, "bf16", False, 1.0),
    "rs": (912, 1, True, "bf16", False, 1.0),
    "rs retry": (912, 1, False, "f32", False, 1.0),
    "jitter": (912, 7, True, "bf16", True, 1.0),
    "jitter rs retry": (912, 1, False, "f32", True, -1.0),
    "retry": (912, 7, False, "f32", False, 1.0),
    "raw bits": (0, 1, True, None, False, 1.0),
    "ssa -1": (912, 7, True, "bf16", False, -1.0),
    "ssa 0": (912, 7, True, "f32", False, 0.0),
}
# walk slots planted in every image of the seeded grids: a Rep-3 group of
# ties (+0.0, -0.0, +0.0), a group whose copies sum to +0.0 (3.0, -3.0,
# -0.0) and a tiny negative that rounds to -0.0 in bf16 (payload slot 8)
READ_PLANTED = {0: 0.0, 1: -0.0, 2: 0.0, 12: 3.0, 13: -3.0, 14: -0.0,
                920: -1e-42}
STAGE2_ENERGY_REL = 1e-6
K2_REL = 1e-5
K2_BULK_RMS = 0.02
# phases 4 and 4c before K4 (the eager x-stage and K4e), as measured in
# two runs of this script on an NVIDIA H100 80GB HBM3 at 700.00 W: the
# stego's sha256 prefix, peak memory in GiB and the warm round trip in ms,
# printed beside this run's (K4 sums the x-stage in another order, so
# stego bytes may move by one)
RECORDED = {"4K": ("dccab979", 21.488, "111.43-118.14"),
            "4c 4K cropped": ("f9b06c85", 23.009, "155.01-158.69")}
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
    rate, and which of the two it is: the cost model's K1 stage
    (utils/cost.py k1_cost) at the card's data-sheet peaks."""
    from steganosaurus_tpu_torch.utils import cost

    return cost.stage_bound(cost.k1_cost(P, H, W, Kx), cost.peak_rates())


def _k1_key(x, Kx: int, center: bool, prep=None) -> tuple:
    """(planes, H, W, Kx, center, route, prep) of one stage-1 call on
    images x."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    H, W = x.shape[-2:]
    return (x.numel() // (H * W), H, W, Kx, bool(center),
            ck.route_for(W, x.data_ptr()), prep)


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


def _paired(fa, fb, n: int = 16) -> list:
    """[(ms of a, ms of b)] of n pairs of launches back to back, each timed
    by its own CUDA events, every other pair in the order b, a: both sides
    of a pair run at the same clocks, so the card's drift over the smoke
    (power, heat) falls out of their difference."""
    import torch

    fa(), fb()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3 * n)]
    for i in range(n):
        first, second = (fa, fb) if i % 2 == 0 else (fb, fa)
        ev[3 * i].record()
        first()
        ev[3 * i + 1].record()
        second()
        ev[3 * i + 2].record()
    torch.cuda.synchronize()
    out = []
    for i in range(n):
        t1 = ev[3 * i].elapsed_time(ev[3 * i + 1])
        t2 = ev[3 * i + 1].elapsed_time(ev[3 * i + 2])
        out.append((t1, t2) if i % 2 == 0 else (t2, t1))
    return out


def _k1_prep_turns(main, tables, odd, otables, card: str) -> None:
    """Stage 2's prep in K1's epilogue, timed at 4K B=64 on both routes
    (main: 3840 columns, TMA; odd: 3839, the load route) in launches paired
    back to back (_paired): K1 writing the copies and the energies' partials
    with their reduce (mix_adaptive) against K1 followed by the prep pass
    (stage 2's route before the epilogue took the prep over), and against
    K1 alone and K1 writing the copies alone (bf16, mix_split). Logs the
    medians of each side and of the difference."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    def unfused(args, t):
        ar, ai = ck.fwd_stage1(*args, t)
        H = args[0].shape[-2]
        return ck.stage2_prep(ar.reshape(-1, H, ar.shape[-1]),
                              ai.reshape(-1, H, ai.shape[-1]))

    for w, args, t in (("3840", main, tables), ("3839", odd, otables)):
        fused = (lambda a=args, t=t: ck.fwd_stage1(*a, t, "energies"))
        for name, other in (
                ("K1 + prep pass", lambda a=args, t=t: unfused(a, t)),
                ("K1 alone", lambda a=args, t=t: ck.fwd_stage1(*a, t)),
                ("K1 with the copies",
                 lambda a=args, t=t: ck.fwd_stage1(*a, t, "copies"))):
            got = _paired(other, fused)
            n = len(got)
            a = sorted(x for x, _ in got)[n // 2]
            b = sorted(y for _, y in got)[n // 2]
            d = sorted(y - x for x, y in got)
            log(f"K1 prep at {w}, paired ({n} pairs): K1 with the prep "
                f"(its reduce included) {b!r} ms, {name} {a!r} ms: "
                f"difference median {d[n // 2]!r} ms, quartiles "
                f"{d[n // 4]!r} .. {d[3 * n // 4]!r} ({card})")
        torch.cuda.empty_cache()


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
    _k1_prep_turns(main, tabs.stage1, odd, otabs.stage1, card)

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


def _write_inputs(planes, Ky: int, Kx: int, seed: int):
    """K3's inputs for the u8 covers `planes` (B, 3, H, W) on the card:
    their forward corner spectrum (the main path's own, centering off), the
    static maps (corner_statics_core) of a seeded walk over a 16 KB frame's
    919,312 bins, or 30% of a smaller corner's bins, tail-padded as the
    walk is, with per-slot jitter, amplitudes and QIM dithers; seeded
    stream words of the longest equal-length Rep-3/Rep-7 frame the walk
    holds (the 4K headline's 16,438-byte stream at 4K) as a
    write_kernels.RepFrame, and its (B, bucket) u8 frame bits."""
    import numpy as np
    import torch

    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    dev = planes.device
    B, _, H, W = planes.shape
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    cr, ci = corner.fwd_corner(planes, False, Ky, Kx, tabs,
                               corner.precision())
    N = 3 * Ky * Kx
    nbits = min(912 + (UHD_SECRET + 16) * 8 * 7, int(0.3 * N))
    bucket = -(-nbits // 4096) * 4096
    rng = np.random.default_rng(seed)
    flat = rng.choice(N, bucket, replace=False)
    flat[nbits:] = flat[nbits - 1]
    idx = [torch.from_numpy(a).to(dev)
           for a in np.unravel_index(flat, (3, Ky, Kx))]

    def per_slot(lo, hi):
        v = rng.uniform(lo, hi, bucket).astype(np.float32)
        v[nbits:] = v[nbits - 1]
        return torch.from_numpy(v).to(dev)

    maps = pb.corner_statics_core(*idx, Ky, Kx, bucket,
                                  per_slot(-0.39, 0.39),
                                  alphas=per_slot(0.25, 0.75),
                                  dither=per_slot(-math.pi, math.pi))
    stream_bytes = 38 + (nbits - 912) // 56
    words = rng.integers(-2 ** 31, 2 ** 31, (B, -(-stream_bytes // 4)),
                         dtype=np.int64).astype(np.int32)
    rep = wk.RepFrame(torch.from_numpy(words).to(dev), stream_bytes, bucket)
    return cr, ci, maps, rep.bits(), tabs, rep


def _boosting_floor(dr, di, pixels: float) -> float:
    """Twice the largest spatial RMS the writes (dr, di) reach alone,
    sqrt(2/3 * sum |0.5 D / pixels|^2) per image (Parseval, as
    apply_write_floor counts it): a floor that boosts every image."""
    import torch

    rms = [torch.sqrt((((0.5 / pixels) * r) ** 2 + ((0.5 / pixels) * i) ** 2)
                      .sum() * (2.0 / 3.0)).item() for r, i in zip(dr, di)]
    return 2.0 * max(rms)


def _write_case(cr, ci, maps, frame, pixels: float, rule: str, floor: str):
    """(kernel, plain, floor value, entry name, bit reader) of one K3 case:
    kernel() and plain(ordered=False) return (dr, di, b) (write_floor's
    kernel(frame, **kw) takes another frame, e.g. the RepFrame of the same
    bits, and write_kernels._write_floor's ifft_operands, schedule and
    phase_ns; plain(ordered=True) is the ordered twin); bits(dr, di) reads
    each bin's bit after the write (1 iff its decision value >= 0)."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    pos, cjd, sjd, cad, sad, dq, qm = maps
    cj, sj = (cjd, sjd) if "jitter" in rule else (None, None)
    ca, sa = ((cad, sad) if "spread" in rule
              else pb._cos_sin(stt.Params().alpha))
    soft = "soft" in rule
    L = WRITE_QIM_LEVELS
    if rule.startswith("qim"):
        sign, mask = wk.bit_signs(pos, frame)
        dr, di = corner.write_delta_qim(cr, ci, sign, mask, qm, ca, sa, dq,
                                        L, cj, sj, soft=soft)
        del sign, mask
        fl = {"0.45": 0.45, "clip": 1e6}.get(floor) or _boosting_floor(
            dr, di, pixels)

        def kernel():
            return wk.floor_only(dr, di, cr, ci, floor=fl, img_pixels=pixels)

        def plain(ordered=False):
            return wk.floor_only_plain(dr, di, cr, ci, floor=fl,
                                       img_pixels=pixels, ordered=ordered)

        def bits(r, i):
            return corner.read_bits_dense_qim(cr + 0.5 * r, ci + 0.5 * i,
                                              1.0, qm, dq, L, cj, sj)

        return kernel, plain, fl, wk.KERNEL_FLOOR_ONLY, bits
    args = (cr, ci, pos, frame, ca, sa, cj, sj)
    fl = {"0": 0.0, "0.45": 0.45, "clip": 1e6}.get(floor)
    if fl is None:
        fl = _boosting_floor(*wk.write_floor_plain(
            *args, floor=0.0, img_pixels=pixels, soft=soft)[:2], pixels)

    def kernel(frame=frame, **kw):
        return wk._write_floor(cr, ci, pos, frame, ca, sa, cj, sj, floor=fl,
                               img_pixels=pixels, soft=soft, **kw)

    def plain(ordered=False):
        return wk.write_floor_plain(*args, floor=fl, img_pixels=pixels,
                                    soft=soft, ordered=ordered)

    def bits(r, i):
        return corner.read_bits_dense(ci + 0.5 * i, 1.0, cr + 0.5 * r, cj, sj)

    return kernel, plain, fl, wk.KERNEL_WRITE_FLOOR, bits


def _check_write(what: str, out, ref, ordered, walk, bits) -> tuple:
    """K3's (dr, di, b) bit-equal to the ordered twin's (`ordered`: the
    floor's sums in the kernel's order), and against the eager plain
    version's (`ref`, torch.sum): b within WRITE_REL relative, each image
    whose boost is 1 bit-equal, the rest within WRITE_REL of the plain
    output's scale, the same bit read back at every walk bin. Returns
    (max_abs_err, scale, b or None)."""
    import torch

    torch.cuda.synchronize()
    twin = all((o is None and w is None) or (
        o is not None and w is not None and torch.equal(
            o.view(torch.int32), w.view(torch.int32)))
        for o, w in zip(out, ordered))
    log(f"K3 {what}: bit-equal to the ordered twin {twin}")
    if not twin:
        raise AssertionError(f"K3 {what} is not bit-equal to its ordered "
                             f"twin")
    (dr, di, b), (pr, pi, pb) = out, ref
    if (b is None) != (pb is None):
        raise AssertionError(f"K3 {what}: boost {b} against {pb}")
    exact = ([True] * dr.shape[0] if pb is None
             else ((b == 1) & (pb == 1)).tolist())
    b_rel = 0.0 if pb is None else ((b - pb).abs() / pb).max().item()
    err = max((dr - pr).abs().max().item(), (di - pi).abs().max().item())
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    unequal = [k for k, ex in enumerate(exact)
               if ex and not (torch.equal(dr[k], pr[k])
                              and torch.equal(di[k], pi[k]))]
    same_bits = torch.equal(bits(dr, di)[:, walk], bits(pr, pi)[:, walk])
    log(f"K3 {what}: max_abs_err {err!r} max|plain| {scale!r} rel "
        f"{err / scale!r}; b "
        + ("none" if b is None else
           f"{b.min().item()!r}..{b.max().item()!r} (rel err {b_rel!r}, "
           f"{sum(exact)}/{len(exact)} images at b == 1, bit-equal)")
        + f"; walk bits equal {same_bits}")
    if unequal or not (err <= WRITE_REL * scale and b_rel <= WRITE_REL
                       and same_bits):
        raise AssertionError(f"K3 {what} disagrees with its plain version: "
                             f"err {err} (scale {scale}), b rel {b_rel}, "
                             f"images at b == 1 not bit-equal {unequal}, "
                             f"bits equal {same_bits}")
    return err, scale, b


def _check_write_modes(what: str, kernel, f32, resident: bool, rep) -> float:
    """write_floor's other outputs against its f32 output `f32` (from the
    u8 frame bits): the bf16 operand mode bit-equal to f32 cast as the
    inverse DFT casts it, the same boost; the RepFrame `rep` of the same
    bits in both modes (on a resident corner with a floor, where the kernel
    reads the stream words); with a floor on a resident corner, the forced
    two-pass schedule in both modes; all bit-equal. Returns the bf16 mode's
    max |out - cast| (0.0)."""
    import torch

    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    runs = {"bf16": dict(ifft_operands=True),
            "RepFrame f32": dict(frame=rep),
            "RepFrame bf16": dict(frame=rep, ifft_operands=True)}
    if resident:
        runs["two-pass f32"] = dict(schedule="two_pass")
        runs["two-pass bf16"] = dict(schedule="two_pass", ifft_operands=True)
    want16 = wk.ifft_operands_of(f32[0], f32[1])
    err = 0.0
    for name, kw in runs.items():
        out = kernel(**kw)
        torch.cuda.synchronize()
        want = want16 if kw.get("ifft_operands") else f32[:2]
        same = all(o.dtype == w.dtype and torch.equal(
            o.view(torch.int16) if o.dtype == torch.bfloat16
            else o.view(torch.int32),
            w.view(torch.int16) if w.dtype == torch.bfloat16
            else w.view(torch.int32)) for o, w in zip(out[:2], want))
        same_b = (out[2] is None and f32[2] is None) or torch.equal(out[2],
                                                                   f32[2])
        if name == "bf16":
            err = max((o.float() - w.float()).abs().max().item()
                      for o, w in zip(out[:2], want))
        ref = ("the f32 output cast" if kw.get("ifft_operands")
               else "the resident f32 output")
        log(f"K3 {what}: {name} bit-equal to {ref} {same}, boost equal "
            f"{same_b}")
        if not (same and same_b):
            raise AssertionError(f"K3 {what}: the {name} output differs")
        del out
    return err


# 3b's kernels line: each entry point's source and the JAX math it replaces
WRITE_SOURCES = {
    "corner_write_floor": (
        "corner_write_floor.cu", "steganosaurus_tpu/spectral/corner.py:550 "
        "write_delta + :612 apply_write_floor, with the bit lookup of "
        "steganosaurus_tpu/parallel/batch.py:594 (corner_embed_core)"),
    "corner_floor_only": (
        "corner_write_floor.cu", "steganosaurus_tpu/spectral/corner.py:612 "
        "apply_write_floor (after write_delta_qim in corner_embed_core, and "
        "in corner_piw_embed_core)"),
    "corner_epilogue": (
        "corner_epilogue.cu", "steganosaurus_tpu/parallel/batch.py:622-627 "
        "(corner_embed_core's epilogue), with the 1/(H*W) scale of "
        "steganosaurus_tpu/spectral/corner.py:547 (ifft_corner_real)"),
}


def _time_entries(rows: dict, card: str) -> list:
    """The rows ({label: what, err, run (kernel, plain or None), bound (ms,
    bound_by), entry (its name in the kernels line) or None}) timed in
    turns with each other by CUDA events, each kernel 10 launches a round,
    each plain version 3; returns the kernels line's records (the rows with
    an entry) and each row's mean kernel ms."""
    runs = {}
    for label, row in rows.items():
        kern, plain = row["run"]
        runs[label] = (kern, 10)
        if plain is not None:
            runs[f"{label} plain"] = (plain, 3)
    times = _turns(runs)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    records = []
    for label, row in rows.items():
        bound, by = row["bound"]
        plain_ms = ms.get(f"{label} plain")
        log(f"{row['what']} timed in turns: kernel {times[label]!r} ms"
            + ("" if plain_ms is None else
               f", plain {times[label + ' plain']!r} ms")
            + f"; bound {bound!r} ms ({by}), at {bound / ms[label]:.3f} of it"
            + ("" if plain_ms is None else
               f"; {plain_ms / ms[label]:.2f}x faster than the plain version")
            + f" ({card})")
        if row["entry"] is None:
            continue
        source, replaces = WRITE_SOURCES[row["entry"]]
        records.append({
            "name": row["entry"], "route": "cuda",
            "source": f"steganosaurus_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": row["err"],
            "ms": ms[label], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    return records, {label: ms[label] for label in rows}


def _resident_phases(kernel, k_ms: float, grid: int, dev) -> None:
    """Where the resident schedule's time goes, by each block's thread 0
    (globaltimer), summed over the images: write_kernels.PHASES, the grid
    barrier from arrival to the last block's."""
    import torch

    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    ns = torch.zeros((grid, len(wk.PHASES)), dtype=torch.int64, device=dev)
    kernel(ifft_operands=True, phase_ns=ns)
    torch.cuda.synchronize()
    ms = ns.double() / 1e6
    parts = "; ".join(
        f"{what} {ms[:, k].mean().item()!r} ms a block (max "
        f"{ms[:, k].max().item()!r}, {ms[:, k].mean().item() / k_ms:.3f})"
        for k, what in enumerate(wk.PHASES))
    log(f"K3 write_floor resident schedule, {grid} blocks, against the "
        f"kernel's {k_ms!r} ms: {parts}")


def phase_write_kernels(covers_d, odd_d, card: str) -> list:
    """3b: K3 (both entry points) and K4e against their plain versions, on
    the WRITE_GRIDS with the WRITE_CASES (every write rule at the main
    path's grid; floor 0, 0.45, boosting and clipping at 32); write_floor's
    bf16 operand mode and its two-pass schedule against its f32 output
    (_check_write_modes); K4e on the inverse DFT of K3's output, centering
    on and off, NCHW and NHWC. At the main path's grid, in turns: write_floor
    on the main path's hard write at floor 0.45 in the bf16 operand mode
    (the kernels line's entry), in f32, and on the forced two-pass schedule
    in bf16; floor_only on the first QIM case; K4e NCHW uncentered; each
    beside its bound in utils/cost.py; then where the resident schedule's
    time goes (_resident_phases). Returns the three entries of the kernels
    line."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk
    from steganosaurus_tpu_torch.utils import cost

    peaks = cost.peak_rates(covers_d.device)
    records = []
    for g, (name, B, H, W) in enumerate(WRITE_GRIDS):
        main = name == "4K"
        planes = (covers_d if main else odd_d if name == "4c"
                  else _grid_nchw(covers_d.device, B, H, W))
        Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
        cr, ci, maps, frame, tabs, rep = _write_inputs(planes, Ky, Kx,
                                                       30 + g)
        walk = maps[0] < frame.shape[1]
        pixels = float(H) * float(W)
        N = 3 * Ky * Kx
        grid = wk._resident_grid(N, True, cr.device)
        fits = wk.resident_fits(N, grid, (cr, ci))
        log(f"K3 {name} B={B}: corner ({Ky}, {Kx}), "
            + (f"resident schedule, {grid} blocks" if fits
               else "two-pass schedule"))
        if fits == (name in WRITE_TWO_PASS_GRIDS):
            raise AssertionError(f"K3 {name}: the schedule is not the one "
                                 f"this corner should take")
        rows: dict = {}
        t_in = None
        for rule, floor in (WRITE_CASES if main
                            else WRITE_CASES[:WRITE_CASES_SMALL]):
            kernel, plain, fl, entry, bits = _write_case(
                cr, ci, maps, frame, pixels, rule, floor)
            what = (f"{entry} {name} B={B} {H}x{W} {rule}, floor {floor} "
                    f"({fl!r})")
            two_pass = wk.LAUNCHES[wk.KERNEL_WRITE_FLOOR_TWO_PASS]
            out = kernel()
            two_pass = wk.LAUNCHES[wk.KERNEL_WRITE_FLOOR_TWO_PASS] - two_pass
            err, _, b = _check_write(what, out, plain(),
                                     plain(ordered=True), walk, bits)
            if floor == "boost" and not (b > 1).all().item():
                raise AssertionError(f"K3 {what}: an image was not boosted")
            if floor == "clip" and not (b == 32).all().item():
                raise AssertionError(f"K3 {what}: a boost is not clipped "
                                     f"at 32")
            if entry == wk.KERNEL_WRITE_FLOOR:
                if two_pass != int(bool(fl) and not fits):
                    raise AssertionError(f"K3 {what}: {two_pass} two-pass "
                                         f"launches")
                err16 = _check_write_modes(what, kernel, out,
                                           fits and bool(fl), rep)
            if main and not (entry in rows or "write_floor bf16" in rows
                             and entry == wk.KERNEL_WRITE_FLOOR):
                if entry == wk.KERNEL_WRITE_FLOOR:
                    def bound(n, stream_bytes=0):
                        return cost.stage_bound(cost.write_floor_cost(
                            B, Ky, Kx, frame.shape[1], 0, out_bytes=n,
                            stream_bytes=stream_bytes), peaks)
                    # the main path's call: a RepFrame, bf16 operands
                    rows["write_floor bf16"] = dict(
                        what=f"{what} RepFrame, bf16 operands", err=err16,
                        entry=entry, bound=bound(2, rep.stream_bytes), run=(
                            lambda k=kernel: k(rep, ifft_operands=True),
                            lambda p=plain: wk.ifft_operands_of(*p()[:2])))
                    rows["write_floor f32"] = dict(
                        what=f"{what} RepFrame, f32", err=err, entry=None,
                        bound=bound(4, rep.stream_bytes),
                        run=(lambda k=kernel: k(rep), None))
                    rows["write_floor u8 frame bf16"] = dict(
                        what=f"{what} u8 frame bits, bf16 operands",
                        err=err16, entry=None, bound=bound(2),
                        run=(lambda k=kernel: k(ifft_operands=True), None))
                    rows["write_floor two-pass bf16"] = dict(
                        what=f"{what} two-pass schedule, bf16 operands",
                        err=err16, entry=None, bound=bound(2), run=(
                            lambda k=kernel: k(ifft_operands=True,
                                               schedule="two_pass"), None))
                    barrier = functools.partial(kernel, rep)
                else:
                    rows[entry] = dict(
                        what=what, err=err, entry=entry, run=(kernel, plain),
                        bound=cost.stage_bound(
                            cost.floor_only_cost(B, Ky, Kx), peaks))
            if t_in is None:  # K4e's input: the first case's inverse DFT
                t_in = corner.ifft_corner_real(out[0], out[1], H, W, tabs,
                                               corner.precision(),
                                               scale=False)
            del out
        layouts = ((False, "nchw"), (True, "nhwc"), (True, "nchw"),
                   (False, "nhwc"))
        for center, layout in layouts if main else layouts[:2]:
            got = wk.epilogue(t_in, planes, center, layout)
            want = wk.epilogue_plain(t_in, planes, center, layout)
            torch.cuda.synchronize()
            n_diff = (got != want).sum().item()
            log(f"K4e {name} B={B} {H}x{W} center {center} {layout}: "
                f"{tuple(got.shape)} u8, {n_diff} bytes differ from the "
                f"plain version")
            if n_diff or got.shape != want.shape:
                raise AssertionError(f"K4e {name} center {center} {layout} "
                                     f"is not bit-equal to its plain "
                                     f"version")
            del got, want
        if main:
            rows[wk.KERNEL_EPILOGUE] = dict(
                what=f"{wk.KERNEL_EPILOGUE} {name} B={B} {H}x{W} nchw",
                err=0.0, entry=wk.KERNEL_EPILOGUE, run=(
                    lambda: wk.epilogue(t_in, planes, False, "nchw"),
                    lambda: wk.epilogue_plain(t_in, planes, False, "nchw")),
                bound=cost.stage_bound(cost.epilogue_cost(B, H, W), peaks))
            records, ms = _time_entries(rows, card)
            _resident_phases(barrier, ms["write_floor bf16"], grid,
                           cr.device)
            del barrier
        del cr, ci, maps, frame, rep, t_in, rows, planes
        torch.cuda.empty_cache()
    return records


def _k4_check(what: str, mr16, mi16, tabs, planes, center: bool,
              layout: str) -> float:
    """K4 against its plain version on one input: the f32 check mode within
    K4_REL of the plain values' scale, and the u8 stego equal but for
    bytes one apart, each where the plain value lies within that bound of a
    .5 boundary (the sum order moved it across). Returns max |v - plain|."""
    import torch

    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    args = (mr16, mi16, tabs, planes, center, layout)
    v = wk.ifft_epilogue(*args, values=True)
    pv = wk.ifft_epilogue_plain(*args, values=True)
    torch.cuda.synchronize()
    err = (v - pv).abs().max().item()
    scale = pv.abs().max().item()
    del v
    got = wk.ifft_epilogue(*args)
    want = wk.ifft_epilogue_plain(*args)
    torch.cuda.synchronize()
    diff = got.to(torch.int16) - want.to(torch.int16)
    del got, want
    off = diff != 0
    if layout != "nchw":
        off = off.permute(0, 3, 1, 2)
    n_off = int(off.sum().item())
    near = 0.0
    if n_off:
        y = pv[off].double() + planes[off].double() + 0.5
        near = (y - y.round()).abs().max().item()
    tol = K4_REL * scale
    log(f"K4 {what} center {center} {layout}: max |v - plain| {err!r} "
        f"(bound {tol!r}, {err / scale:.3e} of max |plain| {scale!r}); "
        f"{n_off} of {diff.numel()} u8 bytes off, max |diff| "
        f"{int(diff.abs().max().item())}, each within {near!r} of a .5 "
        f"boundary")
    if err > tol or diff.abs().max().item() > 1 or near > tol:
        raise AssertionError(f"K4 {what} center {center} {layout} disagrees "
                             f"with its plain version")
    return err


def _shifted(t):
    """A copy of t one element into a larger tensor: its base off the 16
    bytes TMA wants (operands) and the 4 bytes of the vector loads
    (covers)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def phase_ifft_epilogue(covers_d, odd_d, card: str) -> list:
    """3c: K4 (csrc/corner_ifft_epilogue.cu) against its plain version on
    the main path's inputs: each of K4_GRIDS' forward corner spectra through
    K3's write_floor as the main path calls it (the hard write at floor
    0.45 of a RepFrame, bf16 operands), then the y-stage
    (corner.ifft_corner_y); centering on and off, NCHW and NHWC
    (_k4_check); HGMMA and UTMALDG in the SASS of the NCHW and NHWC
    kernels, and UTMASTG (the store warp's TMA stores) in the NCHW ones. At 4K B=64 and at 4c's 2160x3839, in turns by CUDA events
    beside the bound (utils/cost.py ifft_epilogue_cost): K4 NCHW (the
    kernels line's entry) and NHWC, the plain version, the library
    composition it replaced (the two cuBLAS x-stage products, t -=, K4e)
    and one torch.mm of [mr, mi] with [exr; -exi] (the kernels line's
    library_ms: no one PyTorch call computes the epilogue too). Returns
    the kernels line's entry."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk
    from steganosaurus_tpu_torch.utils import cost

    from steganosaurus_tpu_torch import _build

    for fn in ("corner_ifft_nchw_kernel", "corner_ifft_nhwc_kernel"):
        sass = _build.sass_counts(wk.KERNEL_IFFT_EPILOGUE, fn,
                                  ("HGMMA", "UTMALDG", "UTMASTG", "LDL",
                                   "STL"))
        log(f"K4 SASS ({fn}, cuobjdump -sass): {sass}")
        # the NCHW tiles' stego goes out by the store warp's TMA stores
        if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                and (sass["UTMASTG"] > 0 or "nhwc" in fn)):
            raise AssertionError(f"K4 {fn} is not wgmma + TMA: {sass}")
    peaks = cost.peak_rates(covers_d.device)
    errs, record = [], None
    for g, (name, B, H, W) in enumerate(K4_GRIDS):
        main = name == "4K"
        planes = (covers_d if main else odd_d if name == "4c"
                  else _grid_nchw(covers_d.device, B, H, W))
        Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
        cr, ci, maps, _, tabs, rep = _write_inputs(planes, Ky, Kx, 60 + g)
        dr, di, _ = wk.write_floor(cr, ci, maps[0], rep,
                                   *pb._cos_sin(stt.Params().alpha),
                                   floor=stt.Params().write_floor,
                                   img_pixels=float(H) * float(W),
                                   ifft_operands=True)
        del cr, ci, maps, rep
        mr16, mi16 = corner.ifft_corner_y(dr, di, tabs, conjugated=True)
        del dr, di
        if "unaligned" in name:
            mr16, mi16, planes = (_shifted(t) for t in (mr16, mi16, planes))
        for center, layout in ((False, "nchw"), (True, "nchw"),
                               (False, "nhwc"), (True, "nhwc")):
            errs.append(_k4_check(f"{name} B={B} {H}x{W}", mr16, mi16, tabs,
                                  planes, center, layout))
        if main or name == "4c":
            P = 3 * B
            a_cat = torch.cat([mr16, mi16], dim=1)
            b_cat = torch.cat([tabs.exr16, -tabs.exi16], dim=0)

            def composition():
                t = corner._mm_bf16(mr16.reshape(P, H, Kx), tabs.exr16)
                t -= corner._mm_bf16(mi16.reshape(P, H, Kx), tabs.exi16)
                return wk.epilogue(t.reshape(B, 3, H, W), planes, False,
                                   "nchw")

            runs = {
                "K4": (lambda: wk.ifft_epilogue(mr16, mi16, tabs, planes,
                                                False, "nchw"), 10),
                "K4 nhwc": (lambda: wk.ifft_epilogue(mr16, mi16, tabs, planes,
                                                     False, "nhwc"), 10),
                "plain": (lambda: wk.ifft_epilogue_plain(
                    mr16, mi16, tabs, planes, False, "nchw"), 3),
                "composition": (composition, 3),
                "torch.mm": (lambda: torch.mm(a_cat, b_cat,
                                              out_dtype=torch.float32), 3)}
            times = _turns(runs)
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            bound, by = cost.stage_bound(
                cost.ifft_epilogue_cost(B, H, W, Kx), peaks)
            log(f"K4 {name} B={B} {H}x{W} Kx={Kx} timed in turns ({card}): "
                + "; ".join(f"{k} {v!r} ms" for k, v in times.items())
                + f"; bound {bound!r} ms ({by}), K4 at "
                f"{bound / ms['K4']:.3f} of it, {ms['composition'] / ms['K4']:.2f}x "
                f"faster than the library composition, "
                f"{ms['plain'] / ms['K4']:.2f}x than the plain version")
            if main:
                log(f"K4 {name} B={B} {H}x{W}: 2-CTA clusters, grid "
                    f"{wk.ifft_epilogue_grid(B, H, W, 'nchw')} blocks")
                record = {
                    "name": wk.KERNEL_IFFT_EPILOGUE, "route": "cuda",
                    "source": "steganosaurus_tpu_torch/csrc/"
                              "corner_ifft_epilogue.cu",
                    "replaces": "steganosaurus_tpu/spectral/corner.py:545-547 "
                                "(ifft_corner_real's x-stage) + "
                                "steganosaurus_tpu/parallel/batch.py:622-627 "
                                "(corner_embed_core's epilogue)",
                    "ms": ms["K4"], "plain_ms": ms["plain"],
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": ms["torch.mm"]}
            del a_cat, b_cat, runs
        del mr16, mi16, tabs, planes
        torch.cuda.empty_cache()
    record["max_abs_err"] = max(errs)
    return [record]


def _k6_check(what: str, dcr, dci, tabs, padded: bool,
              main: bool = False) -> float:
    """K6 against its plain version on one grid's operands (dcr, dci): the
    f32 check mode within K6_REL of max|plain|; the bf16 outputs the
    round-to-nearest-even casts of its own sums; against the plain bf16,
    each element equal, one ulp apart, or, where an ulp is below that f32
    bound, within the bound and one ulp (write_kernels.bf16_compare, the
    counts printed); each launch through the
    staging copy where `padded`. main (4K B=64): also the RMS error of K6's
    f32 sums and of the plain chain's against the exact sum of the same
    bf16 products (write_kernels.ifft_y_error, 24 planes). Returns max
    |v - plain|."""
    import torch

    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    n_pad = wk.LAUNCHES[wk.KERNEL_IFFT_Y_PADDED]
    v = wk.ifft_y(dcr, dci, tabs, values=True)
    pv = wk.ifft_y_plain(dcr, dci, tabs, values=True)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(v, pv))
    scale = max(b.abs().max().item() for b in pv)
    tol = K6_REL * scale
    finite = all(bool(torch.isfinite(a).all()) for a in v)
    more = ""
    if main:
        rms = wk.ifft_y_error(*v, dcr, dci, tabs)
        rms_plain = wk.ifft_y_error(*pv, dcr, dci, tabs)
        more = (f"; RMS error against the exact sum of the same bf16 "
                f"products (24 planes): K6 {rms!r}, the plain chain "
                f"{rms_plain!r}")
    got = wk.ifft_y(dcr, dci, tabs)
    want = wk.ifft_y_plain(dcr, dci, tabs)
    torch.cuda.synchronize()
    own = all(torch.equal(g, a.to(torch.bfloat16)) for g, a in zip(got, v))
    del v
    n: dict = {}
    for g, w, b in zip(got, want, pv):
        for k, c in wk.bf16_compare(g, w, b, tol).items():
            n[k] = n.get(k, 0) + c
    del got, want, pv
    staged = wk.LAUNCHES[wk.KERNEL_IFFT_Y_PADDED] - n_pad
    log(f"K6 {what}: max |v - plain| {err!r} (bound {tol!r}, "
        f"{err / scale:.3e} of max |plain| {scale!r}), finite {finite}; bf16 "
        f"outputs the casts of its own sums {own}; against the plain bf16 "
        f"{n}; staging copies {staged}" + more)
    if not (err <= tol and finite and own and n["other"] == 0
            and staged == (2 if padded else 0)):
        raise AssertionError(f"K6 {what} disagrees with its plain version")
    return err


def phase_ifft_y(covers_d, odd_d, card: str) -> list:
    """3e: K6 (csrc/corner_ifft_y.cu) against its plain version on the
    main path's operands: each of K6_GRIDS' forward corner spectra through
    K3's write_floor as the main path calls it (the hard write at floor
    0.45 of a RepFrame, bf16 operands), the 512x512 views one element off
    their alignment (_k6_check); HGMMA and UTMALDG in its SASS (UTMASTG,
    the store warp's TMA stores, printed). At 4K B=64 the grid launched
    (no cluster), and in turns by CUDA events beside the bound
    (utils/cost.py ifft_y_cost):
    K6, its plain version (the eager chain it replaced) and one torch.bmm
    of the real table (corner.ifft_y_table without its padding, expanded)
    with the stacked (P, 2Ky, Kx) operands into bf16 (the kernels line's
    library_ms; the stacking not timed). Returns the kernels line's
    entry."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk
    from steganosaurus_tpu_torch.utils import cost

    sass = _build.sass_counts(
        wk.KERNEL_IFFT_Y, "corner_ifft_y_kernel",
        ("HGMMA", "UTMALDG", "UTMASTG", "LDL", "STL"))
    log(f"K6 SASS (corner_ifft_y_kernel, both instantiations, cuobjdump "
        f"-sass): {sass}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"K6 is not wgmma + TMA: {sass}")
    peaks = cost.peak_rates(covers_d.device)
    errs, record = [], None
    for g, (name, B, H, W) in enumerate(K6_GRIDS):
        main = name == "4K"
        planes = (covers_d if main else odd_d if name == "4c"
                  else _grid_nchw(covers_d.device, B, H, W))
        Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
        cr, ci, maps, _, tabs, rep = _write_inputs(planes, Ky, Kx, 70 + g)
        dcr, dci, _ = wk.write_floor(cr, ci, maps[0], rep,
                                     *pb._cos_sin(stt.Params().alpha),
                                     floor=stt.Params().write_floor,
                                     img_pixels=float(H) * float(W),
                                     ifft_operands=True)
        del cr, ci, maps, rep, planes
        shift = "unaligned" in name
        if shift:
            dcr, dci = _shifted(dcr), _shifted(dci)
        errs.append(_k6_check(f"{name} B={B} {H}x{W} Ky={Ky} Kx={Kx}"
                              + (", unaligned" if shift else ""), dcr, dci,
                              tabs, padded=shift or Kx % 8 != 0, main=main))
        if main:
            P = 3 * B
            Hp, Kyp = tabs.ifft_y.shape[0] // 2, tabs.ifft_y.shape[1] // 2
            rows = torch.cat((tabs.ifft_y[:H], tabs.ifft_y[Hp:Hp + H]))
            a_lib = torch.cat((rows[:, :Ky], rows[:, Kyp:Kyp + Ky]), 1)
            b_lib = torch.cat((dcr.reshape(P, Ky, Kx),
                               dci.reshape(P, Ky, Kx)), 1)
            del rows

            def library():
                return torch.bmm(a_lib.expand(P, *a_lib.shape), b_lib)

            lib = library().reshape(P, 2, H, Kx)
            plain = wk.ifft_y_plain(dcr, dci, tabs)
            pv = wk.ifft_y_plain(dcr, dci, tabs, values=True)
            tol = K6_REL * max(v.abs().max().item() for v in pv)
            lib_cmp: dict = {}
            for i in range(2):
                for k, c in wk.bf16_compare(lib[:, i].reshape(P * H, Kx),
                                            plain[i], pv[i], tol).items():
                    lib_cmp[k] = lib_cmp.get(k, 0) + c
            del lib, plain, pv
            runs = {"K6": (lambda: wk.ifft_y(dcr, dci, tabs), 10),
                    "plain": (lambda: wk.ifft_y_plain(dcr, dci, tabs), 3),
                    "torch.bmm": (library, 3)}
            times = _turns(runs)
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            bound, by = cost.stage_bound(cost.ifft_y_cost(B, H, Ky, Kx),
                                         peaks)
            # csrc/corner_ifft_y.cu's grid: a block per SM, at most one
            # per 128 x 256 tile of the (2Hp, Kx) outputs
            tiles = P * (2 * Hp // 128) * -(-Kx // 256)
            sms = torch.cuda.get_device_properties(
                covers_d.device).multi_processor_count
            log(f"K6 {name} B={B} {H}x{W} Ky={Ky} Kx={Kx}: no cluster, "
                f"grid {min(sms, tiles)} blocks")
            log(f"K6 {name} B={B} {H}x{W} Ky={Ky} Kx={Kx} timed in turns "
                f"({card}): " + "; ".join(f"{k} {v!r} ms"
                                          for k, v in times.items())
                + f"; bound {bound!r} ms ({by}), K6 at "
                f"{bound / ms['K6']:.3f} of it, torch.bmm at "
                f"{bound / ms['torch.bmm']:.3f}; K6 "
                f"{ms['plain'] / ms['K6']:.2f}x faster than the plain "
                f"chain, {ms['torch.bmm'] / ms['K6']:.2f}x the library call "
                f"(its bf16 output against the plain chain's, as K6's is "
                f"held: {lib_cmp})")
            record = {
                "name": wk.KERNEL_IFFT_Y, "route": "cuda",
                "source": "steganosaurus_tpu_torch/csrc/corner_ifft_y.cu",
                "replaces": "steganosaurus_tpu/spectral/corner.py:532-539 "
                            "(ifft_corner_real's y-stage: four dots, their "
                            "difference and sum)",
                "ms": ms["K6"], "plain_ms": ms["plain"], "bound_ms": bound,
                "bound_by": by, "library_ms": ms["torch.bmm"]}
            del a_lib, b_lib, runs
        del dcr, dci, tabs
        torch.cuda.empty_cache()
    record["max_abs_err"] = max(errs)
    return [record]


def _read_walk(dev, H: int, W: int, secret: int) -> tuple:
    """The shared walk of a default-Params frame of `secret` bytes at
    H x W under MASTER_KEY (phase 4's at 4K): plane, y, x (bucket,) int64
    on the card, the jitter angles of the same walk at jitter 0.2, Ky, Kx
    and the frame's slots before its tail padding. The pipeline's cache of
    device walks is left as it was found, so the walks held here do not
    count in a later phase's peak memory."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.pipeline import batch as tbatch
    from steganosaurus_tpu_torch.spectral import corner

    PH, PW = spectral.fft_dims(H, W)
    Ky, Kx = corner.corner_dims(PH, PW, stt.Params().rmax)
    total = 912 + tbatch._payload_stream_bits(secret + 16, False)
    bucket = tbatch._bucket(total)
    cached = set(tbatch._DEV_IDX_CACHE)
    (pl, yy, xx, _), nprod = tbatch._walk_indices_device(
        None, MASTER_KEY, stt.Params(), PH, PW, total, 0, bucket, dev)
    if nprod < total:
        raise AssertionError(f"3f: the {H}x{W} walk ends after {nprod} of "
                             f"{total} slots")
    (_, _, _, jj), _ = tbatch._walk_indices_device(
        None, MASTER_KEY, stt.Params(jitter=0.2), PH, PW, total, 0, bucket,
        dev)
    for key in set(tbatch._DEV_IDX_CACHE) - cached:
        del tbatch._DEV_IDX_CACHE[key]
    return pl, yy, xx, jj, Ky, Kx, total


def _read_check(what: str, ci, cr, walk, plan) -> int:
    """K5 against read_decode_plain on one spectrum and walk for every
    READ_FLAGS combination, through the walk's read plan `plan`: every word
    equal (raises on any difference), one launch each. Returns the words
    compared."""
    import torch

    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    pl, yy, xx, jj = walk
    words = 0
    for name, (hdr, rep, hard, soft, jitter, ssa) in READ_FLAGS.items():
        extra = ((cr, torch.cos(jj), torch.sin(jj)) if jitter
                 else (None, None, None))
        kw = dict(hdr_stream_bits=hdr, payload_rep=rep, hard=hard,
                  soft=soft)
        n = rk.LAUNCHES[rk.KERNEL_READ_DECODE]
        got = rk.read_decode(ci, pl, yy, xx, ssa, *extra, plan=plan, **kw)
        torch.cuda.synchronize()
        if rk.LAUNCHES[rk.KERNEL_READ_DECODE] != n + 1:
            raise AssertionError(f"3f {what} {name}: K5 was not launched "
                                 f"once")
        want = rk.read_decode_plain(ci, pl, yy, xx, ssa, *extra, **kw)
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"3f {what} {name}: rows {g} vs {w}")
            if w is None:
                continue
            if g.shape != w.shape or not torch.equal(g, w):
                bad = int((g != w).sum()) if g.shape == w.shape else -1
                raise AssertionError(f"3f {what} {name}: K5 differs from "
                                     f"its plain version in {bad} words "
                                     f"of {tuple(w.shape)}")
            words += w.numel()
    return words


def phase_read_decode(covers_d, card: str) -> list:
    """3f: K5 (csrc/corner_read_decode.cu) against its plain version on
    READ_GRIDS, every READ_FLAGS combination bit-equal; at 4K B=64 (phase
    4's covers, their forward corner spectrum as the extract computes it,
    phase 4's walk and its read plan) the walk's touched sectors beside a
    uniform walk's share, then in turns by CUDA events beside the bound
    (read_decode_cost over this walk's sectors and its plan's bytes): K5 as
    the fused pass calls it (hard and bf16 soft rows), its plain version,
    the eager chain it replaced (the gather, the decision values,
    _decode_sections and _decode_sections_soft) and the lone gather ci[:,
    plane, y, x]; at 4K B=1 (the first image) K5, its plain version and
    the lone gather. Returns the kernels line's entry, at 4K B=64
    (library_ms null: no one PyTorch call computes this function)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import read_kernels as rk
    from steganosaurus_tpu_torch.utils import cost

    dev = covers_d.device
    peaks = cost.peak_rates(dev)
    record, words = None, 0
    for g, (name, B, H, W, secret) in enumerate(READ_GRIDS):
        pl, yy, xx, jj, Ky, Kx, total = _read_walk(dev, H, W, secret)
        plan = rk.read_plan(pl, yy, xx, Ky, Kx)
        if name == "4K":
            tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
            cr, ci = corner.fwd_corner(covers_d, stt.Params().center, Ky,
                                       Kx, tabs, corner.precision())
            del tabs
        else:
            gen = torch.Generator(device=dev).manual_seed(80 + g)
            cr, ci = (torch.randn((B, 3, Ky, Kx), generator=gen,
                                  device=dev) * 1e3 for _ in range(2))
            for s, v in READ_PLANTED.items():
                ci[:, pl[s], yy[s], xx[s]] = v
        words += _read_check(f"{name} B={B} {H}x{W}", ci, cr,
                             (pl, yy, xx, jj), plan)
        log(f"3f K5 {name} B={B} {H}x{W} Ky={Ky} Kx={Kx}, "
            f"{pl.shape[0]}-slot walk, {plan.rows.shape[0]} plan rows: "
            f"{len(READ_FLAGS)} flag combinations bit-equal to the plain "
            f"version")
        if name != "4K":
            del cr, ci
            continue
        n = pl.shape[0]
        sectors = cost.walk_sectors(pl, yy, xx, Ky, Kx)
        share = sectors / (3 * Ky * Kx / 8)
        uniform = cost.sector_share(n, Ky, Kx)
        log(f"3f K5 4K walk: {total} distinct slots of {n} touch {sectors} "
            f"of {3 * Ky * Kx // 8} 32-byte sectors of a plane ({share!r}); "
            f"a uniform walk of {n} bins: {uniform!r} "
            f"({share / uniform:.4f}x)")
        del cr
        ssa = pb._sign_sin(stt.Params().alpha)
        kw = dict(hdr_stream_bits=912, payload_rep=7, soft="bf16")

        def eager():
            d = corner.decision_values(ci[:, pl, yy, xx], ssa)
            return (pb._decode_sections((d >= 0).to(torch.uint8), 912),
                    pb._decode_sections_soft(
                        d.to(torch.bfloat16).to(torch.float32), 912))

        if not all(torch.equal(a, b) for a, b in zip(
                eager(), rk.read_decode(ci, pl, yy, xx, ssa, plan=plan,
                                        **kw))):
            raise AssertionError("3f: K5 differs from the eager chain at "
                                 "4K B=64 (soft sums in another order: a "
                                 "sum within rounding of zero?)")

        def k5(spec):
            return lambda: rk.read_decode(spec, pl, yy, xx, ssa, plan=plan,
                                          **kw)

        one = ci[:1]
        runs = {"K5": (k5(ci), 10),
                "plain": (lambda: rk.read_decode_plain(ci, pl, yy, xx, ssa,
                                                       **kw), 3),
                "eager chain": (eager, 3),
                "gather": (lambda: ci[:, pl, yy, xx], 10),
                "B=1 K5": (k5(one), 20),
                "B=1 plain": (lambda: rk.read_decode_plain(
                    one, pl, yy, xx, ssa, **kw), 5),
                "B=1 gather": (lambda: one[:, pl, yy, xx], 20)}
        times = _turns(runs, rounds=3)
        ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        hw, pw, _ = rk.row_words(n, 912, 7)
        bound, by = cost.stage_bound(cost.read_decode_cost(
            B, Ky, Kx, n, 2 * (hw + pw), sectors=sectors,
            plan_bytes=plan.nbytes), peaks)
        bound1, _ = cost.stage_bound(cost.read_decode_cost(
            1, Ky, Kx, n, 2 * (hw + pw), sectors=sectors,
            plan_bytes=plan.nbytes), peaks)
        log(f"3f K5 4K timed in turns, medians of 3 ({card}): "
            + "; ".join(f"{k} {v!r} ms" for k, v in times.items())
            + f"; B={B}: bound {bound!r} ms ({by}, this walk's sectors), K5 "
            f"at {bound / ms['K5']:.3f} of it; "
            f"{ms['plain'] / ms['K5']:.2f}x faster than the plain version, "
            f"{ms['eager chain'] / ms['K5']:.2f}x than the eager chain, "
            f"{ms['gather'] / ms['K5']:.2f}x the lone gather; the plan "
            f"{plan.nbytes} bytes; B=1: bound {bound1!r} ms, K5 at "
            f"{bound1 / ms['B=1 K5']:.3f} of it")
        if ms["K5"] >= ms["gather"]:
            raise AssertionError(f"3f: K5 ({ms['K5']!r} ms) is not faster "
                                 f"than the lone gather it replaces "
                                 f"({ms['gather']!r} ms)")
        record = {
            "name": rk.KERNEL_READ_DECODE, "route": "cuda",
            "source": "steganosaurus_tpu_torch/csrc/corner_read_decode.cu",
            "replaces": "steganosaurus_tpu/parallel/batch.py:738 "
                        "(corner_extract_fused_core's read at the walk "
                        "bins and _decode_sections[_soft] :238-260, fused "
                        "by XLA; no Pallas kernel)",
            "ms": ms["K5"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": None}
        del ci, one, runs
        torch.cuda.empty_cache()
    log(f"3f K5: {words} words compared, all equal")
    record["max_abs_err"] = 0.0
    return [record]


def _stage2_check(what: str, ar, ai, tabs, shift: bool = False,
                  main: bool = False) -> tuple:
    """The prep and K2 against their plain versions on one grid's stage-1
    output (ar, ai): the prep's bf16 copies bit-equal, its energies within
    STAGE2_ENERGY_REL of torch.sum's and of the exact sum, the band sets
    beside band_columns' (differences counted); K2 within K2_REL of
    max|twin| against fwd_stage2_plain(band="bf16x6") on the prep's band,
    its band columns within SPLIT_REL["bf16x6"] on their own scale
    (band_error). main (4K B=64): also the plain bf16x3 band beyond that
    bound, and K2's bulk within K2_BULK_RMS of the exact sum of its bf16
    products (bulk_error; cuBLAS's bf16 products printed beside it).
    shift: ar, ai and the bf16 copies one element off their alignment (the
    prep's scalar path, K2's padded copy). Returns (max |K2 - twin|, max
    |energy - plain energy|, the prep's output, the band)."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    if shift:
        ar, ai = _shifted(ar), _shifted(ai)
    prep = ck.stage2_prep(ar, ai)
    ar16, ai16, energy = prep
    if shift:
        ar16, ai16 = _shifted(ar16), _shifted(ai16)
    same = (torch.equal(ar16, ar.to(torch.bfloat16))
            and torch.equal(ai16, ai.to(torch.bfloat16)))
    sq = ar * ar + ai * ai
    ref = torch.sum(sq, dim=-2)
    exact = torch.sum(sq.double(), dim=-2)
    del sq
    tiny = torch.finfo(torch.float32).tiny
    rel_sum = ((energy - ref).abs() / ref.clamp_min(tiny)).max().item()
    rel_exact = ((energy.double() - exact).abs()
                 / exact.clamp_min(tiny)).max().item()
    rel_torch = ((ref.double() - exact).abs()
                 / exact.clamp_min(tiny)).max().item()
    err_prep = (energy - exact.float()).abs().max().item()  # the plain's
    X0 = corner.SPLIT_X0
    idx = corner.band_topk(energy, X0)
    ref_idx = corner.band_topk(ref, X0)
    P, X = energy.shape
    m = torch.zeros((P, X), dtype=torch.bool, device=ar.device)
    m_ref = torch.zeros_like(m)
    m.scatter_(1, idx, True)
    m_ref.scatter_(1, ref_idx, True)
    moved = int((m & ~m_ref).sum().item())
    band = ck.stage2_band(ar, ai, idx)
    band_equal = (torch.equal(band[0], ck.band_operand(ar, ai, idx))
                  and torch.equal(band[1], ck.band_mask(idx, X)))
    cr, ci = ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, band)
    tr, ti = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6", (ar16, ai16))
    torch.cuda.synchronize()
    err = max((cr - tr).abs().max().item(), (ci - ti).abs().max().item())
    scale = max(tr.abs().max().item(), ti.abs().max().item())
    finite = bool(torch.isfinite(cr).all() and torch.isfinite(ci).all())
    del tr, ti
    band_bound = ck.SPLIT_REL["bf16x6"]
    band_err = ck.band_error(cr, ci, ar, ai, idx, tabs)
    seen = True
    more = ""
    if main:
        two = ck.band_error(*ck.fwd_stage2_plain(
            ar, ai, idx, tabs, "bf16x3", (ar16, ai16)), ar, ai, idx, tabs)
        bulk = ck.bulk_error(cr, ci, ar16, ai16, idx, tabs)
        n = min(24, ar16.shape[0])
        m16 = (ar16[:n], ai16[:n])
        lib = ck.bulk_error(
            corner._mm_bf16(tabs.eyr16, m16[0])
            - corner._mm_bf16(tabs.eyi16, m16[1]),
            corner._mm_bf16(tabs.eyr16, m16[1])
            + corner._mm_bf16(tabs.eyi16, m16[0]), ar16, ai16, idx, tabs, n)
        seen = two > band_bound and bulk <= K2_BULK_RMS
        more = (f"; the plain bf16x3 band's {two!r} (must exceed it); K2's "
                f"bulk RMS error against the exact sum of its bf16 products "
                f"({n} planes) {bulk!r} (bound {K2_BULK_RMS}; cuBLAS's bf16 "
                f"products {lib!r})")
    del cr, ci
    log(f"K2 {what} (P={P}, Kx={X}{', unaligned' if shift else ''}): prep "
        f"bf16 bit-equal {same}; energies vs torch.sum max rel {rel_sum!r}, "
        f"vs the exact sum {rel_exact!r} (torch.sum's own {rel_torch!r}), "
        f"max |energy - plain| {err_prep!r}; "
        f"band columns that differ from band_columns' {moved} of {P * X0}; "
        f"band operand and mask bit-equal {band_equal}; "
        f"K2 max |kernel - twin| {err!r} ({err / scale:.3e} of max|twin| "
        f"{scale!r}, bound {K2_REL}), finite {finite}; band columns' RMS "
        f"error on their own scale {band_err!r} (bound {band_bound!r})"
        + more)
    if not (same and band_equal and finite and rel_sum <= STAGE2_ENERGY_REL
            and rel_exact <= STAGE2_ENERGY_REL and err <= K2_REL * scale
            and band_err <= band_bound and seen):
        raise AssertionError(f"K2 {what}: the prep or K2 disagrees with its "
                             f"plain version")
    return err, err_prep, prep, idx, band


def _k1_prep_check(what: str, x, tabs, ar, ai, prep) -> float:
    """K1 with stage 2's prep in its epilogue (fwd_stage1, prep="energies")
    on the planes x against K1 alone (ar, ai) and the prep pass's output
    `prep`: ar, ai and the bf16 copies bit-equal, the energies within
    2^-24 of the exact sum, the band sets beside the prep pass's
    (differences counted). Returns max |energy - exact|."""
    import torch

    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    r, i, (r16, i16, energy) = ck.fwd_stage1(x, tabs.exr16, tabs.exi16,
                                             False, tabs.stage1, "energies")
    same = torch.equal(r, ar) and torch.equal(i, ai)
    del r, i
    copies = torch.equal(r16, prep[0]) and torch.equal(i16, prep[1])
    del r16, i16
    rel, err = 0.0, 0.0
    for p0 in range(0, ar.shape[0], 16):  # the exact sums 16 planes a time
        a, b = ar[p0:p0 + 16], ai[p0:p0 + 16]
        exact = torch.sum((a * a + b * b).double(), dim=1)
        e = energy[p0:p0 + 16]
        rel = max(rel, ((e.double() - exact).abs() / exact.clamp_min(
            torch.finfo(torch.float32).tiny)).max().item())
        err = max(err, (e - exact.float()).abs().max().item())
    X0 = min(corner.SPLIT_X0, ar.shape[-1])
    mine = corner.band_topk(energy, X0).sort(1).values
    theirs = corner.band_topk(prep[2], X0).sort(1).values
    moved = int((mine != theirs).any(1).sum().item())
    log(f"K1 with the prep, {what}: ar, ai bit-equal to K1's alone {same}; "
        f"copies bit-equal to the prep pass's {copies}; energies against "
        f"the exact sum max rel {rel!r} (bound 2^-24), max abs {err!r}; "
        f"planes whose band differs from the prep pass's {moved} of "
        f"{ar.shape[0]}")
    if not (same and copies and rel <= 2.0 ** -24):
        raise AssertionError(f"K1 with the prep, {what}: disagrees with K1 "
                             f"alone and the prep pass")
    return err


def phase_stage2(covers_d, odd_d, card: str) -> list:
    """3d: forward stage 2's prep pass, band kernel and K2
    (csrc/corner_stage2.cu) against their plain versions on each of
    STAGE2_GRIDS' stage-1 output (K1 on the grid's covers; _stage2_check);
    HGMMA and UTMALDG in K2's SASS. At 4K B=64 the cluster shape and the
    grid launched, and in turns by CUDA events
    beside the bounds (utils/cost.py stage2_prep_cost, stage2_band_cost,
    k2_cost): the three kernels through their wrappers, their plain
    versions, the eager composition they replace (corner._fwd_y_split), the
    new stage 2 as a whole (prep, topk, band, K2) and one torch.bmm of T0
    with the concatenated bf16 operands into f32 (K2's library_ms: the bulk,
    without the band; no one PyTorch call computes the prep or the band
    operand). Returns the kernels line's three entries."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.utils import cost

    sass = _build.sass_counts(ck.KERNEL_STAGE2, "corner_stage2_kernel")
    log(f"K2 SASS (corner_stage2_kernel, cuobjdump -sass): {sass}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"K2 is not wgmma + TMA: {sass}")
    peaks = cost.peak_rates(covers_d.device)
    errs, errs_prep, errs_fused, records = [], [], [], []
    for name, B, H, W in STAGE2_GRIDS:
        main = name == "4K"
        planes = (covers_d if main else odd_d if name == "4c"
                  else _grid_nchw(covers_d.device, B, H, W))
        Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
        tabs = corner.dft_tables_device(H, Ky, W, Kx, covers_d.device)
        x = planes.reshape(-1, H, W)
        ar, ai = ck.fwd_stage1(x, tabs.exr16, tabs.exi16, False, tabs.stage1)
        err, err_prep, prep, idx, band = _stage2_check(
            f"{name} B={B} {H}x{W}", ar, ai, tabs, shift="unaligned" in name,
            main=main)
        errs.append(err)
        errs_prep.append(err_prep)
        errs_fused.append(_k1_prep_check(f"{name} B={B} {H}x{W}", x, tabs,
                                         ar, ai, prep))
        if main:
            P = x.shape[0]
            ar16, ai16, _ = prep
            t2 = tabs.stage2
            Hp = t2.shape[2] // 2
            t_hi = torch.cat((t2[0, :, :H], t2[0, :, Hp:Hp + H]), 1)
            b_cat = torch.cat((ar16, ai16), 1)
            part = torch.zeros((ck.energy_slots(P, H), Kx),
                               dtype=torch.float64, device=ar.device)
            runs = {
                "K2": (lambda: ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs,
                                             band), 10),
                "band": (lambda: ck.stage2_band(ar, ai, idx), 10),
                "prep": (lambda: ck.stage2_prep(ar, ai), 10),
                "reduce": (lambda: ck.prep_reduce(part, P, H), 20),
                "K2 plain": (lambda: ck.fwd_stage2_plain(
                    ar, ai, idx, tabs, "bf16x6", (ar16, ai16)), 2),
                "band plain": (lambda: (ck.band_operand(ar, ai, idx),
                                        ck.band_mask(idx, Kx)), 3),
                "prep plain": (lambda: ck.stage2_prep_plain(ar, ai), 3),
                "reduce plain": (lambda: ck.prep_reduce_plain(part, P, H),
                                 3),
                "composition": (lambda: corner._fwd_y_split(ar, ai, tabs),
                                3),
                "stage 2": (lambda: corner._fwd_y(ar, ai, tabs, "adaptive"), 5),
                "torch.bmm": (lambda: torch.bmm(
                    t_hi.expand(P, *t_hi.shape), b_cat,
                    out_dtype=torch.float32), 3)}
            times = _turns(runs)
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            bounds = {k: cost.stage_bound(c, peaks) for k, c in (
                ("K2", cost.k2_cost(P, H, Ky, Kx)),
                ("band", cost.stage2_band_cost(P, H, Kx)),
                ("prep", cost.stage2_prep_cost(P, H, Kx)),
                ("reduce", cost.prep_reduce_cost(P, H, Kx)))}
            log(f"K2 {name} B={B} {H}x{W} Ky={Ky} Kx={Kx}: clusters "
                f"({ck.STAGE2_CLUSTER}, 1, 1), grid "
                f"{ck.stage2_grid(P, Kx, Ky)} blocks")
            log(f"K2 {name} B={B} {H}x{W} Ky={Ky} Kx={Kx} timed in turns "
                f"({card}): " + "; ".join(f"{k} {v!r} ms"
                                          for k, v in times.items())
                + "; bounds: " + "; ".join(
                    f"{k} {b!r} ms ({by}), at {b / ms[k]:.3f} of it"
                    for k, (b, by) in bounds.items())
                + f"; stage 2 {ms['composition'] / ms['stage 2']:.2f}x "
                f"faster than the eager composition")
            source = "steganosaurus_tpu_torch/csrc/corner_stage2.cu"

            def entry(kernel, key, replaces, library_ms):
                return {"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces, "ms": ms[key],
                        "plain_ms": ms[key + " plain"],
                        "bound_ms": bounds[key][0],
                        "bound_by": bounds[key][1],
                        "library_ms": library_ms}

            records = [
                entry(ck.KERNEL_STAGE2, "K2",
                      "steganosaurus_tpu/spectral/corner.py:430 "
                      "(_fwd_y_split, adaptive=True: the bulk and band dots "
                      ":496-503, the one-hot scatter :508-511)",
                      ms["torch.bmm"]),
                entry(ck.KERNEL_PREP_REDUCE, "reduce",
                      "steganosaurus_tpu/spectral/corner.py:478 "
                      "(_fwd_y_split's column energy; its bf16 operand "
                      "casts of the bulk dots, _mm :141, and the energies' "
                      "terms are in K1's epilogue)", None),
                entry(ck.KERNEL_BAND, "band",
                      "steganosaurus_tpu/spectral/corner.py:480-485 "
                      "(_fwd_y_split's one-hot gather of the band columns) "
                      "and :506 (their column mask)", None)]
            del t_hi, b_cat, runs, part
        del ar, ai, prep, idx, band, tabs, planes
        torch.cuda.empty_cache()
    records[0]["max_abs_err"] = max(errs)
    records[1]["max_abs_err"] = max(errs_fused)
    log(f"K2 prep pass max |energy - exact| over the grids {max(errs_prep)!r}, "
        f"K1's prep and its reduce {max(errs_fused)!r}")
    records[2]["max_abs_err"] = 0.0  # bit-equal at every grid, or raised
    return records


def phase_highest(dev, launches: dict) -> None:
    """4d: phase 4's 512x512 B=8 round trip under
    STEGANOSAURUS_MM_PRECISION=highest, the f32 mode users may ask for:
    8/8 on the card, each corner embed through K3's write_floor and K4e
    (the f32 inverse DFT leaves K4 out), no K1 (the f32 forward DFT), the
    stego within +-1 of the CPU port's under the same mode."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    covers = make_covers(SMALL_B, SMALL_H, SMALL_W)
    nchw = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    secrets = secrets_for(SMALL_B, SMALL_SECRET)
    salts = [bytes([i]) * 16 for i in range(SMALL_B)]
    old = os.environ.get("STEGANOSAURUS_MM_PRECISION")
    os.environ["STEGANOSAURUS_MM_PRECISION"] = "highest"
    try:
        def card():
            res = stt.embed_batch(torch.from_numpy(nchw).to(dev), secrets,
                                  master_key=MASTER_KEY, salts=salts,
                                  device_resident=True, layout="nchw")
            got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                                    clen_hint=SMALL_SECRET, layout="nchw")
            return res.stego, got

        stego, got = count_launches("4d highest", launches, card,
                                    wk.KERNEL_EPILOGUE)
        ref = stt.embed_batch(nchw, secrets, master_key=MASTER_KEY,
                              salts=salts, layout="nchw", device="cpu").stego
    finally:
        if old is None:
            os.environ.pop("STEGANOSAURUS_MM_PRECISION")
        else:
            os.environ["STEGANOSAURUS_MM_PRECISION"] = old
    n_ok = sum(g == s for g, s in zip(got, secrets))
    diff = stego.cpu().numpy().astype(np.int16) - ref.astype(np.int16)
    n_diff = int(np.count_nonzero(diff))
    c = launches["4d highest"]
    log(f"4d highest {SMALL_H}x{SMALL_W} B={SMALL_B}: recovered "
        f"{n_ok}/{SMALL_B}; stego vs CPU port: {n_diff} of {diff.size} bytes "
        f"differ, max |diff| {int(np.abs(diff).max())}; launches {c}")
    if n_ok != SMALL_B:
        raise AssertionError(f"4d recovered {n_ok}/{SMALL_B}")
    if np.abs(diff).max() > 1 or n_diff > SMALL_MAX_DIFF_FRAC * diff.size:
        raise AssertionError("4d: the card's stego disagrees with the CPU's")
    if any(c[k] for k in ck.LAUNCHES):
        raise AssertionError(f"4d launched K1 or a stage-2 kernel under "
                             f"highest: {c}")
    check_embed_kernels("4d highest", c, 1, mode="highest")


# 4e: the precision modes' round trips at 4K, (mode, B, gated): 16 KB
# secrets on phase 4's covers; bf16 (a measurement mode) is reported, not
# gated
MODE_ROUND_TRIPS = (("mix_split", UHD_B, True), ("mix", UHD_B, True),
                    ("mix2", 16, True), ("mix_conservative", 16, True),
                    ("high", 16, True), ("bf16", 16, False))
# the planes of phase 4's spectrum each K2 band width is held against its
# plain version on (the plain all-band product at B=64 needs ~30 GB; a
# plane's bits do not depend on its batch)
K2_WIDTH_PLANES = 12


def _with_mode(mode: str, fn):
    """fn() under STEGANOSAURUS_MM_PRECISION=mode, the variable restored
    after."""
    old = os.environ.get("STEGANOSAURUS_MM_PRECISION")
    os.environ["STEGANOSAURUS_MM_PRECISION"] = mode
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("STEGANOSAURUS_MM_PRECISION")
        else:
            os.environ["STEGANOSAURUS_MM_PRECISION"] = old


def _mode_round_trip(covers, mode: str, gated: bool, launches: dict,
                     card: str) -> None:
    """One precision mode's 4K 16 KB round trip on `covers` (phase 4's, or
    their first B): a first run, then a counted warm run (embed, extract),
    its launches recorded under "4e <mode>" and checked, the rows
    recovered (all of them where `gated`), warm ms, PSNR, peak memory and
    K2's band widths; where `gated` and B = 64 also the channel report
    (raw BER, post-ECC 0)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    B = covers.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    path = f"4e {mode}"
    PATH_MODES[path] = mode
    p = corner.resolve(mode)

    def round_trip():
        t0 = time.perf_counter()
        res = stt.embed_batch(covers, secrets, master_key=MASTER_KEY,
                              salts=salts, device_resident=True,
                              layout="nchw")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                                clen_hint=UHD_SECRET, layout="nchw")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return res.stego, got, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def run():
        round_trip()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = round_trip()
        torch.cuda.synchronize()
        return out, read_counts(), dict(ck.BAND_WIDTHS), \
            torch.cuda.max_memory_allocated()

    (stego, got, e_ms, x_ms), counts, widths, peak = _with_mode(mode, run)
    launches[path] = counts
    bad = [i for i, (g, s) in enumerate(zip(got, secrets)) if g != s]
    psnr = psnr_mean(stego, covers)
    rep = None
    if gated and B == UHD_B:
        rep = _with_mode(mode, lambda: stt.channel_report(
            stego, secrets, salts, master_key=MASTER_KEY, layout="nchw"))
    log(f"4e {mode} 4K B={B} {UHD_SECRET} B warm round trip ({card}): "
        f"embed {e_ms!r} ms, extract {x_ms!r} ms, total {e_ms + x_ms!r} ms, "
        f"recovered {B - len(bad)}/{B} (failed images {bad}), mean PSNR "
        f"{psnr!r} dB, peak memory {peak / 2**30!r} GiB; K2 launches by band "
        f"width in columns {widths}"
        + (f"; channel report: payload raw BER {rep['payload_ber_raw']!r}, "
           f"post-ECC {rep['payload_ber_post_ecc']!r}, header raw BER "
           f"{rep['header_ber_raw']!r}" if rep else "")
        + ("" if gated else " (a measurement mode: reported, not gated)"))
    if gated and bad:
        raise AssertionError(f"4e {mode} recovered {B - len(bad)}/{B}")
    if rep is not None and rep["payload_ber_post_ecc"] != 0.0:
        raise AssertionError(f"4e {mode}: payload post-ECC BER is not 0: "
                             f"{rep}")
    if not math.isfinite(psnr) or stego.shape != covers.shape:
        raise AssertionError(f"4e {mode}: stego {tuple(stego.shape)}, PSNR "
                             f"{psnr}")
    Kx = corner.corner_dims(*covers.shape[-2:], stt.Params().rmax)[1]
    # the forward DFTs: the embed's and the extract's (more where an image
    # fails and the soft retry reads again: bf16)
    n_fwd = counts[ck.KERNEL_STAGE2]
    want_width = corner.band_width(p.fwd2, Kx)
    if (want_width is None or widths != {want_width: n_fwd}
            or n_fwd != 2 and gated or n_fwd < 2):
        raise AssertionError(f"4e {mode}: K2's band widths {widths}, want "
                             f"{{{want_width}: 2}}")
    k1 = sum(counts[k] for k in ck.K1_ROUTES)
    if (k1 != (n_fwd if p.stage1 == "bf16" else 0)
            or _stage2_launches(p, k1, n_fwd) != _stage2_counts(counts)):
        raise AssertionError(f"4e {mode}: stage 1 / stage 2 launches "
                             f"{counts}")
    check_embed_kernels(path, counts, 1, mode=mode)
    reads = (counts[rk.KERNEL_READ_DECODE], counts[rk.KERNEL_READ_EAGER])
    if gated and reads != (1, 0):
        raise AssertionError(f"4e {mode}: the extract is not one K5 launch "
                             f"and no eager read: {reads}")


def _k2_widths(covers_d, card: str) -> None:
    """K2 at band widths of 0 (the bulk alone, bf16), 64 (the static
    [0, 64): mix_split) and Kx (every column, no bulk: the HIGH modes) on
    phase 4's spectrum (K1 on its covers): each held against
    fwd_stage2_plain(bf16x6) on K2_WIDTH_PLANES planes (K2_REL of max|twin|;
    the band within SPLIT_REL on its own scale), then timed in turns beside
    its bound (utils/cost.py k2_cost), one torch.bmm of T0 with the bf16
    operands into f32 (the bulk in bf16), and, beside the all-band width,
    the band pass at that width and one f32 torch.bmm of T with the f32
    operands (the stage at full f32 on the CUDA cores)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.utils import cost

    dev = covers_d.device
    H, W = covers_d.shape[-2:]
    Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    ar, ai = ck.fwd_stage1(covers_d.reshape(-1, H, W), tabs.exr16,
                           tabs.exi16, False, tabs.stage1)
    P = ar.shape[0]
    ar16, ai16, _ = ck.stage2_prep(ar, ai)
    n = K2_WIDTH_PLANES
    cases = {}
    for width in (0, 64, Kx):
        idx = ck.static_band(P, width, dev)
        band = ck.stage2_band(ar, ai, idx) if width else None
        bulk = (ar16, ai16) if width < Kx else (None, None)
        cases[width] = (idx, band, bulk)
        cr, ci = ck.fwd_stage2(ar, ai, *bulk, idx, tabs, band)
        tr, ti = ck.fwd_stage2_plain(ar[:n], ai[:n], idx[:n], tabs, "bf16x6",
                                     (ar16[:n], ai16[:n]))
        torch.cuda.synchronize()
        err = max((cr[:n] - tr).abs().max().item(),
                  (ci[:n] - ti).abs().max().item())
        scale = max(tr.abs().max().item(), ti.abs().max().item())
        band_err = (ck.band_error(cr[:n], ci[:n], ar[:n], ai[:n], idx[:n],
                                  tabs) if width else 0.0)
        finite = bool(torch.isfinite(cr).all() and torch.isfinite(ci).all())
        what = ", no bulk" if width == Kx else ""
        log(f"K2 band width {width} ({width // 64} groups{what}) "
            f"4K B={P // 3}: max |kernel - twin| over {n} planes {err!r} "
            f"({err / scale:.3e} of max|twin| {scale!r}, bound {K2_REL}); "
            f"band columns' RMS error on their own scale {band_err!r} "
            f"(bound {ck.SPLIT_REL['bf16x6']!r}); finite {finite}; grid "
            f"{ck.stage2_grid(P, Kx, Ky, nb=width // 64, bulk=width < Kx)} "
            f"blocks")
        del cr, ci, tr, ti
        if not (finite and err <= K2_REL * scale
                and band_err <= ck.SPLIT_REL["bf16x6"]):
            raise AssertionError(f"K2 at band width {width} disagrees with "
                                 f"its plain version")
    t2 = tabs.stage2
    Hp = t2.shape[2] // 2
    t_hi = torch.cat((t2[0, :, :H], t2[0, :, Hp:Hp + H]), 1)
    t_f32 = torch.cat((torch.cat((tabs.eyr, -tabs.eyi), 1),
                       torch.cat((tabs.eyi, tabs.eyr), 1)))  # T, (2Ky, 2H)
    b16 = torch.cat((ar16, ai16), 1)
    b32 = torch.cat((ar, ai), 1)
    runs = {f"K2 width {w}": (lambda w=w: ck.fwd_stage2(
        ar, ai, *cases[w][2], cases[w][0], tabs, cases[w][1]),
        5 if w == Kx else 10) for w in cases}
    runs[f"band pass width {Kx}"] = (
        lambda: ck.stage2_band(ar, ai, cases[Kx][0]), 5)
    runs["torch.bmm bf16"] = (lambda: torch.bmm(
        t_hi.expand(P, *t_hi.shape), b16, out_dtype=torch.float32), 3)
    runs["torch.bmm f32"] = (lambda: torch.bmm(
        t_f32.expand(P, *t_f32.shape), b32), 2)
    times = _turns(runs)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    peaks = cost.peak_rates(dev)
    bounds = {f"K2 width {w}": cost.stage_bound(
        cost.k2_cost(P, H, Ky, Kx, band=w), peaks) for w in cases}
    bounds[f"band pass width {Kx}"] = cost.stage_bound(
        cost.stage2_band_cost(P, H, Kx, band=Kx), peaks)
    log(f"K2 band widths 4K B={P // 3} timed in turns ({card}): "
        + "; ".join(f"{k} {v!r} ms" for k, v in times.items())
        + "; bounds: " + "; ".join(
            f"{k} {b!r} ms ({by}), at {b / ms[k]:.3f} of it"
            for k, (b, by) in bounds.items())
        + f"; library beside: the bulk in bf16 (torch.bmm bf16) "
        f"{ms['torch.bmm bf16']!r} ms, every column in f32 (torch.bmm f32) "
        f"{ms['torch.bmm f32']!r} ms")
    del cases, runs, b16, b32, ar, ai, ar16, ai16
    torch.cuda.empty_cache()


# the batch of the f32 stages' timings (4e): the B of the f32 modes' round
# trips
F32_STAGES_B = 16


def _f32_stages(covers_d, card: str) -> None:
    """The f32 stages of the HIGH modes at 4K B=F32_STAGES_B on phase 4's
    first covers, timed in turns by CUDA events beside their bounds
    (utils/cost.py) and beside the kernel the default path runs for each:
    stage 1 as fwd_corner runs it under high and highest (the u8 planes
    cast, two f32 products) beside K1; forward stage 2 under highest (four
    f32 products, corner._fwd_y) beside K2's all-band launch (the HIGH
    modes'); the inverse's y-stage in f32 (corner._ifft_y: mix2,
    mix_conservative, high) beside K6, mix2's cast of its output to bf16,
    and the x-stage in f32 (two products and a difference:
    mix_conservative, high, highest) beside K4 (with its u8 epilogue)."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import write_kernels as wk
    from steganosaurus_tpu_torch.utils import cost

    B = F32_STAGES_B
    planes = covers_d[:B].contiguous()
    H, W = planes.shape[-2:]
    Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    x = planes.reshape(-1, H, W)
    P = x.shape[0]

    def stage1_f32():
        f = spectral.apply_center(x.to(torch.float32), False)
        return f @ tabs.exr.T, f @ tabs.exi.T

    ar, ai = ck.fwd_stage1(x, tabs.exr16, tabs.exi16, False, tabs.stage1)
    cr, ci = corner._fwd_y(ar, ai, tabs, "high")
    dcr16, dci16 = cr.to(torch.bfloat16), (-ci).to(torch.bfloat16)
    mr, mi = corner._ifft_y(cr, ci, tabs, "high", False)
    mr16, mi16 = wk.ifft_y(dcr16, dci16, tabs)

    def ifft_x_f32():
        t = mr @ tabs.exr
        t -= mi @ tabs.exi
        return t

    runs = {
        "stage 1 f32": (stage1_f32, 3),
        "K1": (lambda: ck.fwd_stage1(x, tabs.exr16, tabs.exi16, False,
                                     tabs.stage1), 5),
        "stage 2 f32": (lambda: corner._fwd_y(ar, ai, tabs, "highest"), 3),
        "K2 every column": (lambda: corner._fwd_y(ar, ai, tabs, "high"), 3),
        "inverse y f32": (lambda: corner._ifft_y(cr, ci, tabs, "high",
                                                 False), 3),
        "K6": (lambda: wk.ifft_y(dcr16, dci16, tabs), 5),
        "cast": (lambda: (mr.to(torch.bfloat16), mi.to(torch.bfloat16)), 5),
        "inverse x f32": (ifft_x_f32, 3),
        "K4": (lambda: wk.ifft_epilogue(mr16, mi16, tabs, planes, False,
                                        "nchw"), 5)}
    times = _turns(runs)
    peaks = cost.peak_rates(covers_d.device)
    bounds = {k: cost.stage_bound(c, peaks) for k, c in (
        ("stage 1 f32", cost.k1_cost(P, H, W, Kx, precision="fp32")),
        ("K1", cost.k1_cost(P, H, W, Kx)),
        ("stage 2 f32", cost.stage2_f32_cost(P, H, Ky, Kx)),
        ("K2 every column", cost.k2_cost(P, H, Ky, Kx, band=Kx)),
        ("inverse y f32", cost.ifft_y_f32_cost(B, H, Ky, Kx)),
        ("K6", cost.ifft_y_cost(B, H, Ky, Kx)),
        ("cast", cost.ifft_y_cast_cost(B, H, Kx)),
        ("inverse x f32", cost.ifft_x_f32_cost(B, H, W, Kx)),
        ("K4", cost.ifft_epilogue_cost(B, H, W, Kx)))}
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"4e f32 stages 4K B={B} timed in turns ({card}): "
        + "; ".join(f"{k} {v!r} ms (bound {bounds[k][0]!r} ms, "
                    f"{bounds[k][1]}, at {bounds[k][0] / ms[k]:.3f} of it)"
                    for k, v in times.items()))
    del ar, ai, cr, ci, dcr16, dci16, mr, mi, mr16, mi16, runs
    torch.cuda.empty_cache()


def phase_precision_modes(covers_d, dev, launches: dict, card: str) -> None:
    """4e: the precision modes other than the default on the card. K2 at
    band widths 0, 64 and Kx on phase 4's spectrum (_k2_widths); 4K 16 KB
    round trips (_mode_round_trip) under mix_split and mix at B=64, under
    mix2, mix_conservative and high at B=16, each gated on recovering every
    image (B=64: post-ECC 0 too), and under bf16 at B=16, reported; bf16's
    512x512 B=8 stego within +-1 of the CPU port's under the same mode.
    STEGANOSAURUS_MM_PRECISION is restored after each."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt

    _k2_widths(covers_d, card)
    _f32_stages(covers_d, card)
    for mode, B, gated in MODE_ROUND_TRIPS:
        _mode_round_trip(covers_d if B == UHD_B else covers_d[:B].contiguous(),
                         mode, gated, launches, card)
        torch.cuda.empty_cache()
    covers = make_covers(SMALL_B, SMALL_H, SMALL_W)
    nchw = np.ascontiguousarray(covers.transpose(0, 3, 1, 2))
    secrets = secrets_for(SMALL_B, SMALL_SECRET)
    salts = [bytes([i]) * 16 for i in range(SMALL_B)]

    def both():
        card_stego = stt.embed_batch(torch.from_numpy(nchw).to(dev), secrets,
                                     master_key=MASTER_KEY, salts=salts,
                                     device_resident=True,
                                     layout="nchw").stego.cpu().numpy()
        cpu = stt.embed_batch(nchw, secrets, master_key=MASTER_KEY,
                              salts=salts, layout="nchw", device="cpu").stego
        return card_stego, cpu

    stego, ref = _with_mode("bf16", both)
    diff = stego.astype(np.int16) - ref.astype(np.int16)
    n_diff = int(np.count_nonzero(diff))
    log(f"4e bf16 {SMALL_H}x{SMALL_W} B={SMALL_B}: stego vs CPU port "
        f"{n_diff} of {diff.size} bytes differ, max |diff| "
        f"{int(np.abs(diff).max())}")
    if np.abs(diff).max() > 1 or n_diff > MODE_MAX_DIFF_FRAC * diff.size:
        raise AssertionError("4e: the card's bf16 stego disagrees with the "
                             "CPU port's")


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


def _stego_against_prep_pass(covers_d, secrets, salts, stego) -> None:
    """Phase 4's 4K stego against the one stage 2's route before K1 took
    over its prep gives (corner.stage1_prep made to ask for nothing, so the
    prep pass runs; K1's ar and ai are the same bits either way): the bytes
    that differ, and the planes whose top-64 band the embed's forward DFT
    picks differently on the two routes (K1's energies against the prep
    pass's). Bytes may differ only where a band did."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    real = corner.stage1_prep
    corner.stage1_prep = lambda fwd2, Kx: None
    try:
        ref = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                              salts=salts, device_resident=True,
                              layout="nchw").stego
    finally:
        corner.stage1_prep = real
    diff = int((ref != stego).sum().item())
    del ref
    H, W = covers_d.shape[-2:]
    params = stt.Params()
    Ky, Kx = corner.corner_dims(H, W, params.rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, covers_d.device)
    ar, ai, (_, _, energy) = ck.fwd_stage1(
        covers_d.reshape(-1, H, W), tabs.exr16, tabs.exi16, params.center,
        tabs.stage1, "energies")
    passed = ck.stage2_prep(ar, ai)[2]
    del ar, ai
    X0 = corner.split_x0()
    mine = corner.band_topk(energy, X0).sort(1).values
    theirs = corner.band_topk(passed, X0).sort(1).values
    moved = torch.nonzero((mine != theirs).any(1)).flatten().tolist()
    torch.cuda.empty_cache()
    log(f"4K stego against the prep pass's route: {diff} bytes differ; "
        f"planes whose embed band differs {moved} (columns "
        f"{[sorted(set(mine[p].tolist()) ^ set(theirs[p].tolist())) for p in moved]})")
    if diff and not moved:
        raise AssertionError(f"4K stego: {diff} bytes differ from the prep "
                             f"pass's route with every band the same")


def phase_uhd(covers_d, what: str = "4K", route: str = "") -> tuple:
    """The main path at 4K UHD, B=64, 16 KB, on covers_d (phase 4; 4c: the
    same covers cropped by one column). Every secret must come back, and
    stage 1 must launch on `route` only (by default the TMA route). Returns
    the kernels' launch counts of the counted (warm) round trip, its
    (embed ms, extract ms) and its stego."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

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
    zero_counts()
    plans = rk.PLANS_BUILT
    (stego, e_ms, x_ms), eager = count_eager_stage2(round_trip)
    launches = read_counts()
    plans = rk.PLANS_BUILT - plans
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
    digest = hashlib.sha256(stego.cpu().numpy().tobytes()).hexdigest()
    log(f"{what} warm round trip's stego sha256 {digest} (a parent and a "
        f"change compare byte for byte by it)")
    sha, peak_rec, ms_rec = RECORDED[what]
    log(f"{what} beside the parent's record (before K4): sha256 {digest[:8]} "
        f"vs {sha}, peak memory {peak / 2**30!r} vs {peak_rec} GiB, warm "
        f"round trip {total!r} vs {ms_rec} ms")
    if what == "4K":
        _stego_against_prep_pass(covers_d, secrets, salts, stego)
    log(f"launches in the counted round trip: {launches}; eager stage 2 "
        f"(corner._fwd_y_split) ran {eager} times")
    if launches[route] <= 0 or any(launches[k] for k in ck.K1_ROUTES
                                   if k != route):
        raise AssertionError(f"the {what} path did not launch {route} "
                             f"alone: {launches}")
    if (*_stage2_counts(launches), eager) != (2, 2, 0, 2, 2, 0):
        raise AssertionError(f"the {what} path's stage 2 is not K1's prep, "
                             f"its reduce, the band kernel and K2 twice: "
                             f"{launches}, eager {eager}")
    check_embed_kernels(what, launches, 1)
    reads = (launches[rk.KERNEL_READ_DECODE], launches[rk.KERNEL_READ_EAGER])
    if reads != (1, 0):
        raise AssertionError(f"the {what} extract is not one K5 launch and "
                             f"no eager read: (K5, eager reads) {reads}")
    if plans:
        raise AssertionError(f"the {what} warm round trip built {plans} "
                             f"read plans (the walk's plan is cached)")
    return launches, (e_ms, x_ms), stego


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
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    launches[path] = read_counts()
    if launches[path][kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched on the {path} "
                             f"path")
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
        # QIM and per-image walks write in eager torch and take K3's
        # floor_only; every other mode K3's write_floor
        check_embed_kernels(f"5f {name}", launches[f"5f {name}"], 1,
                            floor_only=bool(p.qim or p.per_image_walk))
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
        check_embed_kernels("5g stealth 4K", launches["5g stealth 4K"], 1,
                            floor_only=True)
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
    full-grid batch cores run torch.fft, never the corner DFT or the
    corner write): any launch there means the path took the wrong route.
    Returns fn()'s result."""
    import torch

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    launches[path] = read_counts()
    if any(launches[path].values()):
        raise AssertionError(f"the {path} path launched a corner kernel: "
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
    every kernel count set to 0 just before it; the counts of each request
    land in counts[name] once the loop has answered it (when it asks for
    the next line, or for the end of the input)."""
    prev = None
    for name, req in reqs:
        if prev is not None:
            counts[prev] = read_counts()
        zero_counts()
        prev = name
        yield json.dumps(req) + "\n"
    if prev is not None:
        counts[prev] = read_counts()


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
        if name.startswith("embed"):
            check_embed_kernels(f"8a {name}", n, 1)
    for name, n in ccounts.items():
        launches[f"8a {name}"] = n
        if any(n.values()):
            raise AssertionError(f"8a: {name} launched a corner kernel: "
                                 f"{n}")
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


# --- phase 9: the parallel layer and the cost model ----------------------------

# 9b: logical shards of the one card, and the rows whose first read-back
# is made to fail in the verify run (3 of them: 4 does not divide 3, so the
# retry must run unsharded, as JAX's tests/test_batch.py:158-186 forces)
MESH_LOGICAL = 4
MESH_FAILED_ROWS = (1, 4, 6)
MESH_DIFF_FRAC = 5e-3
# 9c: the sharded single-image FFT at 4K on MESH_LOGICAL logical shards:
# its planes against the unsharded full-grid embed's, on the same bins, in
# 0-255 units (both are f32 FFT round trips that sum in other orders),
# about 5x the 3.66e-4 measured on an H100 (the CPU tests' 2e-3); and the
# u8 bytes that round apart, about 5x the 789 measured there
DIST_PLANES_ATOL = 2e-3
DIST_MAX_ROUND_APART = 4000
DIST_MAX_RAW_ERR = 0.05
# 9d: the pinned buffer of the link probe
LINK_BYTES = 256 << 20


def _mesh_round_trip(covers_d, mesh, secrets, salts, what: str) -> tuple:
    """One embed_batch -> extract_batch of the 4K batch over `mesh`
    (device-resident, nchw): every secret back. Returns (stego gathered on
    the first card, embed ms, extract ms)."""
    import torch

    import steganosaurus_tpu_torch as stt

    B = covers_d.shape[0]
    t0 = time.perf_counter()
    res = stt.embed_batch(covers_d, secrets, master_key=MASTER_KEY,
                          salts=salts, mesh=mesh, device_resident=True,
                          layout="nchw")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                            clen_hint=UHD_SECRET, layout="nchw")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_ok = sum(g == s for g, s in zip(got, secrets))
    if n_ok != B:
        raise AssertionError(f"{what} recovered {n_ok}/{B}")
    if [p.device for p in res.stego.parts] != list(mesh.devices):
        raise AssertionError(f"{what}: stego shards on "
                             f"{[p.device for p in res.stego.parts]}")
    return (res.stego.gather(covers_d.device), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3)


def _k1_per_shard(path: str, launches: dict, mesh, passes: int) -> None:
    """K1 (the TMA route) launched once per shard per pass on `path`, and
    K3's write_floor and K4 once per shard per embed (half the passes)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    want = passes * mesh.size
    if launches[path][ck.KERNEL_TMA] != want or launches[path][ck.KERNEL_LDG]:
        raise AssertionError(f"{path}: K1 launches {launches[path]}, want "
                             f"{want} on {ck.KERNEL_TMA} ({mesh.size} "
                             f"shards x {passes} passes)")
    check_embed_kernels(path, launches[path], passes // 2 * mesh.size)


def phase_mesh_cards(covers_d, stego4, ms4, launches: dict) -> None:
    """9a: make_mesh() over the machine's cards (one here) and the 4K B=64
    16 KB round trip with mesh=, phase 4's covers and salts: 64/64, the
    stego byte-equal to phase 4's, K1 once per shard per pass, warm ms
    beside phase 4's."""
    import torch

    from steganosaurus_tpu_torch import parallel

    mesh = parallel.make_mesh()
    B = covers_d.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    _mesh_round_trip(covers_d, mesh, secrets, salts, "9a (first)")
    path = f"9a mesh of {mesh.size} card(s)"
    stego, e_ms, x_ms = count_launches(path, launches, lambda: (
        _mesh_round_trip(covers_d, mesh, secrets, salts, "9a")))
    _k1_per_shard(path, launches, mesh, 2)
    same = torch.equal(stego, stego4)
    log(f"9a make_mesh() = {mesh.size} card(s) {list(mesh.devices)}: 4K "
        f"B={B} 16 KB recovered {B}/{B}; stego byte-equal to phase 4's: "
        f"{same}; warm embed {e_ms!r} ms, extract {x_ms!r} ms, round trip "
        f"{e_ms + x_ms!r} ms (phase 4: {ms4[0]!r} + {ms4[1]!r} = "
        f"{sum(ms4)!r} ms); K1 {launches[path]}")
    if not same:
        raise AssertionError("9a: the mesh stego differs from phase 4's")


def phase_mesh_logical(covers_d, stego4, ms4, launches: dict) -> None:
    """9b: MESH_LOGICAL logical shards of the one card (the sharded
    arithmetic; not the interconnect), the same batch: 64/64, the stego
    within +-1 of phase 4's on at most MESH_DIFF_FRAC of bytes, K1 once per
    shard per pass; embed_stream -> extract_stream over the mesh, depth 2,
    two batches; verify=True with MESH_FAILED_ROWS failing their first
    read-back, whose retry must run unsharded."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import parallel
    from steganosaurus_tpu_torch.pipeline import batch as pb

    mesh = parallel.make_mesh(MESH_LOGICAL, device=covers_d.device)
    B = covers_d.shape[0]
    secrets = secrets_for(B, UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    _mesh_round_trip(covers_d, mesh, secrets, salts, "9b (first)")
    path = f"9b mesh of {MESH_LOGICAL} logical shards"
    stego, e_ms, x_ms = count_launches(path, launches, lambda: (
        _mesh_round_trip(covers_d, mesh, secrets, salts, "9b")))
    _k1_per_shard(path, launches, mesh, 2)
    diff = (stego.to(torch.int16) - stego4.to(torch.int16)).abs()
    n_diff, d_max = diff.count_nonzero().item(), diff.max().item()
    del diff, stego
    log(f"9b {MESH_LOGICAL} logical shards of one card (shared card: the "
        f"sharded arithmetic, not the interconnect): recovered {B}/{B}; "
        f"stego vs phase 4's: {n_diff} of {stego4.numel()} bytes differ "
        f"({n_diff / stego4.numel():.3e}), max |diff| {d_max}; warm embed "
        f"{e_ms!r} ms, extract {x_ms!r} ms, round trip {e_ms + x_ms!r} ms "
        f"(phase 4: {sum(ms4)!r} ms); K1 {launches[path]}")
    if d_max > 1 or n_diff > MESH_DIFF_FRAC * stego4.numel():
        raise AssertionError("9b: the logical-shard stego is not within +-1 "
                             "of phase 4's on the allowed share of bytes")

    def stream():
        t = time.perf_counter()
        embeds = stt.embed_stream(((covers_d, secrets, salts)
                                   for _ in range(2)),
                                  master_key=MASTER_KEY, mesh=mesh, depth=2,
                                  layout="nchw")
        n_ok = [sum(g == s for g, s in zip(got, secrets))
                for got in stt.extract_stream(
                    (r.stego for r in embeds), master_key=MASTER_KEY,
                    mesh=mesh, clen_hint=UHD_SECRET, depth=2,
                    layout="nchw")]
        torch.cuda.synchronize()
        return n_ok, time.perf_counter() - t

    n_ok, dt = count_launches("9b stream over the mesh", launches, stream)
    log(f"9b stream over {MESH_LOGICAL} logical shards, depth 2, 2 batches "
        f"of {B}: recovered {n_ok}, {2 * B / dt!r} img/s (wall {dt!r} s), "
        f"K1 {launches['9b stream over the mesh']}")
    if n_ok != [B, B]:
        raise AssertionError(f"9b stream recovered {n_ok}")
    _k1_per_shard("9b stream over the mesh", launches, mesh, 4)

    real_extract, real_embed = pb.extract_batch, pb.embed_batch
    calls, sub_meshes = [], []

    def flaky_extract(*a, **kw):
        out = list(real_extract(*a, **kw))
        calls.append(1)
        if len(calls) == 1:
            for i in MESH_FAILED_ROWS:
                out[i] = None
        return out

    def recording_embed(*a, **kw):
        sub_meshes.append(kw.get("mesh"))
        return real_embed(*a, **kw)

    pb.extract_batch, pb.embed_batch = flaky_extract, recording_embed
    try:
        res = count_launches("9b verify retry", launches, lambda: real_embed(
            covers_d, secrets, master_key=MASTER_KEY, salts=salts, mesh=mesh,
            verify=True, device_resident=True, layout="nchw"))
    finally:
        pb.extract_batch, pb.embed_batch = real_extract, real_embed
    got = stt.extract_batch(res.stego, master_key=MASTER_KEY,
                            clen_hint=UHD_SECRET, layout="nchw")
    resalted = [i for i, (a, b) in enumerate(zip(res.salts, salts)) if a != b]
    log(f"9b verify=True, rows {list(MESH_FAILED_ROWS)} failing their first "
        f"read-back: retry meshes {sub_meshes}, re-salted rows {resalted}, "
        f"verified {sum(res.verified)}/{B}, read back "
        f"{sum(g == s for g, s in zip(got, secrets))}/{B}, K1 "
        f"{launches['9b verify retry']}")
    if (sub_meshes != [None] or res.verified != [True] * B or got != secrets
            or resalted != list(MESH_FAILED_ROWS)):
        raise AssertionError("9b: the non-divisible verify retry did not run "
                             "unsharded or did not recover every row")


def phase_fft_dist(covers_d, launches: dict) -> None:
    """9c: one bench cover's spectrum sharded over MESH_LOGICAL logical
    shards of the card (parallel/fft_dist.py): embed_core_distributed on
    the shared walk's bins of a 16 KB frame (default Params: alpha 0.5,
    write floor 0.45), held against the unsharded full-grid embed on the
    same bins (DIST_PLANES_ATOL, at most DIST_MAX_ROUND_APART u8 bytes
    rounding apart); its u8 stego read back by
    read_core_distributed (raw errors < DIST_MAX_RAW_ERR, JAX's bar); the
    sharded median equal to the bisection median of the whole spectrum;
    sharded and unsharded ms beside each other. torch.fft only: K1 must not
    launch."""
    import numpy as np
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import parallel, spectral
    from steganosaurus_tpu_torch.ops import phase as phase_ops
    from steganosaurus_tpu_torch.ops import stats
    from steganosaurus_tpu_torch.parallel import fft_dist
    from steganosaurus_tpu_torch.pipeline import batch as pb

    dev = covers_d.device
    p = stt.Params()
    planes = covers_d[0].to(torch.float32)
    H, W = planes.shape[-2:]
    nbits = 912 + (UHD_SECRET + 16) * 8 * 7
    plane, y, x, jit, nprod = pb._walk_indices(None, MASTER_KEY, p, H, W,
                                               nbits, allow_short=True)
    if nprod < nbits:
        raise AssertionError(f"9c: walk of {nprod} < {nbits} bins")
    idx = [torch.from_numpy(np.array(a[:nbits])).to(dev)
           for a in (plane, y, x, jit)]
    pl, yy, xx = (a.long() for a in idx[:3])
    jj = idx[3].to(torch.float32)
    bits = torch.from_numpy(np.random.default_rng(9).integers(
        0, 2, nbits, dtype=np.uint8)).to(dev)
    mesh = parallel.make_mesh(MESH_LOGICAL, axis="image", device=dev)
    kw = dict(floor=p.write_floor, img_pixels=float(H * W))

    def sharded():
        return fft_dist.embed_core_distributed(
            planes, pl, yy, xx, bits, jj, p.alpha, mesh, **kw).gather(dev)

    def dense():
        return spectral.ifft2_real(phase_ops.embed_phases(
            spectral.fft2(planes), pl, yy, xx, bits, jj, p.alpha, None,
            False, **kw))

    out = count_no_launches("9c fft_dist embed", launches, sharded)
    ref = dense()
    err = (out - ref).abs().max().item()
    q = torch.floor(out + 0.5).clamp_(0, 255)
    n_round = (q != torch.floor(ref + 0.5).clamp_(0, 255)).sum().item()
    got = count_no_launches("9c fft_dist read", launches, lambda: (
        fft_dist.read_core_distributed(q, pl, yy, xx, jj, p.alpha, mesh)))
    raw = (got != bits).to(torch.float32).mean().item()
    spec = fft_dist.fft2_distributed(planes, mesh)
    med = fft_dist.median_abs_distributed(spec, mesh)
    mags = spec.gather(dev).abs().reshape(3, -1)
    med_ref = stats.kth_smallest_nonneg(mags, mags.shape[-1] // 2)
    del spec, mags
    t = _turns({"sharded embed": (sharded, 3), "unsharded embed": (dense, 3),
                "sharded read": (lambda: fft_dist.read_core_distributed(
                    q, pl, yy, xx, jj, p.alpha, mesh), 3),
                "unsharded read": (lambda: phase_ops.read_phases(
                    spectral.fft2(q), pl, yy, xx, jj, p.alpha, None, False),
                    3)}, rounds=1)
    log(f"9c fft_dist at {H}x{W}, {MESH_LOGICAL} logical shards of one card "
        f"(shared card: the collectives are copies within it), {nbits} walk "
        f"bins: max |sharded - unsharded| planes {err!r} (tolerance "
        f"{DIST_PLANES_ATOL}), u8 bytes rounding apart {n_round} (at most "
        f"{DIST_MAX_ROUND_APART}); raw read "
        f"errors {raw!r}; median {med.tolist()} vs bisection "
        f"{med_ref.tolist()}, equal {torch.equal(med, med_ref)}; ms "
        f"{ {k: v[0] for k, v in t.items()} }")
    if not (err <= DIST_PLANES_ATOL and n_round <= DIST_MAX_ROUND_APART
            and raw < DIST_MAX_RAW_ERR
            and torch.equal(med, med_ref)):
        raise AssertionError("9c: fft_dist disagrees with the unsharded path")


def phase_cost(covers_d, ms4, launches: dict, card: str) -> None:
    """9d: the cost model at the 4K headline (B=64, 16 KB, default Params):
    per-stage FLOPs, bytes and bounds and the round trip's bound on this
    card; measure_device_step's embed and extract core times and the share
    of the bound each reaches (above 1.0 is a counting fault and fails);
    measure_link with a LINK_BYTES pinned buffer, GB/s each way."""
    from steganosaurus_tpu_torch.utils import cost

    B, _, H, W = covers_d.shape
    peaks = cost.peak_rates(covers_d.device)
    rep = cost.roundtrip_cost(B, H, W, UHD_SECRET)
    bound = cost.roundtrip_bound(rep, peaks)
    for s, (_, _, ms, by) in zip(rep["stages"], bound["stages"]):
        log(f"9d cost {s['side']} {s['stage']}: FLOPs "
            f"{ {k: f'{v:.4e}' for k, v in s['gemm_flops'].items()} } "
            f"+ elementwise {s['elementwise_flops']:.4e} (an estimate; "
            f"{s['precision']}), "
            f"HBM bytes {s['hbm_bytes']:.4e}, bound {ms!r} ms ({by})")
    step = count_launches("9d device step", launches, lambda: (
        cost.measure_device_step(covers_d, MASTER_KEY, UHD_SECRET)))
    link = cost.measure_link(LINK_BYTES, reps=3, device=covers_d.device)
    share = {"embed": bound["embed_ms"] / (step["embed_s"] * 1e3),
             "extract": bound["extract_ms"] / (step["extract_s"] * 1e3),
             "round trip": bound["roundtrip_ms"]
             / (step["device_roundtrip_s"] * 1e3)}
    log(f"9d cost at 4K B={B} 16 KB ({card}; peaks {peaks['source']}): "
        f"embed {rep['embed_flops']:.4e} FLOPs {rep['embed_hbm_bytes']:.4e} "
        f"B, extract {rep['extract_flops']:.4e} FLOPs "
        f"{rep['extract_hbm_bytes']:.4e} B; bound embed "
        f"{bound['embed_ms']!r} ms, extract {bound['extract_ms']!r} ms, "
        f"round trip {bound['roundtrip_ms']!r} ms; measured cores (CUDA "
        f"events) embed {step['embed_s'] * 1e3!r} ms, extract "
        f"{step['extract_s'] * 1e3!r} ms; share of the bound {share}; "
        f"phase 4's warm round trip {sum(ms4)!r} ms is "
        f"{bound['roundtrip_ms'] / sum(ms4):.3f} of it; link "
        f"{LINK_BYTES >> 20} MiB pinned: up "
        f"{link['up_bytes_per_sec'] / 1e9!r} GB/s, down "
        f"{link['down_bytes_per_sec'] / 1e9!r} GB/s; link bytes per image "
        f"{rep['link_bytes_per_image']}, ingest bytes per image "
        f"{rep['ingest_bytes_per_image']}")
    if any(v > 1.0 for v in share.values()):
        raise AssertionError(f"9d: a share of the bound above 1.0 is a "
                             f"counting fault: {share}")
    pl, yy, xx, _, Ky, Kx, _ = _read_walk(covers_d.device, H, W, UHD_SECRET)
    sectors = cost.walk_sectors(pl, yy, xx, Ky, Kx)
    walk = sectors / (3 * Ky * Kx / 8)
    uniform = cost.sector_share(pl.shape[0], Ky, Kx)
    off = abs(walk / uniform - 1.0)
    log(f"9d cost read + decode: the main path's {pl.shape[0]}-slot walk "
        f"touches {sectors} of {3 * Ky * Kx // 8} 32-byte sectors of a "
        f"plane, a share of {walk!r}, against the uniform walk's "
        f"{uniform!r} that the model counts ({walk / uniform:.4f}x"
        + ("; they differ by more than 5%)" if off > 0.05 else ")"))


# 9e: the graft entry (steganosaurus_tpu_torch/graft_entry.py): entry()'s
# forward step on the card against the same function on the CPU, +-1 on at
# most this share of the u8 bytes (cuFFT and the CPU's FFT sum in other
# orders, so a few pixels land on the other side of .5)
ENTRY_DIFF_FRAC = 5e-3


def phase_dryrun(launches: dict) -> None:
    """9e: the graft entry on the card. entry()'s forward step (the
    full-grid embed core, torch.fft: no kernel of the port) against the
    same function on the CPU, u8 bytes +-1 on at most ENTRY_DIFF_FRAC
    (counted); dryrun_multichip(MESH_LOGICAL) on logical shards of card 0;
    dryrun_multichip(min(8, cards)) over make_mesh() when the machine has
    at least 2 cards. Each part's wall time and its K1, K3, K4 and K4e
    launches are logged; each dry run must launch K1 on the TMA route,
    K3's write_floor (the shared-walk embeds) and floor_only (QIM on
    per-image walks, axes 1b and 1c), and K4 once per corner embed (K4e
    never)."""
    import numpy as np
    import torch

    from steganosaurus_tpu_torch import graft_entry
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    def step(device=None):
        fn, args = graft_entry.entry(device)
        return fn(*args).cpu().numpy()

    for what in ("cold", "warm"):
        t = time.perf_counter()
        out = count_no_launches(f"9e entry {what}", launches, step)
        log(f"9e entry() {what}: {out.shape} {out.dtype} in "
            f"{time.perf_counter() - t!r} s (host wall, ends in a pull)")
    ref = step("cpu")
    diff = out.astype(np.int16) - ref.astype(np.int16)
    n_diff = int(np.count_nonzero(diff))
    log(f"9e entry() on the card vs the CPU: {n_diff} of {diff.size} u8 "
        f"bytes differ, max |diff| {int(np.abs(diff).max())}")
    if np.abs(diff).max() > 1 or n_diff > ENTRY_DIFF_FRAC * diff.size:
        raise AssertionError("9e: entry() on the card disagrees with the "
                             "CPU beyond +-1 rounding")
    runs = [(f"9e dry run, {MESH_LOGICAL} logical shards",
             lambda: graft_entry.dryrun_multichip(MESH_LOGICAL,
                                                  device="cuda:0"))]
    cards = min(8, torch.cuda.device_count())
    if cards >= 2:
        runs.append((f"9e dry run, {cards} cards",
                     lambda: graft_entry.dryrun_multichip(cards)))
    for path, run in runs:
        t = time.perf_counter()
        report = count_launches(path, launches, run)
        wall = time.perf_counter() - t
        c = launches[path]
        log(f"{path}: {wall!r} s; {report}; K1 {c[ck.KERNEL_TMA]}, K3 "
            f"write_floor {c[wk.KERNEL_WRITE_FLOOR]} (two-pass "
            f"{c[wk.KERNEL_WRITE_FLOOR_TWO_PASS]}), floor_only "
            f"{c[wk.KERNEL_FLOOR_ONLY]}, K4 {c[wk.KERNEL_IFFT_EPILOGUE]}, "
            f"K4e {c[wk.KERNEL_EPILOGUE]}")
        if not (c[wk.KERNEL_WRITE_FLOOR] > 0 and c[wk.KERNEL_FLOOR_ONLY] > 0
                and c[wk.KERNEL_IFFT_EPILOGUE] == c[wk.KERNEL_WRITE_FLOOR]
                + c[wk.KERNEL_FLOOR_ONLY] and c[wk.KERNEL_EPILOGUE] == 0
                and c[wk.KERNEL_WRITE_FLOOR_TWO_PASS] == 0):
            raise AssertionError(f"{path}: K3 / K4 / K4e launches {c}")


def record_k1_shapes(seen: set):
    """Wrap the stage-1 wrapper so that the _k1_key of every call on the
    card, the route it launched included, lands in `seen`; returns the
    function that undoes it. The wrapped call is the wrapper itself, so
    launches are counted as before."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    real = ck.fwd_stage1

    def recorded(imgs_u8, exr_bf16, exi_bf16, center, tables=None,
                 prep=None):
        if imgs_u8.is_cuda:
            seen.add(_k1_key(imgs_u8, exr_bf16.shape[0], center, prep))
        return real(imgs_u8, exr_bf16, exi_bf16, center, tables, prep)

    ck.fwd_stage1 = recorded
    return lambda: setattr(ck, "fwd_stage1", real)


def phase_k1_shapes(dev, seen: set, checked: set) -> None:
    """6: each (planes, H, W, Kx, center, route, prep) that the paths gave
    the stage-1 wrapper and phase 3 did not check, held against the plain
    version through the wrapper on seeded u8 images on the same route (the
    load route at W % 16 == 0 on a view whose base is not 16-byte
    aligned), with the tables the path builds for it; with the prep in
    K1's epilogue also its copies against .to(bf16) and its energies
    against stage1_energy_plain, bit for bit."""
    import numpy as np
    import torch

    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(6)
    todo = sorted((k for k in seen if k not in checked), key=repr)
    log(f"K1 shapes the paths gave the wrapper: {len(seen)}, of which "
        f"{len(seen) - len(todo)} checked in phase 3: "
        f"{sorted(seen, key=repr)}")
    for key in todo:
        P, H, W, Kx, center, route, prep = key
        offset = 1 if route == ck.KERNEL_LDG and W % 16 == 0 else 0
        x = _offset_u8(rng, (P, H, W), dev, offset)
        if ck.route_for(W, x.data_ptr()) != route:
            raise AssertionError(f"{key}: the check would not take {route}")
        er, ei = (torch.from_numpy(t).to(dev).to(torch.bfloat16)
                  for t in corner._dft_tables(W, Kx))
        out = ck.fwd_stage1(x, er, ei, center, None, prep)
        _k1_check(f"{route} path shape {key}", out[:2],
                  ck.fwd_stage1_plain(x, er, ei, center))
        if prep is not None:
            ar16, ai16, energy = out[2]
            ok = (torch.equal(ar16, out[0].to(torch.bfloat16))
                  and torch.equal(ai16, out[1].to(torch.bfloat16))
                  and (energy is None) == (prep == "copies")
                  and (energy is None or torch.equal(
                      energy, ck.stage1_energy_plain(out[0], out[1]))))
            if not ok:
                raise AssertionError(f"{key}: K1's prep disagrees with its "
                                     f"plain version")
        del x, out
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
        k3 = timed("K3 and K4e", phase_write_kernels, covers_d, odd_d, card)
        torch.cuda.empty_cache()
        k3 += timed("K4", phase_ifft_epilogue, covers_d, odd_d, card)
        torch.cuda.empty_cache()
        k3 += timed("K2", phase_stage2, covers_d, odd_d, card)
        torch.cuda.empty_cache()
        k3 += timed("K6", phase_ifft_y, covers_d, odd_d, card)
        torch.cuda.empty_cache()
        k3 += timed("K5", phase_read_decode, covers_d, card)
        torch.cuda.empty_cache()
        launches: dict = {}
        seen: set = set()
        undo = record_k1_shapes(seen)
        try:
            count_launches("small", launches, lambda: phase_small(dev))
            launches["round trip"], ms4, stego4 = phase_uhd(covers_d)
            torch.cuda.synchronize()
            timed("ragged grid", phase_ragged_grid, dev, launches)
            timed("highest", phase_highest, dev, launches)
            timed("4e precision modes", phase_precision_modes, covers_d, dev,
                  launches, card)
            launches["4c round trip"], ms4c, _ = timed(
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
            timed("9a mesh of the cards", phase_mesh_cards, covers_d, stego4,
                  ms4, launches)
            timed("9b mesh of logical shards", phase_mesh_logical, covers_d,
                  stego4, ms4, launches)
            del stego4
            torch.cuda.empty_cache()
            timed("9c fft_dist", phase_fft_dist, covers_d, launches)
            timed("9d cost", phase_cost, covers_d, ms4, launches, card)
            timed("9e dry run", phase_dryrun, launches)
            del covers_d
            torch.cuda.empty_cache()
            timed("serve", phase_serve, launches, card)
            torch.cuda.empty_cache()
            timed("serve worker", phase_serve_worker, card)
            timed("cli", phase_cli, card)
        finally:
            undo()
        log(f"kernel launches per path: {launches}")
        check_epilogues(launches)
        check_stage2(launches)
        timed("K1 shapes", phase_k1_shapes, dev, seen, checked)
        for k in k1 + k3:
            k["launches"] = sum(n[k["name"]] for n in launches.values())
            if not k["launches"]:
                raise AssertionError(f"{k['name']} was launched on no "
                                     f"counted path")
        log(f"smoke wall time {time.perf_counter() - t_all:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in k1 + k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
