"""The embed's dense corner write, write floor (K3), the inverse DFT's
y-stage (K6) and x-stage with the u8 epilogue (K4), and the u8 epilogue
alone (K4e): the hand-written Hopper kernels and their plain PyTorch
versions.

XLA fuses these stages of steganosaurus_tpu/parallel/batch.py:
corner_embed_core for the TPU; run as eager torch they are some forty
launches, each a pass over the (B, 3, Ky, Kx) corner or the (B, 3, H, W)
image batch through HBM. Four CUDA sources replace them:

- csrc/corner_write_floor.cu (K3), two entry points:
  - write_floor: each corner bin's frame bit through the int32 slot map
    `pos`, the hard or soft write (corner.write_delta, jitter and amplitude
    maps optional) and, with a floor, the per-image boost
    (corner.apply_write_floor), in one call. Its output is the f32 delta,
    or (ifft_operands=True) the inverse DFT's bf16 operands bf16(Re D),
    bf16(-Im D), which corner.ifft_corner_real(..., conjugated=True) takes
    as they are. With a floor it runs the resident schedule (one
    cooperative launch that reads the spectrum from HBM once, keeping each
    block's slice in shared memory across a per-image grid barrier) where
    the corner fits on the card, else the two-pass schedule, counted apart
    under KERNEL_WRITE_FLOOR_TWO_PASS;
  - floor_only: the floor over a delta made elsewhere (the QIM write and
    the per-image-walk scatter, whose writes stay eager torch).
- csrc/corner_ifft_y.cu (K6), ifft_y: the y-stage of
  corner.ifft_corner_real, M = Ey^T @ Dc, as one bf16 wgmma GEMM per plane
  of the real table [[eyr^T, -eyi^T], [eyi^T, eyr^T]] (corner.ifft_y_table)
  with K3's bf16 operands [Re D; -Im D], its f32 sums rounded to bf16 in
  registers: the (P*H, Kx) bf16 mr16, mi16 that K4 reads, with no f32
  product through HBM. corner.ifft_corner_y runs it.
- csrc/corner_ifft_epilogue.cu (K4), ifft_epilogue: the x-stage of
  corner.ifft_corner_real as one bf16 wgmma GEMM of the y-stage's bf16
  output [mr, mi] (corner.ifft_corner_y) with the table [exr16; -exi16]
  (corner.ifft_x_table), and K4e's epilogue applied to its accumulators in
  registers, so the f32 (B, 3, H, W) product never reaches HBM. The embed
  cores run it wherever the inverse's x-stage is bf16 (corner.precision()).
- csrc/corner_epilogue.cu (K4e), epilogue: the unscaled inverse DFT t ->
  t * f32(1/(H*W)), the centering sign, + planes, floor(x + 0.5), the clamp
  to [0, 255], u8, stored NCHW or NHWC. The embed cores run it after the
  f32 inverse DFT, wherever the inverse's x-stage is f32 (mix_conservative,
  high, highest).

Each wrapper launches its kernel for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes its plain
version only for CPU tensors. K3's plain versions sum the floor's terms with
torch.sum (the CPU path's); with ordered=True (the ordered twins) they sum
in the kernel's fixed order (ordered_sum), and the kernel equals them bit
for bit. `LAUNCHES` counts each entry point's launches
under its own name, one per call that launches, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from steganosaurus_tpu_torch import spectral
from steganosaurus_tpu_torch.spectral import corner, corner_kernels
from steganosaurus_tpu_torch.spectral.corner_kernels import (_check_rc,
                                                              _device, _need)

KERNEL_WRITE_FLOOR = "corner_write_floor"
# the write_floor launches (also counted under KERNEL_WRITE_FLOOR) whose
# floor took the two-pass schedule
KERNEL_WRITE_FLOOR_TWO_PASS = "corner_write_floor_two_pass"
KERNEL_FLOOR_ONLY = "corner_floor_only"
KERNEL_EPILOGUE = "corner_epilogue"
KERNEL_IFFT_EPILOGUE = "corner_ifft_epilogue"
KERNEL_IFFT_Y = "corner_ifft_y"
# the ifft_y launches (also counted under KERNEL_IFFT_Y) whose operands
# went through a staging copy with rows padded to 16 bytes
KERNEL_IFFT_Y_PADDED = "corner_ifft_y_padded"
LAUNCHES = {KERNEL_WRITE_FLOOR: 0, KERNEL_WRITE_FLOOR_TWO_PASS: 0,
            KERNEL_FLOOR_ONLY: 0, KERNEL_EPILOGUE: 0,
            KERNEL_IFFT_EPILOGUE: 0, KERNEL_IFFT_Y: 0,
            KERNEL_IFFT_Y_PADDED: 0}
LAYOUTS = ("nchw", "nhwc")
# K3's reduction: a group of THREADS threads sums a chunk of CHUNK bins of
# one image, each thread PER_THREAD bins k*THREADS apart in order
THREADS, PER_THREAD = 256, 16
CHUNK = THREADS * PER_THREAD
SCHEDULES = ("resident", "two_pass")
# the resident schedule's phases, as _write_floor's phase_ns counts them
PHASES = ("pass 1 waiting for its data", "pass 1", "grid barrier", "boost",
          "apply")


# the most stream words the resident schedule keeps for a Rep frame
# (csrc/corner_write_floor.cu STREAM_WORDS_MAX: a 4K corner's whole bucket)
STREAM_WORDS_MAX = 4352


class RepFrame(NamedTuple):
    """An equal-length Rep-3/Rep-7 ECC frame kept as its stream: words (B,
    ceil(stream_bytes/4)) int32, the big-endian words of header||ct||tag.
    K3's resident schedule reads each walk slot's bit from these words
    (header bit slot/3 below slot 912, else payload bit 304 + (slot -
    912)/7, the last bit past the frame) in place of gathering it from the
    (B, bucket) u8 frame that bits() makes (parallel/batch.py
    _frame_from_words)."""
    words: torch.Tensor
    stream_bytes: int
    bucket: int

    def bits(self) -> torch.Tensor:
        from steganosaurus_tpu_torch.parallel import batch

        return batch._frame_from_words(self.words, self.stream_bytes,
                                       self.bucket)


def frame_bits(frame) -> torch.Tensor:
    """The (B, bucket) u8 frame bits of a u8 frame or a RepFrame."""
    return frame.bits() if isinstance(frame, RepFrame) else frame


# --- plain versions ----------------------------------------------------------

def bit_signs(pos: torch.Tensor, frame: torch.Tensor):
    """(sign, mask) of a shared walk's corner: each bin's frame bit through
    `pos` as a +-1 sign (B, 3, Ky, Kx), and mask (3, Ky, Kx) 1.0 where a walk
    bin lives (pos < bucket). The sentinel slot `bucket` reads bit 0."""
    B, bucket = frame.shape
    table = torch.cat([frame, frame.new_zeros((B, 1))], dim=1)
    bit = table[:, pos.reshape(-1)].reshape(B, *pos.shape)
    sign = bit.to(torch.float32) * 2.0 - 1.0
    mask = (pos < bucket).to(torch.float32)
    return sign, mask


def write_floor_plain(cr, ci, pos, frame, cos_a, sin_a, cjd=None, sjd=None,
                      *, floor: float, img_pixels: float, soft: bool = False,
                      ordered: bool = False):
    """(dr, di, b): the bit lookup, corner.write_delta and, when `floor`,
    corner.apply_write_floor; b (B,) f32 is the floor's boost (None without
    a floor). frame: (B, bucket) u8 or a RepFrame. ordered: the floor's sums
    in K3's order (ordered_sum; the ordered twin) in place of torch.sum."""
    sign, mask = bit_signs(pos, frame_bits(frame))
    dr, di = corner.write_delta(cr, ci, sign, mask, cos_a, sin_a, cjd, sjd,
                                soft=soft)
    del sign, mask
    if not floor:
        return dr, di, None
    return floor_only_plain(dr, di, cr, ci, floor=floor,
                            img_pixels=img_pixels, ordered=ordered)


def ifft_operands_of(dr, di):
    """(bf16(dr), bf16(-di)): the inverse DFT's operands, rounded to
    nearest even as corner.ifft_corner_real's _mm_bf16 rounds the f32
    delta it is given."""
    return dr.to(torch.bfloat16), (-di).to(torch.bfloat16)


def floor_only_plain(dr, di, cr, ci, *, floor: float, img_pixels: float,
                     ordered: bool = False):
    """(dr_b, di_b, b): corner.apply_write_floor over (dr, di), and its
    per-image boost b (B,) f32. ordered: the sums in K3's order (the
    ordered twin, which the kernel equals bit for bit) in place of
    torch.sum."""
    br, bi, b = corner.write_floor_boosted(
        dr, di, cr, ci, floor, img_pixels,
        _image_sums if ordered else None)
    return br, bi, b.reshape(-1)


def _group_sum(v):
    """K3's sum over a group of THREADS threads, of v (..., THREADS) f32
    (each thread's value): per warp of 32 lanes the __shfl_down_sync tree
    (offsets 16, 8, 4, 2, 1; lane 0's sum needs only the lanes below each
    offset), then the THREADS/32 warp sums added in order."""
    w = v.reshape(*v.shape[:-1], THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    s = w[..., 0, 0]
    for k in range(1, THREADS // 32):
        s = s + w[..., k, 0]
    return s


def ordered_sum(terms):
    """The sum over the last axis of terms (B, N) f32 in K3's order, every
    step in f32 (csrc/corner_write_floor.cu, both schedules): pass 1, thread
    t of chunk k adds bins k*CHUNK + j*THREADS + t for j in order from 0,
    then _group_sum gives the chunk's partial; pass 2, thread t adds the
    partials t, t + THREADS, ... in order from 0, then _group_sum. -> (B,).
    Bins past N add +0, as the kernel's skipped bins do."""
    B, N = terms.shape
    nblk = -(-N // CHUNK)
    x = torch.nn.functional.pad(terms, (0, nblk * CHUNK - N))
    x = x.reshape(B, nblk, PER_THREAD, THREADS)
    acc = terms.new_zeros((B, nblk, THREADS))
    for j in range(PER_THREAD):
        acc = acc + x[:, :, j]
    rounds = -(-nblk // THREADS)
    p = torch.nn.functional.pad(_group_sum(acc), (0, rounds * THREADS - nblk))
    p = p.reshape(B, rounds, THREADS)
    acc = terms.new_zeros((B, THREADS))
    for r in range(rounds):
        acc = acc + p[:, r]
    return _group_sum(acc)


def _image_sums(t):
    """ordered_sum of each image's terms t (B, 3, Ky, Kx) -> (B, 1, 1, 1)."""
    return ordered_sum(t.reshape(t.shape[0], -1)).reshape(-1, 1, 1, 1)


def epilogue_plain(t, planes, center: bool, layout: str):
    """u8 stego in `layout` from t (B, 3, H, W) f32, the inverse corner DFT
    before its 1/(H*W) scale, and the u8 cover planes (B, 3, H, W): t scaled,
    centered, planes + t -> floor(x + 0.5) clamped to [0, 255] (round half
    away from zero on the surviving range, as the reference; torch.round
    would round half to even). t is left as it was."""
    H, W = t.shape[-2:]
    out = spectral.apply_center(t * (1.0 / (H * W)), center)
    out = out.add_(planes).add_(0.5).floor_().clamp_(0.0, 255.0)
    out = out.to(torch.uint8)
    if layout != "nchw":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


def ifft_epilogue_plain(mr16, mi16, tabs, planes, center: bool,
                        layout: str, values: bool = False):
    """The x-stage of corner.ifft_corner_real under mix_adaptive, then
    epilogue_plain: t = mr16 @ exr16 - mi16 @ exi16 (bf16 operands, f32
    products, then their difference), the eager composition K4 replaces.
    mr16/mi16: (P*H, Kx) bf16 (corner.ifft_corner_y), planes (B, 3, H, W)
    u8 with P = 3B. values=True returns the f32 value before + planes and
    the rounding, apply_center(t * (1/(H*W))) (B, 3, H, W), in place of the
    u8 stego."""
    B, _, H, W = planes.shape
    Kx = mr16.shape[-1]
    t = corner._mm_bf16(mr16.reshape(3 * B, H, Kx), tabs.exr16)
    t -= corner._mm_bf16(mi16.reshape(3 * B, H, Kx), tabs.exi16)
    t = t.reshape(B, 3, H, W)
    if values:
        return spectral.apply_center(t * (1.0 / (H * W)), center)
    return epilogue_plain(t, planes, center, layout)


def ifft_y_plain(dcr16, dci16, tabs, values: bool = False):
    """The inverse DFT's y-stage under mix_adaptive as the eager chain K6
    replaces (corner._ifft_y: four bf16 products into f32, a difference, a
    sum), then the casts: (mr16, mi16), each (P*H, Kx) bf16, from the
    conjugated delta dcr16 = bf16(Re D), dci16 = bf16(-Im D) (..., Ky, Kx)
    with P the planes. values=True returns the f32 (mr, mi) (P*H, Kx)
    before the casts."""
    Kx = dcr16.shape[-1]
    mr, mi = corner._ifft_y(dcr16, dci16, tabs, "mix_adaptive", True)
    P, H, _ = mr.shape
    if values:
        return mr.reshape(P * H, Kx), mi.reshape(P * H, Kx)
    mr16 = mr.to(torch.bfloat16).reshape(P * H, Kx)
    del mr
    return mr16, mi.to(torch.bfloat16).reshape(P * H, Kx)


def ifft_y_error(mr, mi, dcr16, dci16, tabs, planes: int = 24) -> float:
    """The RMS, over the first `planes` planes, of the error of the y-stage
    sums mr, mi (P*H, Kx) f32 (ifft_y's or ifft_y_plain's values=True)
    against the exact (f64) sum of the same bf16 products eyr16^T . dcr16
    - eyi16^T . dci16 and eyr16^T . dci16 + eyi16^T . dcr16, (P, Ky, Kx)
    operands: the error of the sum order alone, in the delta's units."""
    n = min(planes, dcr16.reshape(-1, *dcr16.shape[-2:]).shape[0])
    Ky, Kx = dcr16.shape[-2:]
    H = tabs.eyr16.shape[1]
    eyr, eyi = tabs.eyr16.double().T, tabs.eyi16.double().T
    a = dcr16.reshape(-1, Ky, Kx)[:n].double()
    b = dci16.reshape(-1, Ky, Kx)[:n].double()
    sq = 0.0
    for m, exact in ((mr, eyr @ a - eyi @ b), (mi, eyr @ b + eyi @ a)):
        sq += (m[:n * H].double().reshape(n, H, Kx) - exact).pow(2).sum() \
            .item()
    return (sq / (2 * n * H * Kx)) ** 0.5


def bf16_steps(a, b) -> torch.Tensor:
    """How many bf16 values lie between a and b (bf16 tensors of one
    shape), as int32: 0 where they are equal, 1 where they are neighbours
    (one ulp apart), counted along the ordered line of bf16 values on which
    +0 and -0 are one point."""
    def line(t):
        i = t.view(torch.int16).to(torch.int32)
        mag = i & 0x7FFF
        return torch.where(i < 0, -mag, mag)

    return (line(a) - line(b)).abs()


def bf16_compare(got, want, want_f32, tol: float) -> dict:
    """How K6's bf16 output `got` stands to the plain version's `want`,
    the round-to-nearest-even casts of the plain f32 sums `want_f32`, when
    K6's own f32 sums lie within `tol` of those: the counts of elements
    "equal", "one ulp" apart (bf16_steps 1), further apart but "within the
    f32 bound" (|got - want| <= tol + one ulp of the larger: an element
    whose ulp is below tol, where two roundings of sums tol apart may lie
    several ulps apart), and "other" (none, for a kernel that rounds its
    sums to nearest even)."""
    steps = bf16_steps(got, want)
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    near = (got.float() - want.float()).abs() <= tol + ulp
    del big, ulp
    n = {"equal": int((steps == 0).sum().item()),
         "one ulp": int((steps == 1).sum().item()),
         "within the f32 bound": int(((steps > 1) & near).sum().item())}
    n["other"] = got.numel() - sum(n.values())
    return n


# --- the wrappers ------------------------------------------------------------

def _floor_scalars(floor: float, img_pixels: float):
    """(0.5*s, s, E*) in f32 as apply_write_floor rounds them: s =
    f32(1/img_pixels), E* = f32(1.5*floor^2)."""
    s = np.float32(1.0 / img_pixels)
    return float(np.float32(0.5) * s), float(s), float(np.float32(
        1.5 * floor ** 2))


def _scratch(B: int, N: int, dev):
    nblk = -(-N // CHUNK)
    return (nblk, torch.empty((B, nblk, 3), dtype=torch.float32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


_GRIDS: dict = {}


def _resident_grid(N: int, bf16: bool, device) -> int:
    """The resident schedule's grid for a corner of N bins on `device`
    (from the kernel's occupancy), 0 where it does not fit; cached."""
    key = (device.index, N, bf16)
    if key not in _GRIDS:
        from steganosaurus_tpu_torch import _build

        with torch.cuda.device(device):
            grid = _build.kernel_library().corner_write_floor_grid(
                N, int(bf16))
        _check_rc(KERNEL_WRITE_FLOOR, -min(grid, 0))
        _GRIDS[key] = grid
    return _GRIDS[key]


def resident_fits(N: int, grid: int, tensors) -> bool:
    """Whether the resident schedule takes a corner of N bins: its grid fits
    on the card (grid > 0), each image's row is whole 16-byte words (N a
    multiple of 4: the bulk copies and the four-bin stores) and the
    spectrum's tensors start on 16 bytes."""
    return grid > 0 and N % 4 == 0 and all(t.data_ptr() % 16 == 0
                                           for t in tensors)


def write_floor(cr, ci, pos, frame, cos_a, sin_a, cjd=None, sjd=None, *,
                floor: float, img_pixels: float, soft: bool = False,
                ifft_operands: bool = False):
    """(dr, di, b): the dense corner write of a shared walk and, when
    `floor`, its write floor. cr/ci: (B, 3, Ky, Kx) f32 corner spectrum;
    pos: (3, Ky, Kx) int32 slot map (`bucket` where no walk bin lives);
    frame: (B, bucket) u8 frame bits, or a RepFrame (the resident schedule
    reads its stream words; the others take its bits()); cos_a/sin_a:
    cos/sin(alpha) as f32 0-dim host tensors, or (3, Ky, Kx) amplitude maps
    (Params.alpha_spread);
    cjd/sjd: (3, Ky, Kx) jitter maps or None. b: (B,) f32, the floor's
    per-image boost (None without a floor). ifft_operands: return
    (bf16(dr), bf16(-di)), the inverse DFT's operands (ifft_operands_of),
    in place of the f32 (dr, di). CUDA tensors launch
    csrc/corner_write_floor.cu on the current stream; CPU tensors take
    write_floor_plain."""
    return _write_floor(cr, ci, pos, frame, cos_a, sin_a, cjd, sjd,
                        floor=floor, img_pixels=img_pixels, soft=soft,
                        ifft_operands=ifft_operands)


def _write_floor(cr, ci, pos, frame, cos_a, sin_a, cjd=None, sjd=None, *,
                 floor: float, img_pixels: float, soft: bool = False,
                 ifft_operands: bool = False, schedule: str | None = None,
                 phase_ns=None):
    """write_floor, with the schedule of a CUDA launch with a floor chosen
    by shape (None) or forced ("resident" raises where it does not fit),
    and phase_ns: None, or a zeroed (grid, len(PHASES)) int64 CUDA tensor
    to which each block of the resident schedule adds its ns (its thread
    0's clock) in each of PHASES, summed over the images (the smoke's
    checks and timing)."""
    name = KERNEL_WRITE_FLOOR
    maps = isinstance(cos_a, torch.Tensor) and cos_a.dim() > 0
    kind = _device(name, cr, (ci, pos, frame, cjd, sjd, cos_a, sin_a))
    if kind == "cpu":
        dr, di, b = write_floor_plain(cr, ci, pos, frame, cos_a, sin_a, cjd,
                                      sjd, floor=floor,
                                      img_pixels=img_pixels, soft=soft)
        if ifft_operands:
            dr, di = ifft_operands_of(dr, di)
        return dr, di, b
    if cr.dim() != 4 or cr.shape[1] != 3:
        raise ValueError(f"{name}: the spectrum must be (B, 3, Ky, Kx), got "
                         f"{tuple(cr.shape)}")
    B, _, Ky, Kx = cr.shape
    _need(name, "cr", cr, torch.float32, cr.shape)
    _need(name, "ci", ci, torch.float32, cr.shape)
    _need(name, "pos", pos, torch.int32, (3, Ky, Kx))
    rep = isinstance(frame, RepFrame)
    if rep:
        rep_bytes = frame.stream_bytes
        nwords = -(-rep_bytes // 4)
        _need(name, "the stream words", frame.words, torch.int32,
              (B, nwords))
        bucket = frame.bucket
        _device(name, cr, (frame.words,))
    else:
        if frame.dim() != 2 or frame.shape[0] != B or frame.shape[1] < 1:
            raise ValueError(f"{name}: frame must be (B={B}, bucket), got "
                             f"{tuple(frame.shape)}")
        _need(name, "frame", frame, torch.uint8, frame.shape)
        bucket = frame.shape[1]
    if (cjd is None) != (sjd is None):
        raise ValueError(f"{name}: give both jitter maps or neither")
    for what, m in (("cjd", cjd), ("sjd", sjd)) + (
            (("cos_a", cos_a), ("sin_a", sin_a)) if maps else ()):
        if m is not None:
            _need(name, what, m, torch.float32, (3, Ky, Kx))
    if maps and not (isinstance(sin_a, torch.Tensor)
                     and sin_a.shape == cos_a.shape):
        raise ValueError(f"{name}: cos_a and sin_a must both be maps")
    if schedule not in (None,) + SCHEDULES:
        raise ValueError(f"{name}: schedule must be one of {SCHEDULES}")
    ca, sa = (0.0, 0.0) if maps else (float(cos_a), float(sin_a))
    N = 3 * Ky * Kx
    grid = _resident_grid(N, ifft_operands, cr.device) if floor else 0
    fits = resident_fits(N, grid, (cr, ci))
    if schedule == "resident" and not fits:
        raise ValueError(f"{name}: the resident schedule does not take this "
                         f"corner ({tuple(cr.shape)}, floor {floor})")
    resident = fits and schedule != "two_pass"
    words = None
    if rep and resident and nwords <= STREAM_WORDS_MAX:
        words, frame = frame.words, None
    elif rep:
        frame = frame.bits()
    dt = torch.bfloat16 if ifft_operands else torch.float32
    dr = torch.empty(cr.shape, dtype=dt, device=cr.device)
    di = torch.empty(cr.shape, dtype=dt, device=cr.device)
    nblk, partials, boost = _scratch(B, N, cr.device)
    arrive = (torch.zeros((1,), dtype=torch.int32, device=cr.device)
              if resident else None)
    if phase_ns is not None and resident:
        _need(name, "phase_ns", phase_ns, torch.int64, (grid, len(PHASES)))
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(cr.device):
        stream = torch.cuda.current_stream(cr.device).cuda_stream
        rc = _build.kernel_library().corner_write_floor(
            cr.data_ptr(), ci.data_ptr(), pos.data_ptr(), _ptr(frame),
            _ptr(words), _ptr(cjd), _ptr(sjd), _ptr(cos_a if maps else None),
            _ptr(sin_a if maps else None), dr.data_ptr(), di.data_ptr(),
            partials.data_ptr(), boost.data_ptr(), _ptr(arrive),
            _ptr(phase_ns if resident else None), B, N, nblk, bucket,
            0 if words is None else words.shape[1],
            0 if words is None else rep_bytes, ca, sa, int(bool(soft)),
            *_floor_scalars(floor, img_pixels), int(bool(floor)),
            int(bool(ifft_operands)), int(resident), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    if floor and not resident:
        LAUNCHES[KERNEL_WRITE_FLOOR_TWO_PASS] += 1
    return dr, di, (boost if floor else None)


def floor_only(dr, di, cr, ci, *, floor: float, img_pixels: float):
    """(dr_b, di_b, b): the write floor over a given delta (dr, di) beside
    the spectrum (cr, ci), all (B, 3, Ky, Kx) f32; b (B,) f32. CUDA tensors
    launch csrc/corner_write_floor.cu's floor pass on the current stream;
    CPU tensors take floor_only_plain."""
    name = KERNEL_FLOOR_ONLY
    kind = _device(name, cr, (ci, dr, di))
    if kind == "cpu":
        return floor_only_plain(dr, di, cr, ci, floor=floor,
                                img_pixels=img_pixels)
    if cr.dim() != 4 or cr.shape[1] != 3:
        raise ValueError(f"{name}: the spectrum must be (B, 3, Ky, Kx), got "
                         f"{tuple(cr.shape)}")
    for what, t in (("dr", dr), ("di", di), ("cr", cr), ("ci", ci)):
        _need(name, what, t, torch.float32, cr.shape)
    B, _, Ky, Kx = cr.shape
    N = 3 * Ky * Kx
    out_r = torch.empty_like(dr)
    out_i = torch.empty_like(di)
    nblk, partials, boost = _scratch(B, N, cr.device)
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(cr.device):
        stream = torch.cuda.current_stream(cr.device).cuda_stream
        rc = _build.kernel_library().corner_floor_only(
            dr.data_ptr(), di.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), partials.data_ptr(),
            boost.data_ptr(), B, N, nblk,
            *_floor_scalars(floor, img_pixels), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return out_r, out_i, boost


def epilogue(t, planes, center: bool, layout: str):
    """u8 stego from t (B, 3, H, W) f32 — the inverse corner DFT before its
    1/(H*W) scale (corner.ifft_corner_real(..., scale=False)) — and the u8
    cover planes (B, 3, H, W): (B, 3, H, W) for layout "nchw", else
    (B, H, W, 3). CUDA tensors launch csrc/corner_epilogue.cu on the current
    stream; CPU tensors take epilogue_plain."""
    name = KERNEL_EPILOGUE
    kind = _device(name, t, (planes,))
    if kind == "cpu":
        return epilogue_plain(t, planes, center, layout)
    if t.dim() != 4 or t.shape[1] != 3:
        raise ValueError(f"{name}: t must be (B, 3, H, W), got "
                         f"{tuple(t.shape)}")
    _need(name, "t", t, torch.float32, t.shape)
    _need(name, "planes", planes, torch.uint8, t.shape)
    B, _, H, W = t.shape
    shape = (B, 3, H, W) if layout == "nchw" else (B, H, W, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=t.device)
    if out.numel() == 0:
        return out
    inv = float(np.float32(1.0 / (H * W)))
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _build.kernel_library().corner_epilogue(
            t.data_ptr(), planes.data_ptr(), out.data_ptr(), B, H, W, inv,
            int(bool(center)), int(layout != "nchw"), stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return out


def ifft_epilogue(mr16, mi16, tabs, planes, center: bool, layout: str, *,
                  values: bool = False):
    """The u8 stego from the inverse DFT's y-stage output: the x-stage
    mr16 @ exr16 - mi16 @ exi16 and the u8 epilogue of `epilogue`, in one
    function. mr16/mi16: (P*H, Kx) bf16 (corner.ifft_corner_y), P = 3B;
    tabs: the grid's corner.Tables (exr16/exi16 (Kx, W); on CUDA its
    ifft_x table); planes: (B, 3, H, W) u8 covers. Returns (B, 3, H, W) u8
    for layout "nchw", (B, H, W, 3) for "nhwc"; values=True (the check
    mode) the f32 (B, 3, H, W) value before + planes and the rounding. CUDA
    tensors launch csrc/corner_ifft_epilogue.cu (K4) on the current stream;
    CPU tensors take ifft_epilogue_plain."""
    name = KERNEL_IFFT_EPILOGUE
    kind = _device(name, mr16, (mi16, planes, tabs.exr16, tabs.exi16))
    if layout not in LAYOUTS:
        raise ValueError(f"{name}: layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")
    if planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"{name}: planes must be (B, 3, H, W), got "
                         f"{tuple(planes.shape)}")
    B, _, H, W = planes.shape
    _need(name, "planes", planes, torch.uint8, planes.shape)
    if mr16.dim() != 2:
        raise ValueError(f"{name}: mr16 must be (P*H, Kx), got "
                         f"{tuple(mr16.shape)}")
    Kx = mr16.shape[1]
    _need(name, "mr16", mr16, torch.bfloat16, (3 * B * H, Kx))
    _need(name, "mi16", mi16, torch.bfloat16, (3 * B * H, Kx))
    for what, t in (("exr16", tabs.exr16), ("exi16", tabs.exi16)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (Kx, W):
            raise ValueError(f"{name}: {what} must be bf16 {(Kx, W)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if kind == "cpu":
        return ifft_epilogue_plain(mr16, mi16, tabs, planes, center, layout,
                                   values)
    Kxp, Wp = corner_kernels._pad64(Kx), corner_kernels._pad64(W)
    tab = tabs.ifft_x
    if tab is None:
        raise ValueError(f"{name}: the tables carry no K4 table")
    _need(name, "the K4 table", tab, torch.bfloat16, (Wp, 2 * Kxp))
    _device(name, mr16, (tab,))
    # TMA reads rows 16-byte aligned: a copy whose rows are padded with
    # zeros where the y-stage's are not (Kx % 8 != 0: grids below 256
    # columns, or an unaligned view)
    lda = -(-Kx // 8) * 8
    if lda != Kx or mr16.data_ptr() % 16 or mi16.data_ptr() % 16:
        mr16, mi16 = (torch.nn.functional.pad(a, (0, lda - Kx))
                      for a in (mr16, mi16))
    if values:
        out = torch.empty((B, 3, H, W), dtype=torch.float32,
                          device=planes.device)
    else:
        shape = (B, 3, H, W) if layout == "nchw" else (B, H, W, 3)
        out = torch.empty(shape, dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    inv = float(np.float32(1.0 / (H * W)))
    mode = 2 if values else int(layout != "nchw")
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = _build.kernel_library().corner_ifft_epilogue(
            mr16.data_ptr(), mi16.data_ptr(), tab.data_ptr(),
            planes.data_ptr(), out.data_ptr(), B, H, W, Kx, lda, Kxp, Wp,
            inv, int(bool(center)), mode, stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return out


def ifft_epilogue_grid(B: int, H: int, W: int, layout: str,
                       device=None) -> int:
    """The grid ifft_epilogue launches on `device` (default: the current
    card) for B images of H x W stored in `layout`: in blocks, 2-CTA
    clusters, as many as the card holds at once and no more than the
    kernel's units of work; raises where the card has no room for one."""
    from steganosaurus_tpu_torch import _build

    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    with torch.cuda.device(device):
        grid = _build.kernel_library().corner_ifft_epilogue_grid(
            B, H, W, int(layout != "nchw"))
    _check_rc(KERNEL_IFFT_EPILOGUE, -min(grid, 0))
    return grid


def ifft_y_rows(dcr, dci):
    """(dcr, dci, ldd, padded): K6's operands (P, Ky, Kx) bf16 as its TMA
    maps read them, rows ldd values apart (Kx rounded up to 8 values, 16
    bytes) from 16-byte-aligned bases: the operands themselves where they
    are so, else (padded) a staging copy whose rows end in zeros (Kx % 8 !=
    0: grids below 256 columns, or an unaligned view). The maps' x extent
    stays Kx, so the padding is never read."""
    Kx = dcr.shape[-1]
    ldd = -(-Kx // 8) * 8
    padded = bool(ldd != Kx or dcr.data_ptr() % 16 or dci.data_ptr() % 16)
    if padded:
        dcr, dci = (torch.nn.functional.pad(a, (0, ldd - Kx))
                    for a in (dcr, dci))
    return dcr, dci, ldd, padded


def ifft_y(dcr16, dci16, tabs, *, values: bool = False):
    """The inverse DFT's y-stage under mix_adaptive: (mr16, mi16), each
    (P*H, Kx) bf16 (the operands of ifft_epilogue), from the conjugated
    delta dcr16 = bf16(Re D), dci16 = bf16(-Im D), contiguous (..., Ky, Kx)
    bf16 with P planes (write_floor's ifft_operands, or ifft_operands_of),
    and the grid's corner.Tables (eyr16 (Ky, H); on CUDA its ifft_y table).
    values=True (the check mode) returns the f32 sums (P*H, Kx) before the
    rounding. CUDA tensors launch csrc/corner_ifft_y.cu (K6) on the current
    stream, operands whose rows are not whole 16-byte words (Kx % 8 != 0)
    or whose base is not 16-byte aligned through a staging copy with padded
    rows (counted under KERNEL_IFFT_Y_PADDED too); CPU tensors take
    ifft_y_plain."""
    name = KERNEL_IFFT_Y
    kind = _device(name, dcr16, (dci16, tabs.eyr16, tabs.eyi16))
    if dcr16.dim() < 2:
        raise ValueError(f"{name}: dcr16 must be (..., Ky, Kx), got "
                         f"{tuple(dcr16.shape)}")
    Ky, Kx = dcr16.shape[-2:]
    _need(name, "dcr16", dcr16, torch.bfloat16, dcr16.shape)
    _need(name, "dci16", dci16, torch.bfloat16, dcr16.shape)
    for what, t in (("eyr16", tabs.eyr16), ("eyi16", tabs.eyi16)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.shape[0] != Ky:
            raise ValueError(f"{name}: {what} must be bf16 (Ky={Ky}, H), got "
                             f"{t.dtype} {tuple(t.shape)}")
    H = tabs.eyr16.shape[1]
    if tuple(tabs.eyi16.shape) != (Ky, H):
        raise ValueError(f"{name}: eyi16 must be {(Ky, H)}, got "
                         f"{tuple(tabs.eyi16.shape)}")
    if kind == "cpu":
        return ifft_y_plain(dcr16, dci16, tabs, values)
    Hp, Kyp = corner_kernels._pad64(H), corner_kernels._pad64(Ky)
    tab = tabs.ifft_y
    if tab is None:
        raise ValueError(f"{name}: the tables carry no K6 table")
    _need(name, "the K6 table", tab, torch.bfloat16, (2 * Hp, 2 * Kyp))
    _device(name, dcr16, (tab,))
    dcr = dcr16.reshape(-1, Ky, Kx)
    dci = dci16.reshape(-1, Ky, Kx)
    P = dcr.shape[0]
    dt = torch.float32 if values else torch.bfloat16
    mr = torch.empty((P * H, Kx), dtype=dt, device=dcr.device)
    mi = torch.empty((P * H, Kx), dtype=dt, device=dcr.device)
    if mr.numel() == 0:
        return mr, mi
    dcr, dci, ldd, padded = ifft_y_rows(dcr, dci)
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(dcr.device):
        stream = torch.cuda.current_stream(dcr.device).cuda_stream
        rc = _build.kernel_library().corner_ifft_y(
            tab.data_ptr(), dcr.data_ptr(), dci.data_ptr(), mr.data_ptr(),
            mi.data_ptr(), P, H, Ky, Kx, Hp, Kyp, ldd, int(bool(values)),
            stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    if padded:
        LAUNCHES[KERNEL_IFFT_Y_PADDED] += 1
    return mr, mi
