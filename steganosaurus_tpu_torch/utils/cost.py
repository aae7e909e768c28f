"""Cost model of the batch round trip (the port's twin of
steganosaurus_tpu/utils/cost.py), counted from the shapes the port's cores
use.

The JAX package asks XLA's cost_analysis() of the lowered modules; eager
torch has no such module, so the round trip is counted stage by stage from
the shapes of parallel/batch.py's corner_embed_core and
corner_extract_fused_core: for each stage its real FLOPs by the precision
they run at (the matrix products on the bf16 tensor cores or in f32 on the
CUDA cores; the elementwise work in f32), and its HBM bytes, each input read
once and each output written once. A stage's least time on a card is the
larger of its FLOPs over the card's peak rates and its bytes over the
memory rate (stage_bound); the round trip's is the sum over its stages.
The stage table is the one place these counts live: chip_smoke.py's K1
bound reads k1_cost from it.

The products' FLOPs are checked: tests/test_torch_cost.py holds them equal
to what torch.utils.flop_counter counts of the two cores. The elementwise
FLOPs are estimates, operations per element counted by hand from the code
(_WRITE_OPS and the rest) and checked by no test; they are part of
embed_flops and extract_flops as XLA's counts are. On an H100 every stage
whose only work is elementwise is bound by its bytes, and in stage 2 the
estimate adds under 1% to the products' time, so no bound rests on them.

- roundtrip_cost: the counts of one embed + extract of B images, with the
  JAX keys (embed_flops, extract_flops, embed_hbm_bytes, extract_hbm_bytes,
  roundtrip_flops_per_image, link_bytes_per_image, ingest_bytes_per_image,
  geometry) and the stage table under "stages".
- peak_rates: a card's data-sheet peaks, by torch.cuda.get_device_name.
- measure_link: host <-> device copy rate each way, pinned host memory.
- measure_device_step: time of the two cores alone on resident inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from steganosaurus_tpu_torch import crypto, runtime, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.pipeline import header as header_mod
from steganosaurus_tpu_torch.pipeline.frame import HEADER_STREAM_BITS
from steganosaurus_tpu_torch.spectral import corner, corner_kernels

# Data-sheet peaks (dense, no sparsity), keyed by a part of the name
# torch.cuda.get_device_name reports. "fp32" is the rate outside the tensor
# cores: the f32 products run there, since the port keeps TF32 off
# (runtime.configure_precision).
_PEAKS = (
    ("H100 80GB HBM3", {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                        "hbm_bytes": 3.35e12,
                        "source": "NVIDIA H100 SXM5 data sheet"}),
)

# Elementwise f32 operations per element: estimates, counted by hand from
# the code of each stage (a sqrt, a compare or a select counts one) and
# checked by no test.
_WRITE_OPS = 14     # corner.write_delta, hard rule: |C|, sign, 2 x (mag*cos - re)
_FLOOR_OPS = 30     # corner.apply_write_floor: three reductions, the boost
_EPILOGUE_OPS = 5   # _epilogue: + planes, + 0.5, floor, clamp
_BAND_OPS = 3       # stage 2's energies: ar^2 + ai^2 summed over h
_READ_OPS = 4       # a decision value per slot and its Rep-3 / Rep-7 sum
# the bytes the card moves for each gathered f32: a whole 32-byte sector
SECTOR_BYTES = 32


def peak_rates(device=None) -> dict:
    """{"bf16", "tf32", "fp32": FLOP/s, "hbm_bytes": B/s, "source",
    "name"} of the CUDA card `device` (the current one by default), looked
    up by its name. A card this table does not know, or a device that is
    not a CUDA card, raises ValueError: there is no default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"peak rates are known for CUDA cards only, not "
                         f"{dev}")
    runtime.require_cuda()
    name = torch.cuda.get_device_name(dev)
    for key, rates in _PEAKS:
        if key in name:
            return dict(rates, name=name)
    raise ValueError(f"no peak rates known for {name!r}")


def _geometry(H: int, W: int, secret_len: int, params: Params) -> dict:
    """Shape math of the equal-length shared-walk corner branch
    (pipeline.batch.embed_batch / _ExtractJob._dispatch_pass), the same
    dict as the JAX package's cost._geometry."""
    if params.adaptive_alpha or params.per_image_walk or params.rs:
        raise ValueError("cost model covers the headline corner branch only "
                         "(no adaptive_alpha / per_image_walk / rs)")
    PH, PW = spectral.fft_dims(H, W)
    Ky, Kx = corner.corner_dims(PH, PW, params.rmax)
    clen = (header_mod.padded_len(secret_len, params.pad_quantum)
            if params.pad_quantum else secret_len)
    stream_bytes = header_mod.FIXED_LEN + clen + 16
    frame_bits = HEADER_STREAM_BITS + (clen + 16) * 8 * 7
    bucket = -(-frame_bits // 4096) * 4096
    hdr = HEADER_STREAM_BITS
    # the decoded words: Rep-3 header + Rep-7 payload, bit-packed
    hw = -((hdr // 3) // -32)
    pw = -(((bucket - hdr) // 7) // -32)
    return {
        "PH": PH, "PW": PW, "Ky": Ky, "Kx": Kx, "clen": clen,
        "stream_bytes": stream_bytes, "frame_bits": frame_bits,
        "bucket": bucket, "hdr_bits": hdr,
        "hard_words_per_image": hw + pw,
        "stream_words_per_image": -(stream_bytes // -4),
    }


def _stage(side: str, name: str, gemm: dict, elementwise: float,
           hbm_bytes: float, precision: str) -> dict:
    return {"side": side, "stage": name,
            "gemm_flops": {k: float(v) for k, v in gemm.items() if v},
            "elementwise_flops": float(elementwise),
            "hbm_bytes": float(hbm_bytes), "precision": precision}


def flops_of(stage: dict) -> float:
    """Every real FLOP of a stage: its products (counted) and its
    elementwise work (estimated)."""
    return sum(stage["gemm_flops"].values()) + stage["elementwise_flops"]


def k1_cost(P: int, H: int, W: int, Kx: int, side: str = "",
            precision: str = "bf16") -> dict:
    """Forward stage 1 (K1) over P planes of H x W: two products of the
    (P*H, W) bf16-rounded rows with the (Kx, W) cos and sin tables; bytes:
    the u8 images read once, both bf16 tables once, ar and ai written once
    in f32. precision="fp32": the stage as the f32 modes run it (high,
    highest: f32 products of the planes with the f32 tables)."""
    M = P * H
    tab = 4 if precision == "fp32" else 2
    return _stage(side, "K1", {precision: 2.0 * M * W * 2 * Kx}, 0,
                  M * W + 2 * Kx * W * tab + 2 * M * Kx * 4, precision)


def ifft_y_f32_cost(B: int, H: int, Ky: int, Kx: int) -> dict:
    """The inverse DFT's y-stage in f32 (mix2, mix_conservative, high:
    corner._ifft_y) over B images' (3, Ky, Kx) deltas: four real (H, Ky) x
    (Ky, Kx) products per plane; bytes: the f32 delta read once, the two
    f32 (Ky, H) tables once, mr and mi written once in f32."""
    P = 3 * B
    return _stage("embed", "inverse y-stage",
                  {"fp32": 8.0 * P * H * Ky * Kx}, 0,
                  2 * P * Ky * Kx * 4 + 2 * Ky * H * 4 + 2 * P * H * Kx * 4,
                  "fp32")


def ifft_y_cast_cost(B: int, H: int, Kx: int) -> dict:
    """mix2's cast of the f32 y-stage's mr and mi (3B*H, Kx) to bf16, K4's
    operands: read once in f32, written once in bf16."""
    n = 3 * B * H * Kx
    return _stage("embed", "cast", {}, 0, 2 * n * 4 + 2 * n * 2, "none")


def ifft_x_f32_cost(B: int, H: int, W: int, Kx: int) -> dict:
    """The inverse DFT's x-stage in f32 (mix_conservative, high, highest:
    corner.ifft_corner_real) over B images: two real (H, Kx) x (Kx, W)
    products per plane and their difference; bytes: mr and mi read once
    in f32, the two f32 (Kx, W) tables once, the (B, 3, H, W) f32 result
    written once."""
    P = 3 * B
    return _stage("embed", "inverse x-stage",
                  {"fp32": 4.0 * P * H * Kx * W}, 0,
                  2 * P * H * Kx * 4 + 2 * Kx * W * 4 + P * H * W * 4,
                  "fp32")


def write_floor_cost(B: int, Ky: int, Kx: int, bucket: int, n_maps: int,
                     out_bytes: int = 4, stream_bytes: int = 0) -> dict:
    """The K3 kernel (spectral/write_kernels.py write_floor) over B images'
    (3, Ky, Kx) corners: the write and the write floor in one function.
    Bytes: cr and ci read once, the int32 slot map, the frame (the (B,
    bucket) u8 frame bits, or with stream_bytes a RepFrame's (B,
    ceil(stream_bytes/4)) int32 stream words) and n_maps (3, Ky, Kx) f32
    maps (jitter, amplitude) read once, the two outputs written once at
    out_bytes a value (4: the f32 delta; 2: the inverse DFT's bf16
    operands, ifft_operands=True); what a schedule reads twice counts
    once."""
    if out_bytes not in (2, 4):
        raise ValueError(f"out_bytes must be 2 or 4, got {out_bytes!r}")
    E = 3 * B * Ky * Kx
    frame = B * -(-stream_bytes // 4) * 4 if stream_bytes else B * bucket
    return _stage("embed", "K3 write + floor", {},
                  (_WRITE_OPS + _FLOOR_OPS) * E,
                  2 * E * 4 + 3 * Ky * Kx * (4 + 4 * n_maps) + frame
                  + 2 * E * out_bytes, "none")


def floor_only_cost(B: int, Ky: int, Kx: int) -> dict:
    """The K3 kernel's floor alone (spectral/write_kernels.py floor_only)
    over B images' (3, Ky, Kx) corners: the given delta (dr, di) and the
    spectrum (cr, ci) read once, the boosted delta written once."""
    E = 3 * B * Ky * Kx
    return _stage("embed", "K3 floor", {}, _FLOOR_OPS * E, 6 * E * 4,
                  "none")


def epilogue_cost(B: int, H: int, W: int, layout: str = "nchw") -> dict:
    """The K4e kernel (spectral/write_kernels.py epilogue) over B images of
    3 planes of H x W: the unscaled inverse DFT t (f32) and the u8 cover
    planes read once, the u8 stego written once. Both layouts move the
    same bytes: the kernel stores NHWC directly."""
    if layout not in ("nchw", "nhwc"):
        raise ValueError(f"layout must be 'nchw' or 'nhwc', got {layout!r}")
    px = 3 * B * H * W
    return _stage("embed", "K4e epilogue", {}, _EPILOGUE_OPS * px,
                  px * 4 + 2 * px, "none")


def ifft_y_cost(B: int, H: int, Ky: int, Kx: int) -> dict:
    """The K6 kernel (spectral/write_kernels.py ifft_y), the inverse DFT's
    y-stage under mix_adaptive, over B images' (3, Ky, Kx) deltas: four
    real (H, Ky) x (Ky, Kx) products per plane in bf16; bytes: the bf16
    delta (Re D, -Im D) read once, the (2Hp, 2Kyp) bf16 table
    (corner.ifft_y_table) once, mr and mi written once in bf16."""
    P = 3 * B
    Hp, Kyp = corner_kernels._pad64(H), corner_kernels._pad64(Ky)
    return _stage("embed", "K6 inverse y-stage",
                  {"bf16": 8.0 * P * H * Ky * Kx}, 0,
                  2 * P * Ky * Kx * 2 + (2 * Hp) * (2 * Kyp) * 2
                  + 2 * P * H * Kx * 2, "bf16")


def ifft_epilogue_cost(B: int, H: int, W: int, Kx: int,
                       layout: str = "nchw") -> dict:
    """The K4 kernel (spectral/write_kernels.py ifft_epilogue) over B
    images of 3 planes of H x W: the x-stage, one product of the (3B*H,
    2Kx) bf16 rows [mr, mi] with the (2Kx, W) bf16 table [exr; -exi], and
    the u8 epilogue on its result; bytes: mr and mi read once, the table
    once, the u8 cover planes once, the u8 stego written once. Both layouts
    move the same bytes."""
    if layout not in ("nchw", "nhwc"):
        raise ValueError(f"layout must be 'nchw' or 'nhwc', got {layout!r}")
    M = 3 * B * H
    px = M * W
    return _stage("embed", "K4 inverse x-stage + epilogue",
                  {"bf16": 2.0 * M * 2 * Kx * W}, _EPILOGUE_OPS * px,
                  2 * M * Kx * 2 + 2 * Kx * W * 2 + 2 * px, "bf16")


def stage2_prep_cost(P: int, H: int, Kx: int, side: str = "") -> dict:
    """Forward stage 2's prep pass (corner_kernels.stage2_prep) over P
    planes' stage-1 output: ar and ai read once in f32, their bf16 copies
    written once, the (P, Kx) f32 energies written once; elementwise,
    ar^2 + ai^2 and its sum over h."""
    n = P * H * Kx
    return _stage(side, "stage2 prep", {}, _BAND_OPS * n,
                  2 * n * 4 + 2 * n * 2 + P * Kx * 4, "none")


def prep_reduce_cost(P: int, H: int, Kx: int, side: str = "") -> dict:
    """The prep's energies where K1's epilogue made its partials
    (corner_kernels.prep_reduce): the (energy_slots(P, H), Kx) f64 partials
    read once, the (P, Kx) f32 energies written once; a sum each."""
    slots = corner_kernels.energy_slots(P, H)
    return _stage(side, "stage2 prep reduce", {}, slots * Kx,
                  slots * Kx * 8 + P * Kx * 4, "none")


def stage2_band_cost(P: int, H: int, Kx: int, side: str = "",
                     band: int | None = None) -> dict:
    """K2's band operand (corner_kernels.stage2_band): the `band` columns
    (default SPLIT_X0; at most Kx) of ar and ai read once (f32), their
    three bf16 terms written once, the column mask written once."""
    X0 = min(corner.SPLIT_X0 if band is None else band, Kx)
    levels = corner_kernels.LEVELS
    return _stage(side, "stage2 band", {}, 0,
                  2 * P * H * X0 * 4 + 2 * levels * P * H * X0 * 2
                  + P * -(-Kx // 32) * 4, "none")


def k2_cost(P: int, H: int, Ky: int, Kx: int, side: str = "",
            band: int | None = None) -> dict:
    """K2 (corner_kernels.fwd_stage2) with a band of `band` columns
    (default SPLIT_X0; at most Kx): the bulk, four real (Ky, H) x (H,
    Kx - band) products per plane in bf16 (the columns it keeps: the
    band columns' bulk values are thrown away, so the function does not
    need them), and the band columns as the six bf16 products of split
    bf16 (corner_kernels.SPLITS["bf16x6"]); bytes: the bf16 copies of ar
    and ai read once (none where the band holds every column), the band
    operand (the three bf16 terms of the band columns of ar and ai) once,
    the table's terms the launch reads (T0 alone without a band) once, cr
    and ci written once in f32."""
    X0 = min(corner.SPLIT_X0 if band is None else band, Kx)
    nprod, levels = len(corner_kernels.SPLITS["bf16x6"]), corner_kernels.LEVELS
    bulk = 8.0 * P * Ky * H * (Kx - X0)
    band_flops = nprod * 8.0 * P * X0 * H * Ky
    nbytes = ((2 * P * H * Kx * 2 if X0 < Kx else 0)
              + 2 * levels * P * H * X0 * 2
              + (levels if X0 else 1) * (2 * Ky) * (2 * H) * 2
              + 2 * P * Ky * Kx * 4)
    what = ("bf16" if not X0 else "split bf16" if X0 == Kx else
            f"bf16, {X0} columns again in split bf16")
    return _stage(side, "K2", {"bf16": bulk + band_flops}, 0, nbytes,
                  f"{what} ({nprod} bf16 products a band value)")


def sector_share(n: int, Ky: int, Kx: int) -> float:
    """The share of a (3, Ky, Kx) f32 corner's 32-byte sectors that a walk
    of n distinct bins drawn uniformly touches: 1 - (1 - n / (3 Ky Kx))^8,
    8 values a sector."""
    per = SECTOR_BYTES // 4
    return 1.0 - (1.0 - n / (3 * Ky * Kx)) ** per


def walk_sectors(plane, y, x, Ky: int, Kx: int) -> int:
    """The 32-byte sectors of a (3, Ky, Kx) f32 corner that the walk
    plane/y/x (n,) touches (a device count, pulled)."""
    flat = (plane.long() * Ky + y.long()) * Kx + x.long()
    return int(torch.unique(flat // (SECTOR_BYTES // 4)).numel())


def read_decode_cost(B: int, Ky: int, Kx: int, n: int, words: int,
                     planes: int = 1, jitter: bool = False,
                     sectors: float | None = None,
                     plan_bytes: float | None = None) -> dict:
    """K5 (spectral/read_kernels.py read_decode) over B images' (3, Ky, Kx)
    corners at a shared walk of n slots: each 32-byte sector that the walk
    touches in each of `planes` planes (Im C; Re C too under jitter) read
    once, `sectors` of them an image (default: sector_share's count for a
    uniform walk), the walk's read plan once, `plan_bytes` of it (default:
    its int32 slot ids and int16 offsets, 6 bytes a slot; its rows, about
    one a tile, add under 1%), the jitter's cos and sin once when
    `jitter`, and `words` int32 words an image (the hard and soft rows)
    written once."""
    if sectors is None:
        sectors = sector_share(n, Ky, Kx) * 3 * Ky * Kx / (SECTOR_BYTES // 4)
    if plan_bytes is None:
        plan_bytes = 6 * n
    return _stage("extract", "read + decode", {}, _READ_OPS * B * n,
                  B * planes * sectors * SECTOR_BYTES + plan_bytes
                  + (2 * n * 4 if jitter else 0) + B * words * 4, "none")


def stage2_f32_cost(P: int, H: int, Ky: int, Kx: int, side: str = "") -> dict:
    """Forward stage 2 under highest: four real (Ky, H) x (H, Kx) products
    per plane in f32; bytes: ar and ai read once, the two f32 (Ky, H)
    tables once, cr and ci written once in f32."""
    nbytes = 2 * P * H * Kx * 4 + 2 * Ky * H * 4 + 2 * P * Ky * Kx * 4
    return _stage(side, "stage2", {"fp32": 8.0 * P * Ky * H * Kx}, 0, nbytes,
                  "fp32")


def _stage2(side: str, P: int, H: int, Ky: int, Kx: int,
            fwd2: str) -> list[dict]:
    """Forward stage 2 at precision fwd2 (corner.Precision.fwd2), as the
    card runs it (corner._fwd_y_kernels; the CPU path runs the band once
    in f32): under "highest" four real (Ky, H) x (H, Kx) products per
    plane in f32; else K2 with a band of corner.band_width(fwd2, Kx)
    columns, after the prep pass where it has a bulk and the band pass
    where it has a band."""
    X0 = corner.band_width(fwd2, Kx)
    if X0 is None:
        return [stage2_f32_cost(P, H, Ky, Kx, side)]
    return ([stage2_prep_cost(P, H, Kx, side)] if X0 < Kx else []) + (
        [stage2_band_cost(P, H, Kx, side, X0)] if X0 else []) + [
        k2_cost(P, H, Ky, Kx, side, X0)]


def stage_costs(B: int, H: int, W: int, secret_len: int,
                params: Params = Params(),
                layout: str = "nchw") -> list[dict]:
    """The round trip's stage table: one dict per stage, in order, with
    side ("embed" / "extract"), stage, gemm_flops {precision: FLOPs},
    elementwise_flops, hbm_bytes and precision, under the corner precision
    mode in force (corner.precision()): each stage at its precision, the
    f32 ("high" and "highest") products at the fp32 rate."""
    g = _geometry(H, W, secret_len, params)
    mode = corner.precision()
    Ky, Kx, bucket = g["Ky"], g["Kx"], g["bucket"]
    P = 3 * B
    E = P * Ky * Kx                      # corner bins of the batch
    px = P * H * W                       # image-plane pixels of the batch
    y16, x16 = mode.inv_y == "bf16", mode.inv_x == "bf16"
    n_maps = 2 * sum(map(bool, (params.jitter, params.alpha_spread,
                                params.qim)))

    def forward(side: str) -> list[dict]:
        """The forward corner DFT of a side (nhwc first permutes the u8
        images to planes: a read and a write)."""
        out = ([_stage(side, "layout", {}, 0, 2 * px, "none")]
               if layout == "nhwc" else [])
        k1 = k1_cost(P, H, W, Kx, side,
                     "bf16" if mode.stage1 == "bf16" else "fp32")
        return out + [k1, *_stage2(side, P, H, Ky, Kx, mode.fwd2)]

    if params.qim:
        embed = forward("embed") + [
            # the eager QIM write: each bin's frame bit through pos (int64)
            # and the other maps; the dense delta; then K3's floor alone
            _stage("embed", "write", {}, _WRITE_OPS * E,
                   2 * E * 4 + 3 * Ky * Kx * (8 + 4 * n_maps) + B * bucket
                   + 2 * E * 4, "none"),
            floor_only_cost(B, Ky, Kx)]
    else:
        # one K3 write_floor launch over the equal-length frame's stream
        # words (write_kernels.RepFrame); where the y-stage is bf16 it
        # stores the inverse DFT's bf16 operands, else the f32 delta
        embed = forward("embed") + [write_floor_cost(
            B, Ky, Kx, bucket, n_maps, out_bytes=2 if y16 else 4,
            stream_bytes=g["stream_bytes"])]
    if not x16:
        embed += [
            # M = Ey^T conj(D) (four products), then Re(M Ex) (two), then
            # K4e over the f32 result
            _stage("embed", "inverse",
                   {"fp32": 8.0 * P * H * Ky * Kx + 4.0 * P * H * Kx * W}, 0,
                   2 * E * 4 + 2 * (Ky * H + Kx * W) * 4 + px * 4, "fp32"),
            _stage("embed", "epilogue", {}, _EPILOGUE_OPS * px,
                   px * 4 + 2 * px, "none")]
    elif not y16:
        # mix2: M = Ey^T conj(D) in f32 (four products), M cast to bf16
        # (K4's operands), then K4
        embed += [ifft_y_f32_cost(B, H, Ky, Kx), ifft_y_cast_cost(B, H, Kx),
                  ifft_epilogue_cost(B, H, W, Kx, layout)]
    else:
        # K6: the y-stage, then K4: the x-stage with the epilogue fused
        embed += [ifft_y_cost(B, H, Ky, Kx),
                  ifft_epilogue_cost(B, H, W, Kx, layout)]
    if layout == "nhwc":
        embed.append(_stage("embed", "layout out", {}, 0, 2 * px, "none"))
    # K5: the sectors the walk touches (Im C, and Re C under jitter or
    # QIM), the walk's read plan, the decoded hard (and soft) words
    words = g["hard_words_per_image"] * (
        2 if params.soft_decode_fallback else 1)
    extract = forward("extract") + [read_decode_cost(
        B, Ky, Kx, bucket, words,
        planes=2 if params.jitter or params.qim else 1,
        jitter=bool(params.jitter))]
    return embed + extract


def stage_bound(stage: dict, peaks: dict) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): a stage's least time on a card of
    `peaks` (peak_rates), the larger of its FLOPs at their precisions'
    peaks (elementwise at the fp32 rate) and its bytes at the memory
    rate."""
    ops_s = sum(f / peaks[p] for p, f in stage["gemm_flops"].items())
    ops_s += stage["elementwise_flops"] / peaks["fp32"]
    bytes_s = stage["hbm_bytes"] / peaks["hbm_bytes"]
    return ((ops_s * 1e3, "operations") if ops_s >= bytes_s
            else (bytes_s * 1e3, "bytes"))


def roundtrip_bound(cost: dict, peaks: dict) -> dict:
    """Least times of a roundtrip_cost on a card of `peaks`: per stage
    (side, stage, ms, bound_by), per side and for the round trip, in ms
    (the stages run one after another)."""
    stages = [(s["side"], s["stage"], *stage_bound(s, peaks))
              for s in cost["stages"]]
    side = {k: sum(ms for sd, _, ms, _ in stages if sd == k)
            for k in ("embed", "extract")}
    return {"stages": stages, "embed_ms": side["embed"],
            "extract_ms": side["extract"],
            "roundtrip_ms": side["embed"] + side["extract"]}


def roundtrip_cost(B: int, H: int, W: int, secret_len: int,
                   params: Params = Params(), layout: str = "nchw") -> dict:
    """Counted FLOPs and HBM bytes of the headline round trip's embed and
    extract at these shapes (the JAX package's keys; the FLOPs hold the
    stages' elementwise estimates beside the counted products), plus the
    host-link
    bytes of the steady state per image: stream words up for the embed,
    decoded hard words down from the extract (covers and stego stay on the
    card; their one-time crossing is ingest_bytes_per_image). "stages" is
    the stage table (stage_costs)."""
    g = _geometry(H, W, secret_len, params)
    stages = stage_costs(B, H, W, secret_len, params, layout)
    tot = {side: (sum(flops_of(s) for s in stages if s["side"] == side),
                  sum(s["hbm_bytes"] for s in stages if s["side"] == side))
           for side in ("embed", "extract")}
    return {
        "embed_flops": tot["embed"][0],
        "extract_flops": tot["extract"][0],
        "embed_hbm_bytes": tot["embed"][1],
        "extract_hbm_bytes": tot["extract"][1],
        "roundtrip_flops_per_image": (tot["embed"][0] + tot["extract"][0])
        / B,
        "link_bytes_per_image": 4 * (g["stream_words_per_image"]
                                     + g["hard_words_per_image"]),
        "ingest_bytes_per_image": 2 * 3 * H * W,
        "geometry": g,
        "stages": stages,
    }


def measure_link(nbytes: int = 1 << 27, reps: int = 2, device=None) -> dict:
    """Host -> device and device -> host copy rate (bytes/s, best of
    `reps`) through a pinned host buffer, each direction fenced by
    torch.cuda.synchronize. On the CPU (device="cpu") it times a plain host
    copy; the result names its device."""
    dev = runtime.resolve_device(device)
    cuda = dev.type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def fence():
        if cuda:
            torch.cuda.synchronize(dev)

    up = down = 0.0
    for _ in range(reps):
        fence()
        t0 = time.perf_counter()
        dst.copy_(host, non_blocking=True)
        fence()
        up = max(up, nbytes / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        host.copy_(dst, non_blocking=True)
        fence()
        down = max(down, nbytes / (time.perf_counter() - t0))
    return {"up_bytes_per_sec": up, "down_bytes_per_sec": down,
            "probe_bytes": nbytes,
            "device": torch.cuda.get_device_name(dev) if cuda else str(dev)}


def _timed(fn, reps: int, dev) -> float:
    """Least seconds of fn() over `reps` runs: CUDA events around each run
    on a card, the host clock on the CPU."""
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            best = min(best, min_over(1, fn))
    return best


def measure_device_step(covers_d, master_key: bytes, secret_len: int,
                        params: Params = Params(),
                        password: str | None = None, layout: str = "nchw",
                        reps: int = 3) -> dict:
    """Seconds of the embed core (the frame's on-device ECC expansion, then
    corner_embed_core) and of corner_extract_fused_core alone, on covers
    already on their device and random stream words (the same work as real
    ones, no host crypto), least of `reps` after one untimed run each: the
    device's share of the round trip, against its end-to-end wall."""
    from steganosaurus_tpu_torch.pipeline.batch import (
        _corner_statics_device, _read_plan_device, _slot_values_device,
        _walk_indices_device)

    if layout == "nchw":
        B, _, H, W = covers_d.shape
    else:
        B, H, W = covers_d.shape[:3]
    g = _geometry(H, W, secret_len, params)
    dev = covers_d.device
    rng = np.random.default_rng(3)
    words = runtime.upload(rng.integers(
        np.iinfo(np.int32).min, np.iinfo(np.int32).max + 1,
        (B, g["stream_words_per_image"]), dtype=np.int64).astype(np.int32),
        dev)
    nbits, bucket = g["frame_bits"], g["bucket"]
    maps, _ = _corner_statics_device(password, master_key, params, g["PH"],
                                     g["PW"], nbits, bucket, g["Ky"],
                                     g["Kx"], dev)
    kk = dict(Ky=g["Ky"], Kx=g["Kx"], center=params.center, layout=layout)

    def embed():
        frame = pbatch._frame_from_words(words, g["stream_bytes"], bucket)
        return pbatch.corner_embed_core(
            covers_d, frame, maps, params.alpha, floor=params.write_floor,
            soft=params.soft_write, has_jitter=params.jitter != 0.0,
            has_spread=params.alpha_spread != 0.0, qim_levels=params.qim,
            **kk)

    stego = embed()
    t_emb = _timed(embed, reps, dev)
    (pl, yy, xx, jj), _ = _walk_indices_device(
        password, master_key, params, g["PH"], g["PW"], nbits, 0, bucket,
        dev)
    dither = (_slot_values_device(
        "dither", crypto.derive_path_key(password, master_key), params,
        params.qim, nbits, bucket, dev) if params.qim else None)
    plan = (None if params.qim else _read_plan_device(
        password, master_key, params, g["PH"], g["PW"], nbits, 0, bucket,
        g["Ky"], g["Kx"], dev))

    def extract():
        return pbatch.corner_extract_fused_core(
            stego, params.alpha, pl, yy, xx, hdr_stream_bits=g["hdr_bits"],
            with_soft=bool(params.soft_decode_fallback),
            jit=jj if params.jitter != 0.0 else None, dither=dither,
            qim_levels=params.qim, qim_from=g["hdr_bits"], plan=plan, **kk)

    extract()
    t_ext = _timed(extract, reps, dev)
    return {"embed_s": t_emb, "extract_s": t_ext,
            "device_roundtrip_s": t_emb + t_ext, "batch": B,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}


def min_over(reps: int, fn) -> float:
    """Least host-clock seconds of fn() over `reps` runs."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best
