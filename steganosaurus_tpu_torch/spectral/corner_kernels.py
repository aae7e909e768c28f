"""The forward corner DFT's hand-written Hopper kernels and their plain
PyTorch versions: stage 1 (K1), and stage 2 (K2) with its prep pass.

Stage 1 (K1).

Replaces steganosaurus_tpu/spectral/corner_pallas.py:fwd_stage1. For every
plane and row, against both DFT tables:

    ar[..., h, k] = sum_w bf16(c(h,w) x[..., h, w]) * bf16(exr[k, w])
    ai[..., h, k] = sum_w bf16(c(h,w) x[..., h, w]) * bf16(exi[k, w])

with f32 accumulation, x the u8 image batch itself ((..., H, W), e.g. NCHW
(B, 3, H, W)) and c = (-1)^(h+w) when `center` is set, else 1.

One kernel for every width, csrc/corner_stage1_wgmma.cu: wgmma, one GEMM
over the concatenated table of stage1_tables (by TMA) with the centering
folded out of the A operand, the u8 image rows. A reaches shared memory
one of two ways, chosen by route_for:

- the TMA route (W % 16 == 0 and a 16-byte-aligned base: every grid the
  pipeline runs at 4K, 1080p, 512^2): TMA needs 16-byte row strides;
- the load route (any other W, or an unaligned view): the producer
  warpgroup loads the rows itself and writes the same bytes.

`fwd_stage1` launches one of them for CUDA tensors — or raises; nothing here
catches a build or launch failure and falls back — and takes
`fwd_stage1_plain` only for CPU tensors.

K1 also does stage 2's prep where its caller asks (`prep`, PREPS): its
epilogue writes the bf16 copies of ar and ai and ("energies") per-tile f64
partial sums of the column energies from the values it holds, and
`prep_reduce` adds each plane's partials (stage1_energy_plain is their
order in plain torch), so stage 2 does not read ar and ai back for them.
The table pairs exr and exi rows in each 256-row tile (stage1_tables) so
that one thread holds ar and ai of one column.

Stage 2 (replaces steganosaurus_tpu/spectral/corner.py:_fwd_y_split and
the HIGH and bf16 einsums of fwd_corner, which XLA fuses for the TPU), in
csrc/corner_stage2.cu. With (ar, ai) the stage-1 output (P, H, Kx) f32 and
the y tables (eyr, eyi) (Ky, H), per plane

    cr = eyr . ar - eyi . ai,   ci = eyr . ai + eyi . ar     (contract h)

with a band of columns in split bf16 and the bulk in bf16. The band is
nb >= 0 groups of BAND = 64 columns, nb a run-time count: under
mix_adaptive the top-64 energy columns per plane, under mix_split the
static [0, 64) (STEGANOSAURUS_SPLIT_X0 sets the width), under the HIGH
modes every column (no bulk), under bf16 none (no band). A width that is
not a multiple of 64 is padded with copies of each row's last index
(pad_band): the kernel computes such a column again, with the same value.

- `stage2_prep` reads ar and ai once and writes their bf16 copies (the
  bulk's operands) and the column energies sum_h(ar^2 + ai^2) (P, Kx),
  summed in f64 in an order fixed by the shape. torch.topk of the energies
  picks the adaptive band: the columns of highest energy per plane. Where
  stage 1 runs through K1, K1's epilogue and `prep_reduce` make the same
  three outputs instead; `stage2_prep` stays for an f32 stage 1.
- `fwd_stage2` (K2) is one wgmma GEMM per plane, [cr; ci] = T . [ar16;
  ai16] with T = [[eyr, -eyi], [eyi, eyr]] in bf16 (stage2_tables), f32
  accumulation, whose epilogue skips the band's columns (band_mask); the
  band's tiles compute those columns in split bf16 with three terms a
  value and six products (SPLITS["bf16x6"], the TPU's Precision.HIGHEST
  emulation) from the gathered f32 columns (band_operand), and write them
  into the holes. On the card a third kernel, `stage2_band`, gathers and
  splits those columns and writes the mask in one pass. The two-term split (three products, the TPU's
  Precision.HIGH) was measured first and moved one Rep-7 group of the 4K
  benchmark stego to a wrong bit (tools/band_ber_torch.py, PERF.md).
- `fwd_stage2_plain(band="bf16x6")` is K2's spec (the same splits, the
  products summed in f32). `band_error` and `bulk_error` measure how far
  a result lies from the exact sums: the band columns on their own scale
  (SPLIT_REL), the bulk's sum order. Only the tests, the tools and
  chip_smoke.py use these on a card; corner.fwd_corner keeps
  corner._fwd_y_split (an f32 band) on the CPU.

Every wrapper launches its kernel for CUDA tensors or raises, and takes its
plain version only for CPU tensors. `LAUNCHES` counts each kernel's (and
each K1 route's) launches under its own name, one per launch and nowhere
else, so a run can show that the main path went through the kernels, and
K1 on which route; a K1 launch with the prep counts also under
KERNEL_K1_PREP; `BAND_WIDTHS` counts K2's launches by their band width
in columns (64 nb; 0: no band).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from steganosaurus_tpu_torch import spectral

KERNEL_TMA = "corner_stage1_wgmma"      # A by TMA
KERNEL_LDG = "corner_stage1_wgmma_ldg"  # A by the producer warpgroup's loads
K1_ROUTES = (KERNEL_TMA, KERNEL_LDG)
# K1 launches (also counted under their route) whose epilogue writes stage
# 2's bf16 copies, and with them the energies' partials where asked
KERNEL_K1_PREP = "corner_stage1_wgmma_prep"
KERNEL_PREP = "corner_stage2_prep"      # stage 2's bf16 casts and energies
KERNEL_PREP_REDUCE = "corner_stage2_prep_reduce"  # energies from K1's partials
KERNEL_BAND = "corner_stage2_band"      # K2's band operand and column mask
KERNEL_STAGE2 = "corner_stage2"         # K2
LAUNCHES = {KERNEL_TMA: 0, KERNEL_LDG: 0, KERNEL_K1_PREP: 0, KERNEL_PREP: 0,
            KERNEL_PREP_REDUCE: 0, KERNEL_BAND: 0, KERNEL_STAGE2: 0}
# what fwd_stage1 can hand stage 2 besides ar and ai: the bf16 copies, or
# the copies and the column energies
PREPS = ("copies", "energies")
# K2's launches by band width in columns, 64 nb (0: the bulk alone)
BAND_WIDTHS: collections.Counter = collections.Counter()
BLOCK = 64  # the kernels' K block and the tables' padding quantum
K1_ROWS = 128  # K1's row tile: the energies' partials are per (tile, plane)
K1_COLS = 128  # K1's output columns a tile: the table pads Kx to them
BAND = 64   # a K2 band group: the columns per plane of one band tile
# blocks of a K2 cluster (csrc/corner_stage2.cu's CLUSTER): two row blocks
# of T that share a plane's operand by TMA multicast
STAGE2_CLUSTER = 2


def route_for(W: int, data_ptr: int) -> str:
    """The route fwd_stage1 launches on CUDA for width-W images whose first
    byte is at address data_ptr."""
    return KERNEL_TMA if W % 16 == 0 and data_ptr % 16 == 0 else KERNEL_LDG


def fwd_stage1_plain(imgs_u8: torch.Tensor, exr: torch.Tensor,
                     exi: torch.Tensor, center: bool):
    """Plain version: round both operands through bf16, then an f32 matmul —
    exactly what JAX's _mm(..., "bf16") does on the CPU
    (steganosaurus_tpu/spectral/corner.py:_mm). Needs TF32 off on CUDA
    (runtime.configure_precision) to stay an f32 product there."""
    x = spectral.apply_center(imgs_u8.to(torch.float32), center)
    x = x.to(torch.bfloat16).to(torch.float32)
    H, W = x.shape[-2:]
    Kx = exr.shape[0]
    rows = x.reshape(-1, W)
    ar = rows @ exr.to(torch.bfloat16).to(torch.float32).T
    ai = rows @ exi.to(torch.bfloat16).to(torch.float32).T
    lead = x.shape[:-1]
    return ar.reshape(*lead, Kx), ai.reshape(*lead, Kx)


def _pad64(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


@functools.lru_cache(maxsize=8)
def k_order(Wp: int) -> torch.Tensor:
    """(Wp,) int64: the pixel column each logical K position of the wgmma
    kernel reads. Inside every 64-wide block, logical k = 16s + r (k16 step
    s, r in 0..15) is pixel 16q + 4s + e with q = (r % 8) // 2 and
    e = r % 2 + 2 (r // 8): the pixels a consumer thread puts in its wgmma
    A fragments are then 16 consecutive bytes of one row."""
    k = torch.arange(Wp)
    base, k = k - k % BLOCK, k % BLOCK
    s, r = k // 16, k % 16
    return base + 16 * ((r % 8) // 2) + 4 * s + r % 2 + 2 * (r // 8)


def _pad_cols(Kx: int) -> int:
    """Kx rounded up to K1_COLS: the columns of K1's paired table."""
    return -(-Kx // K1_COLS) * K1_COLS


def stage1_rows(Kx: int):
    """((Kx,) int64, (Kx,) int64): the rows of stage1_tables' table that
    hold exr[k] and exi[k]. Each 256-row tile holds 128 rows of exr, then
    the same 128 rows of exi, so one K1 thread holds ar and ai of a
    column."""
    k = torch.arange(Kx)
    r = 2 * K1_COLS * (k // K1_COLS) + k % K1_COLS
    return r, r + K1_COLS


class Stage1Tables(NamedTuple):
    """stage1_tables' two tables and the Kx they hold: the paired layout
    pads Kx to 128, so a table's shape does not tell its Kx."""
    plain: torch.Tensor
    centered: torch.Tensor
    Kx: int


def stage1_tables(exr16: torch.Tensor, exi16: torch.Tensor) -> Stage1Tables:
    """(t, t_centered, Kx): the kernel's B operand, (2*Kxh, Wp) bf16 on the
    tables' device, Kxh = Kx rounded up to 128 (K1_COLS) and Wp = W rounded
    up to 64. Row stage1_rows(Kx)[0][k] holds exr[k], [1][k] exi[k]: in
    each 256-row tile 128 rows of exr, then the same 128 of exi; the rest
    zeros; columns past W are zeros; columns run in k_order. t_centered
    has (-1)^w folded in (a sign flip, exact in bf16): with the (-1)^h row
    sign that the kernel applies to its output it gives the centered
    product bit for bit."""
    Kx, W = exr16.shape
    Kxh, Wp = _pad_cols(Kx), _pad64(W)
    t = torch.zeros((2 * Kxh, Wp), dtype=torch.bfloat16, device=exr16.device)
    rr, ri = stage1_rows(Kx)
    t[rr.to(t.device), :W] = exr16
    t[ri.to(t.device), :W] = exi16
    sign = 1 - 2 * (torch.arange(Wp, device=t.device) % 2)
    tc = t * sign.to(torch.bfloat16)
    order = k_order(Wp).to(t.device)
    return Stage1Tables(t[:, order].contiguous(), tc[:, order].contiguous(),
                        Kx)


def _check(imgs_u8, exr, exi):
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() < 2:
        raise ValueError(f"fwd_stage1: images must be u8 (..., H, W), got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    W = imgs_u8.shape[-1]
    for name, t in (("exr", exr), ("exi", exi)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.shape[1] != W:
            raise ValueError(f"fwd_stage1: {name} must be bf16 (Kx, {W}), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != imgs_u8.device:
            raise ValueError(f"fwd_stage1: {name} on {t.device}, images on "
                             f"{imgs_u8.device}")
    if exr.shape != exi.shape:
        raise ValueError("fwd_stage1: exr and exi shapes differ")


def fwd_stage1(imgs_u8: torch.Tensor, exr_bf16: torch.Tensor,
               exi_bf16: torch.Tensor, center: bool, tables=None,
               prep: str | None = None):
    """(..., H, W) u8 images, (Kx, W) bf16 tables -> ((..., H, Kx) ar, ai)
    f32. CUDA tensors launch the kernel on route_for(W, data_ptr) on the
    current stream; CPU tensors take fwd_stage1_plain; any other device
    raises. `tables` is stage1_tables(exr_bf16, exi_bf16), cached by the
    caller (corner.Tables); it is built here when not given.

    prep (one of PREPS) also hands stage 2 what stage2_prep would make of
    ar and ai, as a third item (ar16, ai16, energy): P = the images'
    planes (the leading axes flattened), ar16 / ai16 (P, H, Kx) bf16 equal
    to ar.to(bf16) / ai.to(bf16) (on CUDA views of rows padded to 16
    bytes, the stride K2's TMA reads), energy (P, Kx) f32 the column
    energies under "energies", else None. On CUDA K1's epilogue writes
    them (prep_reduce adds the energies' partials), counted also under
    KERNEL_K1_PREP; on the CPU ar.to(bf16), ai.to(bf16) and the energies of
    stage1_partials_plain through prep_reduce (stage1_energy_plain)."""
    _check(imgs_u8, exr_bf16, exi_bf16)
    if prep is not None and prep not in PREPS:
        raise ValueError(f"fwd_stage1: prep must be None or one of {PREPS}, "
                         f"got {prep!r}")
    dev = imgs_u8.device
    H, W = imgs_u8.shape[-2:]
    P = imgs_u8.numel() // (H * W) if H * W else 0
    Kx = exr_bf16.shape[0]
    if dev.type == "cpu":
        ar, ai = fwd_stage1_plain(imgs_u8, exr_bf16, exi_bf16, center)
        if prep is None:
            return ar, ai
        a, b = ar.reshape(P, H, Kx), ai.reshape(P, H, Kx)
        energy = (prep_reduce(stage1_partials_plain(a, b), P, H)
                  if prep == "energies" else None)
        return ar, ai, (a.to(torch.bfloat16), b.to(torch.bfloat16), energy)
    if dev.type != "cuda":
        raise ValueError(f"fwd_stage1: unsupported device {dev}")
    for name, t in (("images", imgs_u8), ("exr", exr_bf16), ("exi", exi_bf16)):
        if not t.is_contiguous():
            raise ValueError(f"fwd_stage1: {name} must be contiguous")
    lead = imgs_u8.shape[:-1]
    ar = torch.empty((*lead, Kx), dtype=torch.float32, device=dev)
    ai = torch.empty((*lead, Kx), dtype=torch.float32, device=dev)
    copies = part = None
    if prep is not None:
        copies = _copies(P, H, Kx, dev)
        if prep == "energies" and P:
            part = torch.empty((energy_slots(P, H), Kx), dtype=torch.float64,
                               device=dev)
    if tables is not None and tables.Kx != Kx:
        raise ValueError(f"fwd_stage1: tables of Kx={tables.Kx} for Kx={Kx}")
    if imgs_u8.numel():
        if tables is None:
            tables = stage1_tables(exr_bf16, exi_bf16)
        _launch(imgs_u8, tables[1] if center else tables[0], ar, ai, Kx,
                center, route_for(W, imgs_u8.data_ptr()), copies, part)
    if prep is None:
        return ar, ai
    energy = None
    if prep == "energies":
        energy = (prep_reduce(part, P, H) if part is not None else
                  torch.zeros((P, Kx), dtype=torch.float32, device=dev))
    return ar, ai, (copies[0, ..., :Kx], copies[1, ..., :Kx], energy)


def _launch(imgs_u8, t, ar, ai, Kx: int, center: bool, route: str,
            copies=None, part=None) -> None:
    """csrc/corner_stage1_wgmma.cu on the current stream, A on `route`
    (KERNEL_TMA or KERNEL_LDG; the load route takes any input); with
    `copies` (_copies' (2, P, H, ldk) buffer) the epilogue also writes the
    bf16 copies, with `part` ((energy_slots(P, H), Kx) f64) the energies'
    partials too."""
    from steganosaurus_tpu_torch import _build

    H, W = imgs_u8.shape[-2:]
    Kxh, Wp = _pad_cols(Kx), _pad64(W)
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != (2 * Kxh, Wp)
            or t.device != imgs_u8.device or not t.is_contiguous()):
        raise ValueError(f"fwd_stage1: the concatenated table must be a "
                         f"contiguous bf16 ({2 * Kxh}, {Wp}) on "
                         f"{imgs_u8.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if route not in K1_ROUTES:
        raise ValueError(f"fwd_stage1: unknown route {route!r}")
    if route == KERNEL_TMA and route_for(W, imgs_u8.data_ptr()) != route:
        raise ValueError(f"fwd_stage1: the TMA route needs W % 16 == 0 and "
                         f"16-byte-aligned images (W={W})")
    if part is not None and copies is None:
        raise ValueError("fwd_stage1: the energies' partials need the copies")
    P = imgs_u8.numel() // (H * W)
    ptr = [0 if x is None else x.data_ptr() for x in
           (copies, None if copies is None else copies[1], part)]
    ldk = 0 if copies is None else copies.shape[-1]
    prep = 0 if copies is None else 1 if part is None else 2
    with torch.cuda.device(imgs_u8.device):
        stream = torch.cuda.current_stream(imgs_u8.device).cuda_stream
        rc = _build.kernel_library().corner_stage1_wgmma(
            imgs_u8.data_ptr(), t.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            *ptr, P, H, W, Kx, Kxh, Wp, ldk, int(bool(center)),
            int(route == KERNEL_TMA), prep, stream)
    if rc != 0:
        raise RuntimeError(f"{route} launch failed: CUDA error {rc}")
    LAUNCHES[route] += 1
    if copies is not None:
        LAUNCHES[KERNEL_K1_PREP] += 1


def _copies(P: int, H: int, X: int, device) -> torch.Tensor:
    """(2, P, H, ldk) bf16 for the bf16 copies of the stage-1 output,
    ldk = X rounded up to 8 values (16 bytes): the rows K2's TMA reads.
    Columns [X, ldk) are never written."""
    ldk = -(-X // 8) * 8
    return torch.empty((2, P, H, ldk), dtype=torch.bfloat16, device=device)


def energy_slots(P: int, H: int) -> int:
    """The rows of K1's energy partials for P planes of H rows: row t + p
    holds plane p's rows in row tile t (K1_ROWS rows of the P*H), so
    ceil(P*H / K1_ROWS) + P - 1 rows, some of which (a tile ending where
    its plane ends) no tile writes."""
    return -(-P * H // K1_ROWS) + P - 1


def stage1_partials_plain(ar: torch.Tensor, ai: torch.Tensor) -> torch.Tensor:
    """K1's energy partials in plain torch, (energy_slots(P, H), Kx) f64
    from ar/ai (P, H, Kx) f32, summed in the kernel's order: e = ar*ar +
    ai*ai (each step rounded in f32, as eager torch rounds it); in each row
    tile, for each plane it touches (rows of other planes as zeros), tile
    row 16w + 8s + l is row s of lane l of warp w: each lane adds its two
    rows, the 8 lanes reduce by a butterfly over l ^ 4, l ^ 2, l ^ 1, then
    the 8 warps' sums are added in warp order. Rows no tile writes are
    zeros here."""
    P, H, X = ar.shape
    M = P * H
    f64 = torch.float64
    e = (ar * ar + ai * ai).reshape(M, X).to(f64)
    rows = torch.arange(M, device=ar.device)
    tiles = torch.zeros((energy_slots(P, H), K1_ROWS, X), dtype=f64,
                        device=ar.device)
    tiles[rows // K1_ROWS + rows // H, rows % K1_ROWS] = e
    x = tiles.view(-1, 8, 2, 8, X)
    x = x[:, :, 0] + x[:, :, 1]        # a lane's rows l and l + 8
    x = x[:, :, :4] + x[:, :, 4:]      # lanes l, l ^ 4 (shuffle xor 16)
    x = x[:, :, :2] + x[:, :, 2:]      # l ^ 2 (xor 8)
    x = x[:, :, 0] + x[:, :, 1]        # l ^ 1 (xor 4)
    out = x[:, 0]
    for w in range(1, 8):
        out = out + x[:, w]
    return out


def prep_reduce_plain(part: torch.Tensor, P: int, H: int) -> torch.Tensor:
    """Plain version of prep_reduce: (P, Kx) f32, plane p's partials (rows
    t + p of part for the row tiles t its rows lie in) added in tile order
    in f64 and rounded once."""
    p = torch.arange(P, device=part.device)
    t0, t1 = p * H // K1_ROWS, (p * H + H - 1) // K1_ROWS
    s = torch.zeros((P, part.shape[1]), dtype=torch.float64,
                    device=part.device)
    for k in range(int((t1 - t0).max()) + 1 if P else 0):
        live = (t0 + k <= t1)[:, None]
        s = s + torch.where(live, part[(t0 + k + p).clamp_max(
            part.shape[0] - 1)], 0.0)
    return s.to(torch.float32)


def stage1_energy_plain(ar: torch.Tensor, ai: torch.Tensor) -> torch.Tensor:
    """The column energies (P, Kx) f32 that K1 with prep="energies" and
    prep_reduce give, in plain torch and in their order: within an f32
    rounding of the exact sum, as stage2_prep_plain's, in another order."""
    P, H, _ = ar.shape
    return prep_reduce_plain(stage1_partials_plain(ar, ai), P, H)


def prep_reduce(part: torch.Tensor, P: int, H: int) -> torch.Tensor:
    """The column energies (P, Kx) f32 from K1's partials part
    (energy_slots(P, H), Kx) f64 (fwd_stage1 with prep="energies"). CUDA
    tensors launch csrc/corner_stage2.cu's reduce on the current stream
    (counted under KERNEL_PREP_REDUCE); CPU tensors take
    prep_reduce_plain."""
    name = KERNEL_PREP_REDUCE
    if part.dim() != 2:
        raise ValueError(f"{name}: part must be (slots, Kx), got "
                         f"{tuple(part.shape)}")
    _need(name, "part", part, torch.float64, (energy_slots(P, H),
                                              part.shape[1]))
    if _device(name, part, ()) == "cpu":
        return prep_reduce_plain(part, P, H)
    X = part.shape[1]
    energy = torch.empty((P, X), dtype=torch.float32, device=part.device)
    if P and X:
        _launch_stage2(name, part.device, "corner_stage2_prep_reduce",
                       part.data_ptr(), energy.data_ptr(), P, H, X)
    return energy


# --- stage 2: the prep, band and K2 kernels (csrc/corner_stage2.cu) ---------

# K2's band: split bf16 with three terms a value (x = x0 + x1 + x2, each
# bf16, x_{k+1} = bf16(x - x0 - .. - x_k)) and the six products T_i . a_j
# with i + j <= 2, the lowest-order first (the order the kernel sums them
# in): the TPU's Precision.HIGHEST emulation, within a few 2^-27 of |T||a|
# of the f32 product. SPLITS["bf16x3"] is the TPU's Precision.HIGH (two
# terms, three products), which plain versions keep for measurement.
SPLITS = {"bf16x6": ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)),
          "bf16x3": ((1, 0), (0, 1), (0, 0))}
# split bf16's error per term, of |T||a|: bf16 keeps 8 bits, |x - bf16(x)|
# <= 2^-9 |x|, so a k-term split x0 + .. leaves |x - sum| <= 2^-9k |x| and
# its term x_i is at most 2^-9i |x|. Two terms (bf16x3) drop T1.a1 and leave
# both residuals: 3 * 2^-18; three terms (bf16x6) drop T1.a2, T2.a1, T2.a2
# and leave both residuals: under 5 * 2^-27
SPLIT_REL = {"bf16x3": 3 * 2.0 ** -18, "bf16x6": 5 * 2.0 ** -27}
LEVELS = 3  # the terms of K2's split: stage2_tables and band_operand


def split_bf16(x: torch.Tensor, levels: int = LEVELS) -> list:
    """[x0, .., x_{levels-1}] bf16 with x_k = bf16(x - x0 - .. - x_{k-1})
    (each difference in f32, exact while the terms shrink)."""
    out, r = [], x.to(torch.float32)
    for _ in range(levels):
        out.append(r.to(torch.bfloat16))
        r = r - out[-1].to(torch.float32)
    return out


def stage2_tables(eyr: torch.Tensor, eyi: torch.Tensor) -> torch.Tensor:
    """K2's A operand, (LEVELS, 2*Kyp, 2*Hp) bf16 on the tables' device,
    Kyp = Ky and Hp = H rounded up to 64: the split_bf16 terms [T0, T1, T2]
    of the f32 real form of the y-stage's complex table,

        T = [[eyr, -eyi],     rows [0, Ky): cr;  rows [Kyp, Kyp + Ky): ci
             [eyi,  eyr]]     columns [0, H): ar's h; [Hp, Hp + H): ai's h

    with zeros in the padding. Rows run along the contraction h (K-major).
    T0's blocks are the bf16 tables themselves (negating is exact), the
    bulk's operand."""
    Ky, H = eyr.shape
    Kyp, Hp = _pad64(Ky), _pad64(H)
    t = torch.zeros((2 * Kyp, 2 * Hp), dtype=torch.float32,
                    device=eyr.device)
    t[:Ky, :H] = eyr
    t[:Ky, Hp:Hp + H] = -eyi
    t[Kyp:Kyp + Ky, :H] = eyi
    t[Kyp:Kyp + Ky, Hp:Hp + H] = eyr
    return torch.stack(split_bf16(t))


def pad_band(idx: torch.Tensor) -> torch.Tensor:
    """The band idx (P, n) int64 as K2 takes it: (P, 64 nb), nb = ceil(n /
    64), the columns past n copies of each row's last index (idx itself
    where n % 64 == 0)."""
    P, n = idx.shape
    w = -(-n // BAND) * BAND
    if w == n:
        return idx
    return torch.cat((idx, idx[:, -1:].expand(P, w - n)), 1).contiguous()


def static_band(P: int, n: int, device) -> torch.Tensor:
    """The static band [0, n) of every plane, padded (pad_band): (P, 64 nb)
    int64 on `device`."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return pad_band(idx.expand(P, n).contiguous())


def band_mask(idx: torch.Tensor, X: int) -> torch.Tensor:
    """(P, ceil(X / 32)) int32: bit x % 32 of word x // 32 is set where
    column x is one of the plane's band columns idx (P, n). K2's bulk
    epilogue stores no column whose bit is set."""
    P = idx.shape[0]
    nw = -(-X // 32)
    bits = torch.zeros((P, nw * 32), dtype=torch.int64, device=idx.device)
    bits.scatter_(1, idx, 1)
    weights = torch.arange(32, device=idx.device)
    return (bits.view(P, nw, 32) << weights).sum(-1).to(torch.int32)


def band_operand(ar: torch.Tensor, ai: torch.Tensor, idx: torch.Tensor,
                 levels: int = LEVELS) -> torch.Tensor:
    """K2's band B operand, (2*levels, P, H, n) bf16: the band columns
    idx (P, n) of ar and ai (P, H, Kx) f32 split into split_bf16 terms,
    in the order [ar0, ai0, ar1, ai1, ar2, ai2]."""
    P, H, _ = ar.shape
    gi = idx[:, None, :].expand(P, H, idx.shape[1])
    g = torch.stack((ar.gather(2, gi), ai.gather(2, gi)))
    return torch.cat(split_bf16(g, levels))


def stage2_prep_plain(ar: torch.Tensor, ai: torch.Tensor):
    """Plain version of stage2_prep: (ar.to(bf16), ai.to(bf16), energy),
    energy (P, Kx) f32 the column sums over h of ar*ar + ai*ai (each term
    rounded in f32, as eager torch rounds it), summed in f64 and rounded
    once to f32 — as the kernel sums, in another order."""
    sq = ar * ar + ai * ai
    energy = torch.sum(sq.to(torch.float64), dim=-2).to(torch.float32)
    return ar.to(torch.bfloat16), ai.to(torch.bfloat16), energy


def fwd_stage2_plain(ar: torch.Tensor, ai: torch.Tensor, idx: torch.Tensor,
                     tabs, band: str = "bf16x6", prep=None):
    """Plain version of fwd_stage2: (cr, ci) (P, Ky, Kx) f32 from the
    stage-1 output ar/ai (P, H, Kx) f32 and the band idx (P, n) int64, any
    n >= 0 (a column given twice takes the same value twice).
    Every column is the bf16 product T0 . [ar16; ai16] (one f32 product);
    the band columns are then replaced by the SPLITS[band] products
    sum_(i,j) T_i . a_j, one f32 product over the concatenated terms:
    band="bf16x6" is K2's spec, band="bf16x3" (two terms a value, the
    TPU's HIGH) is for measurement (tools/band_ber_torch.py).

    prep: stage2_prep's (ar16, ai16, ...) if the caller has them; tabs: the
    grid's corner.Tables (its stage2 table where it has one)."""
    if band not in SPLITS:
        raise ValueError(f"fwd_stage2_plain: band must be one of "
                         f"{tuple(SPLITS)}, got {band!r}")
    P, H, X = ar.shape
    Ky = tabs.eyr.shape[0]
    X0 = idx.shape[1]
    ar16, ai16 = (prep or stage2_prep_plain(ar, ai))[:2]
    f32 = torch.float32
    pairs = SPLITS[band]
    levels = 1 + max(i for i, _ in pairs)
    t = tabs.stage2 if getattr(tabs, "stage2", None) is not None else \
        stage2_tables(tabs.eyr, tabs.eyi)
    Kyp, Hp = t.shape[1] // 2, t.shape[2] // 2
    ts = [torch.cat((t[i, :, :H], t[i, :, Hp:Hp + H]), 1).to(f32)
          for i in range(levels)]                              # (2Kyp, 2H)
    out = ts[0] @ torch.cat((ar16, ai16), 1).to(f32)           # (P, 2Kyp, X)
    cr, ci = out[:, :Ky].contiguous(), out[:, Kyp:Kyp + Ky].contiguous()
    del out
    g = band_operand(ar, ai, idx, levels).to(f32)      # (2 lv, P, H, X0)
    a = [torch.cat((g[2 * j], g[2 * j + 1]), 1)        # (P, 2H, X0)
         for j in range(levels)]
    h = (torch.cat([ts[i] for i, _ in pairs], 1)
         @ torch.cat([a[j] for _, j in pairs], 1))      # (P, 2Kyp, X0)
    si = idx[:, None, :].expand(P, Ky, X0)
    cr.scatter_(2, si, h[:, :Ky])
    ci.scatter_(2, si, h[:, Kyp:Kyp + Ky])
    return cr, ci


def band_error(cr: torch.Tensor, ci: torch.Tensor, ar: torch.Tensor,
               ai: torch.Tensor, idx: torch.Tensor, tabs) -> float:
    """The RMS, over every element of (cr, ci) (P, Ky, Kx) in the band
    columns idx (P, n), of its error against the f64 product of the f32
    tables (tabs.eyr, tabs.eyi) with the f32 stage-1 output ar/ai (P, H,
    Kx), each on its own scale sum_h |T||a|. A split leaves at most
    SPLIT_REL[band] of that scale at each element; f32 sums add noise whose
    RMS lies well below SPLIT_REL["bf16x6"], where two terms (bf16x3) leave
    several times it. So RMS <= SPLIT_REL["bf16x6"] holds a band to three
    terms."""
    P, H, _ = ar.shape
    Ky, n = cr.shape[1], idx.shape[1]
    f64 = torch.float64
    gi = idx[:, None, :].expand(P, H, n)
    a, b = ar.gather(2, gi).to(f64), ai.gather(2, gi).to(f64)
    eyr, eyi = tabs.eyr.to(f64), tabs.eyi.to(f64)
    go = idx[:, None, :].expand(P, Ky, n)
    ar_, ai_, er_, ei_ = a.abs(), b.abs(), eyr.abs(), eyi.abs()
    tiny = torch.finfo(f64).tiny
    sq = 0.0
    for c, exact, scale in ((cr, eyr @ a - eyi @ b, er_ @ ar_ + ei_ @ ai_),
                            (ci, eyr @ b + eyi @ a, er_ @ ai_ + ei_ @ ar_)):
        d = (c.gather(2, go).to(f64) - exact) / scale.clamp_min(tiny)
        sq += d.pow(2).sum().item()
    return (sq / (2 * go.numel())) ** 0.5


def bulk_error(cr: torch.Tensor, ci: torch.Tensor, ar16: torch.Tensor,
               ai16: torch.Tensor, idx: torch.Tensor, tabs,
               planes: int = 24) -> float:
    """The RMS, over the bulk (not band) columns of the first `planes`
    planes of (cr, ci) (P, Ky, Kx), of their error against the exact (f64)
    sum of the same bf16 products eyr16 . ar16 - eyi16 . ai16 (and ci's):
    the error of the bulk's sum order alone, in the spectrum's units."""
    n = min(planes, cr.shape[0])
    Kx = cr.shape[2]
    keep = torch.ones((n, 1, Kx), dtype=torch.bool, device=cr.device)
    keep.scatter_(2, idx[:n, None, :], False)
    keep = keep.expand(n, cr.shape[1], Kx)
    eyr, eyi = tabs.eyr16.double(), tabs.eyi16.double()
    a, b = ar16[:n].double(), ai16[:n].double()
    sq = 0.0
    for c, exact in ((cr, eyr @ a - eyi @ b), (ci, eyr @ b + eyi @ a)):
        sq += (c[:n].double() - exact)[keep].pow(2).sum().item()
    return (sq / (2 * keep.sum().item())) ** 0.5


# --- the checks every kernel wrapper makes --------------------------------

def _device(name: str, first: torch.Tensor, tensors) -> str:
    """"cpu" or "cuda" for the call: every tensor argument on first's
    device; any other device raises."""
    dev = first.device
    for t in tensors:
        if t is not None and isinstance(t, torch.Tensor) and t.dim() and \
                t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _need(name: str, what: str, t, dtype, shape) -> None:
    """Raise unless t is a contiguous tensor of `dtype` and `shape`."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stage1_output(name: str, ar, ai, *others) -> str:
    """Check the stage-1 output ar/ai: contiguous f32 (P, H, Kx) on one
    device with `others`; "cpu" or "cuda"."""
    kind = _device(name, ar, (ai, *others))
    if ar.dim() != 3:
        raise ValueError(f"{name}: ar must be (P, H, Kx), got "
                         f"{tuple(ar.shape)}")
    _need(name, "ar", ar, torch.float32, ar.shape)
    _need(name, "ai", ai, torch.float32, ar.shape)
    return kind


def _launch_stage2(name: str, device, entry: str, *args) -> None:
    """Launch csrc/corner_stage2.cu's C entry `entry` on `device`'s
    current stream (pointers and ints in args), raise on its error code,
    count the launch under `name`."""
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.kernel_library(), entry)(*args, stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1


def stage2_prep(ar: torch.Tensor, ai: torch.Tensor):
    """(ar16, ai16, energy) of the stage-1 output ar/ai (P, H, Kx) f32:
    bf16 copies (P, H, Kx) equal to ar.to(bf16) and ai.to(bf16), and the
    column energies (P, Kx) f32 (stage2_prep_plain). CUDA tensors launch
    csrc/corner_stage2.cu's prep kernel on the current stream (ar16 and ai16
    are then views whose rows are padded to 16 bytes, the row stride TMA
    reads); CPU tensors take stage2_prep_plain."""
    name = KERNEL_PREP
    if _stage1_output(name, ar, ai) == "cpu":
        return stage2_prep_plain(ar, ai)
    P, H, X = ar.shape
    buf = _copies(P, H, X, ar.device)
    energy = torch.empty((P, X), dtype=torch.float32, device=ar.device)
    if ar.numel():
        _launch_stage2(name, ar.device, "corner_stage2_prep", ar.data_ptr(),
                       ai.data_ptr(), buf.data_ptr(), buf[1].data_ptr(),
                       energy.data_ptr(), P, H, X, buf.shape[-1])
    return buf[0, ..., :X], buf[1, ..., :X], energy


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """t (P, H, X) bf16 as K2's TMA reads it: unit column stride, rows a
    multiple of 8 values (16 bytes) apart, planes H rows apart, a 16-byte
    aligned base; a copy with zero-padded rows where t is not."""
    P, H, X = t.shape
    ld = t.stride(1)
    if (t.stride(2) == 1 and ld >= X and ld % 8 == 0 and t.stride(0) == H * ld
            and t.data_ptr() % 16 == 0):
        return t
    out = torch.zeros((P, H, -(-X // 8) * 8), dtype=t.dtype, device=t.device)
    out[..., :X] = t
    return out[..., :X]


def _band_idx(name: str, idx: torch.Tensor, P: int, empty: bool) -> int:
    """Check a band idx (P, 64 nb) contiguous int64 and return nb; nb = 0
    (a (P, 0) idx) only where `empty`."""
    if idx.dim() != 2:
        raise ValueError(f"{name}: idx must be (P, 64 nb), got "
                         f"{tuple(idx.shape)}")
    _need(name, "idx", idx, torch.int64, (P, idx.shape[1]))
    nb, rest = divmod(idx.shape[1], BAND)
    if rest or not (nb or empty):
        raise ValueError(f"{name}: idx must hold 64 nb columns a plane, nb "
                         f">= {0 if empty else 1} (pad_band), got "
                         f"{idx.shape[1]}")
    return nb


def stage2_band(ar: torch.Tensor, ai: torch.Tensor, idx: torch.Tensor):
    """(band_operand(ar, ai, idx), band_mask(idx, Kx)): K2's band operand
    (2*LEVELS, P, H, 64 nb) bf16 and column mask (P, ceil(Kx/32)) int32 from
    the stage-1 output ar/ai (P, H, Kx) f32 and the band idx (P, 64 nb)
    int64 (pad_band), nb >= 1, each index in [0, Kx). CUDA tensors launch
    csrc/corner_stage2.cu's band kernel on the current stream (one pass:
    gather, split, mask); CPU tensors take band_operand and band_mask."""
    name = KERNEL_BAND
    kind = _stage1_output(name, ar, ai, idx)
    P, H, X = ar.shape
    nb = _band_idx(name, idx, P, False)
    if kind == "cpu":
        return band_operand(ar, ai, idx), band_mask(idx, X)
    g = torch.empty((2 * LEVELS, P, H, BAND * nb), dtype=torch.bfloat16,
                    device=ar.device)
    mask = torch.empty((P, -(-X // 32)), dtype=torch.int32, device=ar.device)
    if P and H:
        _launch_stage2(name, ar.device, "corner_stage2_band", ar.data_ptr(),
                       ai.data_ptr(), idx.data_ptr(), g.data_ptr(),
                       mask.data_ptr(), P, H, X, nb)
    return g, mask


def stage2_grid(P: int, Kx: int, Ky: int, device=None, nb: int = 1,
                bulk: bool = True) -> int:
    """The grid K2 launches on `device` (default: the current card) for P
    planes of a Ky x Kx corner with nb band groups and (`bulk`) the bulk:
    in blocks, clusters of STAGE2_CLUSTER, as many as the card holds at
    once and no more than the kernel's units of work; raises where the card
    has no room for one."""
    from steganosaurus_tpu_torch import _build

    with torch.cuda.device(device):
        grid = _build.kernel_library().corner_stage2_grid(
            P, Kx, _pad64(Ky), nb, int(bool(bulk)))
    _check_rc(KERNEL_STAGE2, -min(grid, 0))
    return grid


def fwd_stage2(ar: torch.Tensor, ai: torch.Tensor, ar16, ai16,
               idx: torch.Tensor, tabs, band):
    """Forward stage 2: (cr, ci) (P, Ky, Kx) f32 from the stage-1 output
    ar/ai (P, H, Kx) f32, stage2_prep's bf16 copies ar16 / ai16, the band
    idx (P, 64 nb) int64 (pad_band; nb >= 0) and band = stage2_band(ar, ai,
    idx) (None where nb = 0: the bulk alone), with the grid's corner.Tables
    (eyr (Ky, H); on CUDA its stage2 table). ar16 = ai16 = None runs no
    bulk: idx must then hold every column of [0, Kx) (static_band(P, Kx)),
    which the band computes. CUDA tensors launch K2 (csrc/corner_stage2.cu)
    on the current stream; CPU tensors take fwd_stage2_plain(band="bf16x6")."""
    name = KERNEL_STAGE2
    g, mask = band if band is not None else (None, None)
    kind = _stage1_output(name, ar, ai, ar16, ai16, idx, tabs.eyr, g, mask)
    P, H, X = ar.shape
    Ky = tabs.eyr.shape[0]
    bulk = ar16 is not None
    if bulk != (ai16 is not None):
        raise ValueError(f"{name}: give both bf16 copies or neither")
    for what, t in (("ar16", ar16), ("ai16", ai16)):  # views: any strides
        if bulk and (t.dtype != torch.bfloat16
                     or tuple(t.shape) != (P, H, X)):
            raise ValueError(f"{name}: {what} must be bf16 {(P, H, X)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    nb = _band_idx(name, idx, P, bulk)
    if not bulk and BAND * nb < X:
        raise ValueError(f"{name}: without the bulk the band must hold "
                         f"every column (Kx={X}), got {BAND * nb}")
    if (band is None) != (nb == 0):
        raise ValueError(f"{name}: a band of {nb} groups needs "
                         f"{'a' if nb else 'no'} band operand")
    _need(name, "eyr", tabs.eyr, torch.float32, (Ky, H))
    if nb:
        _need(name, "the band operand", g, torch.bfloat16,
              (2 * LEVELS, P, H, BAND * nb))
        _need(name, "the band mask", mask, torch.int32, (P, -(-X // 32)))
    if kind == "cpu":
        return fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6",
                                (ar16, ai16) if bulk else None)
    t2 = tabs.stage2
    if t2 is None:
        raise ValueError(f"{name}: the tables carry no stage-2 table")
    Kyp, Hp = _pad64(Ky), _pad64(H)
    _need(name, "the stage-2 table", t2, torch.bfloat16,
          (LEVELS, 2 * Kyp, 2 * Hp))
    _device(name, ar, (t2,))
    cr = torch.empty((P, Ky, X), dtype=torch.float32, device=ar.device)
    ci = torch.empty((P, Ky, X), dtype=torch.float32, device=ar.device)
    if P:
        ldr = ldi = 0
        if bulk:
            ar16, ai16 = _tma_rows(ar16), _tma_rows(ai16)
            ldr, ldi = ar16.stride(1), ai16.stride(1)
        # what a launch does not read goes as a null pointer
        ptrs = [None if t is None else t.data_ptr()
                for t in (ar16, ai16, g, mask, idx if nb else None)]
        _launch_stage2(name, ar.device, "corner_stage2", t2.data_ptr(),
                       *ptrs, cr.data_ptr(), ci.data_ptr(), P, H, X, Ky,
                       Kyp, Hp, ldr, ldi, nb, int(bulk))
        BAND_WIDTHS[BAND * nb] += 1
    return cr, ci
