"""Corner-restricted spectral embed/extract math (the 4K fast path), in torch.

The port's twin of steganosaurus_tpu/spectral/corner.py; its module
docstring has the derivation. Every walk bin lives in the [0, Ky) x [0, Kx)
top-left corner of the spectrum, so

    stego = planes + real(IFFT2(Delta)),   supp(Delta) subset corner,

and both directions are pruned-DFT matmuls plus dense elementwise math over
the corner. Complex values are (re, im) f32 pairs, as in the JAX package.

Precision modes (STEGANOSAURUS_MM_PRECISION), the JAX package's names:
precision() resolves one to a Precision, the precision of each of the four
stages (stage 1, forward stage 2, the inverse's y-stage, its x-stage):

  mode              stage 1   fwd stage 2            inverse y  inverse x
  mix_adaptive      bf16      bf16 + top-X0 band     bf16       bf16
  mix_split         bf16      bf16 + band [0, X0)    bf16       bf16
  mix, mix3         bf16      high                   bf16       bf16
  mix2              bf16      high                   high       bf16
  mix_conservative  bf16      high                   high       high
  bf16              bf16      bf16                   bf16       bf16
  high              high      high                   high       high
  highest           highest   highest                highest    highest

X0 is split_x0() (STEGANOSAURUS_SPLIT_X0, default 64; X0 >= Kx runs the
whole stage at high, X0 = 0 in bf16). Any other name raises (the JAX
package runs it as highest). What each precision runs:
- "bf16": bf16 operands with an f32 result. Stage 1 through the K1 kernel
  (corner_kernels.fwd_stage1), the inverse's y-stage through K6 and its
  x-stage with the u8 epilogue through K4 (write_kernels); on the CPU the
  JAX package's own emulation, bf16 rounding of both operands followed by
  an f32 matmul. A plain bf16 matmul would return bf16 and round 1e6-scale
  spectra to ~±2000 next to ~1e4-scale walk signals, so it is never used.
- forward stage 2: on CUDA the prep (in K1's epilogue where stage 1 is
  bf16: stage1_prep), band and K2 kernels (corner_kernels), the band in
  split bf16 (three terms, six products: the
  port's HIGH, since the TPU's two-term form flipped a Rep-7 group on the
  4K benchmark), the bulk in bf16; "high" is every column in the band. On
  the CPU _fwd_y_split: the band, and "high", as f32 products, as the JAX
  package computes Precision.HIGH on the CPU.
- "high" in the other stages, and "highest": f32 products
  (torch.matmul with TF32 off, runtime.configure_precision), then, where
  the x-stage is f32, the u8 epilogue through K4e. f32 is at least as
  accurate as the TPU's three-pass HIGH.
"""

from __future__ import annotations

import functools
import math
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from steganosaurus_tpu_torch import spectral
from steganosaurus_tpu_torch.spectral import corner_kernels

class Precision(NamedTuple):
    """A precision mode resolved to its stages: `name`, then the precision
    of stage 1, forward stage 2, the inverse's y-stage and its x-stage,
    each "bf16", "high" or "highest" (fwd2 also "split" or "adaptive": bf16
    with a static or top-energy band at high)."""
    name: str
    stage1: str
    fwd2: str
    inv_y: str
    inv_x: str


STAGE_PRECISIONS = ("bf16", "high", "highest")
_MODES = {
    "mix_split": ("bf16", "split", "bf16", "bf16"),
    "mix_adaptive": ("bf16", "adaptive", "bf16", "bf16"),
    "mix": ("bf16", "high", "bf16", "bf16"),
    "mix3": ("bf16", "high", "bf16", "bf16"),
    "mix2": ("bf16", "high", "high", "bf16"),
    "mix_conservative": ("bf16", "high", "high", "high"),
    "bf16": ("bf16",) * 4,
    "high": ("high",) * 4,
    "highest": ("highest",) * 4,
}
MODES = tuple(_MODES)
_warned_bf16 = False


def resolve(name: str) -> Precision:
    """The Precision of the mode `name` (case-insensitive); an unknown name
    raises. "bf16" prints, once a process, that it breaks 4K/16 KB
    recovery."""
    global _warned_bf16
    name = name.lower()
    if name not in _MODES:
        raise ValueError(f"STEGANOSAURUS_MM_PRECISION={name!r}: not one of "
                         f"{MODES}")
    if name == "bf16" and not _warned_bf16:
        _warned_bf16 = True
        print("steganosaurus_tpu_torch: STEGANOSAURUS_MM_PRECISION=bf16 runs "
              "the forward stage-2 contraction in bf16, which is MEASURED to "
              "break 4K/16KB payload recovery (operand dynamic range ~1e6 vs "
              "~1e4 signal) — measurement mode only, not for real embeds",
              file=sys.stderr)
    return Precision(name, *_MODES[name])


def precision() -> Precision:
    """The corner DFT precision mode in force (STEGANOSAURUS_MM_PRECISION,
    default mix_adaptive), resolved."""
    return resolve(os.environ.get("STEGANOSAURUS_MM_PRECISION",
                                  "mix_adaptive"))


def stages(mode) -> Precision:
    """A Precision, or a mode name resolved."""
    return mode if isinstance(mode, Precision) else resolve(mode)


def _stage(mode, field: str) -> str:
    """The precision of stage `field` under `mode`: a Precision, a mode
    name, or a stage precision itself (STAGE_PRECISIONS, each also the name
    of the mode that runs every stage so)."""
    if isinstance(mode, Precision):
        return getattr(mode, field)
    if mode in STAGE_PRECISIONS:
        return mode
    return getattr(resolve(mode), field)


# The default width of the forward stage-2 band (split_x0)
SPLIT_X0 = 64


def split_x0() -> int:
    """Width of the forward stage-2 band under mix_split and mix_adaptive
    (STEGANOSAURUS_SPLIT_X0, default SPLIT_X0)."""
    x0 = int(os.environ.get("STEGANOSAURUS_SPLIT_X0", str(SPLIT_X0)))
    if x0 < 0:
        raise ValueError(f"STEGANOSAURUS_SPLIT_X0={x0}: must be >= 0")
    return x0


def corner_dims(H: int, W: int, rmax: float) -> tuple[int, int]:
    """(Ky, Kx) corner covering every walk-accepted primary bin: K =
    floor(rmax*min(H, W)) + 1 rounded up to 256, clamped to the grid."""
    b = int(math.floor(rmax * min(H, W))) + 1
    k = -(-b // 256) * 256
    return min(k, H), min(k, W)


@functools.lru_cache(maxsize=16)
def _dft_tables(N: int, K: int):
    """Host numpy (K, N) f32 tables (re, im) of exp(+2j*pi*k*n/N) — the
    reference's forward sign, the conjugate of numpy's and torch.fft's. The
    angle is reduced with an exact int64 mod before the f32 cast, the same
    recipe as steganosaurus_tpu.spectral.corner._dft_tables (equal bits,
    tests/test_torch_corner.py)."""
    k = np.arange(K, dtype=np.int64)[:, None]
    n = np.arange(N, dtype=np.int64)[None, :]
    ang = ((k * n) % N).astype(np.float32) * np.float32(2.0 * math.pi / N)
    return np.cos(ang, dtype=np.float32), np.sin(ang, dtype=np.float32)


class Tables(NamedTuple):
    """Device DFT tables for one (H, W) grid's (Ky, Kx) corner: y-axis
    (Ky, H) and x-axis (Kx, W), in f32 and in bf16; and, on CUDA, the
    stage-1 kernel's concatenated x-axis table, plain and (-1)^w-folded
    (corner_kernels.stage1_tables), the K4 kernel's inverse x-axis table
    (ifft_x_table), the K2 kernel's split terms [T0, T1, T2]
    (corner_kernels.stage2_tables) and the K6 kernel's inverse y-axis
    table (ifft_y_table); all four None on other devices."""
    eyr: torch.Tensor
    eyi: torch.Tensor
    exr: torch.Tensor
    exi: torch.Tensor
    eyr16: torch.Tensor
    eyi16: torch.Tensor
    exr16: torch.Tensor
    exi16: torch.Tensor
    stage1: tuple | None
    ifft_x: torch.Tensor | None
    stage2: torch.Tensor | None
    ifft_y: torch.Tensor | None


def ifft_x_table(exr16: torch.Tensor, exi16: torch.Tensor) -> torch.Tensor:
    """The K4 kernel's B operand (write_kernels.ifft_epilogue): the x-stage
    table [exr16; -exi16], (2*Kxp, Wp) with Kxp = Kx and Wp = W rounded up
    to 64 and zeros in the padding, stored transposed as a contiguous
    (Wp, 2*Kxp) bf16 tensor so that the contraction is its contiguous axis
    (wgmma's K-major B). Negating bf16 is exact, so with A = [mr, mi] it
    gives mr @ exr16 - mi @ exi16 term by term."""
    Kx, W = exr16.shape
    Kxp, Wp = corner_kernels._pad64(Kx), corner_kernels._pad64(W)
    t = torch.zeros((Wp, 2 * Kxp), dtype=torch.bfloat16, device=exr16.device)
    t[:W, :Kx] = exr16.T
    t[:W, Kxp:Kxp + Kx] = -exi16.T
    return t


def ifft_y_table(eyr16: torch.Tensor, eyi16: torch.Tensor) -> torch.Tensor:
    """The K6 kernel's A operand (write_kernels.ifft_y): the real form of
    the inverse y-stage's complex table,

        A = [[eyr16^T, -eyi16^T],     rows [0, H): mr;  [Hp, Hp + H): mi
             [eyi16^T,  eyr16^T]]     columns [0, Ky): Re D's y;
                                      [Kyp, Kyp + Ky): -Im D's y

    a contiguous (2*Hp, 2*Kyp) bf16 tensor with Hp = H and Kyp = Ky rounded
    up to 64 and zeros in the padding, the contraction y its contiguous axis
    (wgmma's K-major A). Negating bf16 is exact, so its terms are the values
    the eager y-stage multiplies (_ifft_y)."""
    Ky, H = eyr16.shape
    Kyp, Hp = corner_kernels._pad64(Ky), corner_kernels._pad64(H)
    t = torch.zeros((2 * Hp, 2 * Kyp), dtype=torch.bfloat16,
                    device=eyr16.device)
    t[:H, :Ky] = eyr16.T
    t[:H, Kyp:Kyp + Ky] = -eyi16.T
    t[Hp:Hp + H, :Ky] = eyi16.T
    t[Hp:Hp + H, Kyp:Kyp + Ky] = eyr16.T
    return t


_DEV_TABLES: dict = {}


def dft_tables_device(H: int, Ky: int, W: int, Kx: int, device) -> Tables:
    """Tables for (H, W) -> (Ky, Kx) on `device`, built once per shape and
    device and cached: each device of a mesh gets its own (the K1 tables
    included), and logical shards of one card share one entry ("cuda" is
    keyed as the current card's index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (H, Ky, W, Kx, device)
    ent = _DEV_TABLES.get(key)
    if ent is None:
        f32 = [torch.from_numpy(a).to(device)
               for a in _dft_tables(H, Ky) + _dft_tables(W, Kx)]
        b16 = [a.to(torch.bfloat16) for a in f32]
        cuda = device.type == "cuda"
        s1 = corner_kernels.stage1_tables(b16[2], b16[3]) if cuda else None
        ix = ifft_x_table(b16[2], b16[3]) if cuda else None
        s2 = corner_kernels.stage2_tables(f32[0], f32[1]) if cuda else None
        iy = ifft_y_table(b16[0], b16[1]) if cuda else None
        ent = Tables(*f32, *b16, s1, ix, s2, iy)
        _DEV_TABLES[key] = ent
        while len(_DEV_TABLES) > 16:
            _DEV_TABLES.pop(next(iter(_DEV_TABLES)))
    return ent


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with bf16 operands and an f32 result. Shapes: 2-D @ 2-D,
    2-D @ (P, k, n) (shared left operand), (P, m, k) @ 2-D (rows folded
    into one GEMM), or (P, ., .) @ (P, ., .)."""
    a16 = a.to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    if a16.device.type == "cpu":
        return torch.matmul(a16.to(torch.float32), b16.to(torch.float32))
    f32 = torch.float32
    if a16.dim() == 2 and b16.dim() == 2:
        return torch.mm(a16, b16, out_dtype=f32)
    if a16.dim() == 2:
        return torch.bmm(a16.expand(b16.shape[0], *a16.shape), b16,
                         out_dtype=f32)
    if b16.dim() == 2:
        P, m, k = a16.shape
        return torch.mm(a16.reshape(P * m, k), b16,
                        out_dtype=f32).reshape(P, m, b16.shape[1])
    return torch.bmm(a16, b16, out_dtype=f32)


def fwd_corner(imgs_u8: torch.Tensor, center: bool, Ky: int, Kx: int,
               tabs: Tables, mode):
    """u8 images (..., H, W) -> corner spectrum (re, im) (..., Ky, Kx) of
    the (optionally centered) planes:

        C[y, x] = sum_{h,w} planes[h,w] * e^{+2pi*i*(yh/H + xw/W)}.

    Stage 1 contracts w (the widest GEMM) — in bf16 through the K1 kernel
    wrapper, which reads the u8 images directly — and stage 2 contracts h
    (_fwd_y). mode: a Precision or a mode name."""
    p = stages(mode)
    H, W = imgs_u8.shape[-2:]
    lead = imgs_u8.shape[:-2]
    x = imgs_u8.reshape(-1, H, W)
    prep = None
    if p.stage1 == "bf16":
        want = stage1_prep(p.fwd2, Kx) if _on_card(x) else None
        ar, ai, *rest = corner_kernels.fwd_stage1(
            x, tabs.exr16, tabs.exi16, center, tabs.stage1, want)
        prep = rest[0] if rest else None
    else:
        planes = spectral.apply_center(x.to(torch.float32), center)
        ar = planes @ tabs.exr.T
        ai = planes @ tabs.exi.T
        del planes
    cr, ci = _fwd_y(ar, ai, tabs, p.fwd2, prep)
    return cr.reshape(*lead, Ky, Kx), ci.reshape(*lead, Ky, Kx)


def stage1_prep(fwd2: str, Kx: int) -> str | None:
    """What K1 hands forward stage 2 at precision `fwd2` (Precision.fwd2)
    for a Kx-wide corner on the card, besides ar and ai
    (corner_kernels.PREPS): where stage 2 has a bulk, the bf16 copies, and
    the column energies too where they pick its band ("adaptive" with a
    band); None where it has no bulk (every column in the band, or f32
    products)."""
    X0 = band_width(fwd2, Kx)
    if X0 is None or X0 >= Kx:
        return None
    return "energies" if fwd2 == "adaptive" and X0 else "copies"


def band_width(fwd2: str, Kx: int) -> int | None:
    """The columns of forward stage 2's high band at precision `fwd2`
    (Precision.fwd2) for a Kx-wide corner: split_x0() (at most Kx) under
    "split" and "adaptive", Kx under "high", 0 under "bf16"; None under
    "highest" (f32 products, no band)."""
    if fwd2 == "highest":
        return None
    if fwd2 in ("split", "adaptive"):
        return min(split_x0(), Kx)
    if fwd2 not in ("high", "bf16"):
        raise ValueError(f"forward stage 2: unknown precision {fwd2!r}")
    return Kx if fwd2 == "high" else 0


def _fwd_y(ar: torch.Tensor, ai: torch.Tensor, tabs: Tables, fwd2: str,
           prep=None):
    """Forward stage 2 at precision `fwd2` (Precision.fwd2): f32 products
    under "highest"; else a band of band_width(fwd2) columns at high and
    the rest in bf16: the columns [0, X0) under "split", the top-X0 energy
    columns under "adaptive". CPU tensors take _fwd_y_split, CUDA tensors
    the kernels (_fwd_y_kernels), with stage 1's `prep` where K1 made it."""
    X0 = band_width(fwd2, ar.shape[-1])
    if X0 is None:
        return (tabs.eyr @ ar - tabs.eyi @ ai,
                tabs.eyr @ ai + tabs.eyi @ ar)
    adaptive = fwd2 == "adaptive"
    if not _on_card(ar):
        return _fwd_y_split(ar, ai, tabs, X0, adaptive)
    return _fwd_y_kernels(ar, ai, tabs, X0, adaptive, prep=prep)


def _on_card(t: torch.Tensor) -> bool:
    """Whether the forward DFT takes the card's route (K1's prep, the
    stage-2 kernels) for tensor t: CUDA tensors. The tests run that route
    on CPU tensors, whose wrappers take their plain versions, by making
    this true."""
    return t.device.type == "cuda"


def _fwd_y_kernels(ar: torch.Tensor, ai: torch.Tensor, tabs: Tables,
                   X0: int, adaptive: bool, prep=None):
    """Forward stage 2 on the card with a band of X0 columns: the prep
    (bf16 copies and column energies: `prep`, the (ar16, ai16, energy)
    that K1 made with stage1_prep's request, else the prep kernel), the
    band (band_topk of the energies where `adaptive`, else [0, X0); padded
    to 64 nb columns), the band kernel (the band columns' bf16 terms and
    mask) and K2. X0 = 0 runs K2's bulk alone; X0 >= Kx the band kernel and
    K2's band alone, every column in it (no bf16 copies)."""
    P, _, X = ar.shape
    ck = corner_kernels
    if X0 >= X:
        idx = ck.static_band(P, X, ar.device)
        return ck.fwd_stage2(ar, ai, None, None, idx, tabs,
                             ck.stage2_band(ar, ai, idx))
    ar16, ai16, energy = prep if prep is not None else ck.stage2_prep(ar, ai)
    if X0 == 0:
        idx = torch.empty((P, 0), dtype=torch.int64, device=ar.device)
        return ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, None)
    if adaptive:
        idx = ck.pad_band(band_topk(energy, X0))
    else:
        idx = ck.static_band(P, X0, ar.device)
    del energy
    band = ck.stage2_band(ar, ai, idx)
    return ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, band)


def band_topk(energy: torch.Tensor, X0: int) -> torch.Tensor:
    """(P, X0) int64 indices of the X0 columns of highest energy per
    (image, plane)."""
    return torch.topk(energy, X0, dim=-1).indices


def band_columns(ar: torch.Tensor, ai: torch.Tensor, X0: int) -> torch.Tensor:
    """(P, X0) indices of the X0 stage-1 columns of highest energy
    sum_h(ar^2 + ai^2) in each (image, plane) — the forward stage-2 band that
    runs in full f32 on the CPU. torch.topk and lax.top_k may order ties
    differently; that changes stego bytes, never decoded bits."""
    energy = torch.sum(ar * ar + ai * ai, dim=-2)              # (P, X)
    return torch.topk(energy, X0, dim=-1).indices


def _bf16_y(ar: torch.Tensor, ai: torch.Tensor, tabs: Tables):
    """Forward stage 2 in bf16: four bf16 products into f32, a difference
    and a sum, as the JAX package's "bf16" einsums."""
    ar16, ai16 = ar.to(torch.bfloat16), ai.to(torch.bfloat16)
    return (_mm_bf16(tabs.eyr16, ar16) - _mm_bf16(tabs.eyi16, ai16),
            _mm_bf16(tabs.eyr16, ai16) + _mm_bf16(tabs.eyi16, ar16))


def _fwd_y_split(ar: torch.Tensor, ai: torch.Tensor, tabs: Tables,
                 X0: int | None = None, adaptive: bool = True):
    """Forward stage 2 (contract h) with the column split
    (steganosaurus_tpu.spectral.corner._fwd_y_split), its band in f32.

    ar/ai: (P, H, Kx). A bf16 rounding error in stage-1 column x lands only
    in output column x, with size ~2^-9 times that column's energy, so the
    band of X0 columns (default split_x0()) is contracted in full f32 and
    every other column in bf16. adaptive: the band is the top-X0 columns by
    energy sum_h(ar^2 + ai^2) per (image, plane), gathered with
    torch.gather and written over the bf16 result with scatter_ — the same
    exact select the JAX package builds from one-hot matmuls; else the
    static [0, X0), each side of it contracted alone and the two
    concatenated, as the JAX package does. X0 >= Kx runs the whole stage in
    f32 (the JAX package's degenerate case), X0 = 0 in bf16."""
    P, H, X = ar.shape
    X0 = min(split_x0() if X0 is None else X0, X)
    if X0 == X:  # the whole stage at full precision
        return (tabs.eyr @ ar - tabs.eyi @ ai,
                tabs.eyr @ ai + tabs.eyi @ ar)
    if X0 == 0:
        return _bf16_y(ar, ai, tabs)
    if not adaptive:
        lo = (tabs.eyr @ ar[..., :X0] - tabs.eyi @ ai[..., :X0],
              tabs.eyr @ ai[..., :X0] + tabs.eyi @ ar[..., :X0])
        hi = _bf16_y(ar[..., X0:], ai[..., X0:], tabs)
        return (torch.cat((lo[0], hi[0]), -1),
                torch.cat((lo[1], hi[1]), -1))
    idx = band_columns(ar, ai, X0)                             # (P, X0)
    gi = idx[:, :, None].expand(P, X0, H)
    agr = ar.transpose(1, 2).gather(1, gi)                     # (P, X0, H)
    agi = ai.transpose(1, 2).gather(1, gi)
    cr, ci = _bf16_y(ar, ai, tabs)                             # (P, Ky, X)
    hr = agr @ tabs.eyr.T - agi @ tabs.eyi.T                   # (P, X0, Ky)
    hi = agi @ tabs.eyr.T + agr @ tabs.eyi.T
    si = idx[:, None, :].expand(P, cr.shape[1], X0)
    cr.scatter_(2, si, hr.transpose(1, 2))
    ci.scatter_(2, si, hi.transpose(1, 2))
    return cr, ci


def ifft_corner_real(dr: torch.Tensor, di: torch.Tensor, H: int, W: int,
                     tabs: Tables, mode, scale: bool = True,
                     conjugated: bool = False) -> torch.Tensor:
    """real(IFFT2(Delta)) for a corner-supported Delta = (dr, di) of shape
    (..., Ky, Kx) -> (..., H, W) f32.

    Under the reference convention this is (1/(H*W)) * Re(sum conj(Delta)
    [y,x] e^{+2pi*i*(yh/H + xw/W)}): with Dc = (dr, -di), M = Ey^T @ Dc
    (contract y), then Re(M @ Ex) (contract x), each stage at mode's
    precision (a Precision or a mode name; inv_y and inv_x): bf16 products,
    or f32 under high and highest.
    scale=False leaves out the 1/(H*W) factor, for a caller that applies it
    itself (the embed cores' u8 epilogue, write_kernels.epilogue).
    conjugated=True: (dr, di) is Dc itself, (Re Delta, -Im Delta), taken as
    it is (no negation; bf16 operands, as the K3 kernel stores them, are
    not cast again)."""
    lead = dr.shape[:-2]
    mr, mi = _ifft_y(dr, di, tabs, _stage(mode, "inv_y"), conjugated)
    if _stage(mode, "inv_x") == "bf16":
        t = _mm_bf16(mr, tabs.exr16)
        t -= _mm_bf16(mi, tabs.exi16)
    else:
        t = mr @ tabs.exr
        t -= mi @ tabs.exi
    if scale:
        t *= 1.0 / (H * W)
    return t.reshape(*lead, H, W)


def _ifft_y(dr, di, tabs: Tables, mode, conjugated: bool):
    """The inverse DFT's y-stage, M = Ey^T @ Dc (contract y): (mr, mi)
    (P, H, Kx) f32 from (dr, di) (..., Ky, Kx) at mode's inv_y precision
    (bf16 operands, or f32 products): the eager chain (four products, a
    difference, a sum) of ifft_corner_real, and in bf16 also the plain
    version of K6 (write_kernels.ifft_y_plain)."""
    Ky, Kx = dr.shape[-2:]
    dcr = dr.reshape(-1, Ky, Kx)
    dci = di.reshape(-1, Ky, Kx) if conjugated else -di.reshape(-1, Ky, Kx)
    if _stage(mode, "inv_y") != "bf16":
        return (tabs.eyr.T @ dcr - tabs.eyi.T @ dci,
                tabs.eyr.T @ dci + tabs.eyi.T @ dcr)
    return (_mm_bf16(tabs.eyr16.T, dcr) - _mm_bf16(tabs.eyi16.T, dci),
            _mm_bf16(tabs.eyr16.T, dci) + _mm_bf16(tabs.eyi16.T, dcr))


def ifft_corner_y(dr: torch.Tensor, di: torch.Tensor, tabs: Tables,
                  conjugated: bool = False):
    """The y-stage of ifft_corner_real in bf16, alone: (mr16,
    mi16), each (P*H, Kx) bf16 with P the planes of (dr, di) (..., Ky, Kx)
    — M = Ey^T @ Dc summed in f32 from bf16 operands, then rounded to bf16,
    the very values the x-stage's _mm_bf16 casts. They are the operands of
    the x-stage with the u8 epilogue (write_kernels.ifft_epilogue, K4), so
    no (..., H, W) f32 product is made. conjugated as in ifft_corner_real:
    K3's bf16 operands go to write_kernels.ifft_y as they are; an f32 delta
    (QIM, per-image walks) is first cast to bf16(dr), bf16(-di), the values
    the eager chain's _mm_bf16 casts. write_kernels.ifft_y launches the K6
    kernel for CUDA tensors and takes its plain version, the eager chain
    and its casts, for CPU tensors."""
    from steganosaurus_tpu_torch.spectral import write_kernels

    if conjugated:
        dcr, dci = dr.to(torch.bfloat16), di.to(torch.bfloat16)
    else:
        dcr, dci = write_kernels.ifft_operands_of(dr, di)
    return write_kernels.ifft_y(dcr, dci, tabs)


def write_delta(cr, ci, sign, mask, cos_a, sin_a, cjd=None, sjd=None,
                soft: bool = False):
    """Dense phase-write delta over the corner (reference
    write_bit_on_bin; steganosaurus_tpu.spectral.corner.write_delta).

    cr/ci: (..., Ky, Kx) corner spectrum. sign: per-image bit sign (+1/-1).
    mask: (3, Ky, Kx) f32, 1.0 where a walk bin lives. cos_a/sin_a: f32
    scalars, or (3, Ky, Kx) maps of cos/sin(alpha_i) under
    Params.alpha_spread (every use is elementwise, so maps broadcast like
    the scalars). cjd/sjd: the walk's static (3, Ky, Kx) cos/sin jitter
    maps, or None when Params.jitter == 0. Returns (dr, di) = 2*(nv - v) at
    walk bins (the pre-doubled Hermitian-half write), 0 elsewhere.

    Hard write: nv = mag * e^{i*(jd + s*alpha)}. soft=True
    (Params.soft_write), the minimal-energy write: in the jitter-rotated
    frame u = v * e^{-i*jd}, a bin with s*sigma*u_i >= mag*|sin a| already
    decodes with margin and gets an exact-zero delta (apply_write_floor
    takes the moved bins to be those with D != 0); the rest move to
    (sign(u_r)*mag*|cos a|, s*sigma*mag*|sin a|), sigma = sign(sin a)."""
    mag = torch.sqrt(cr * cr + ci * ci).clamp_min(1e-12)
    if soft:
        sin_a = torch.as_tensor(sin_a)
        cos_a = torch.as_tensor(cos_a)
        sigma = torch.where(sin_a < 0, -1.0, 1.0)
        abs_sin, abs_cos = sin_a.abs(), cos_a.abs()
        if cjd is None:
            u_r, u_i = cr, ci
        else:
            u_r = cr * cjd + ci * sjd
            u_i = ci * cjd - cr * sjd
        valid = sign * sigma * u_i >= mag * abs_sin
        t_r = torch.where(u_r < 0, -1.0, 1.0) * (mag * abs_cos)
        t_i = (sign * sigma) * (mag * abs_sin)
        if cjd is None:
            nv_r, nv_i = t_r, t_i
        else:
            nv_r = t_r * cjd - t_i * sjd
            nv_i = t_r * sjd + t_i * cjd
        m2 = 2.0 * mask
        return (m2 * torch.where(valid, 0.0, nv_r - cr),
                m2 * torch.where(valid, 0.0, nv_i - ci))
    if cjd is None:
        cos_t = cos_a
        sin_t = sign * sin_a
    else:
        cos_t = cjd * cos_a - sign * (sjd * sin_a)
        sin_t = sjd * cos_a + sign * (cjd * sin_a)
    m2 = 2.0 * mask
    dr = m2 * (mag * cos_t - cr)
    di = m2 * (mag * sin_t - ci)
    return dr, di


def apply_write_floor(dr, di, cr, ci, floor: float, img_pixels: float):
    """Quantization write floor (steganosaurus_tpu.spectral.corner
    .apply_write_floor, which has the derivation): a per-image magnitude
    boost b in [1, 32], reduced over the trailing (3, Ky, Kx) axes, such
    that the spatial RMS of the write reaches `floor`; phases stay exactly
    on target and b == 1 is bit-identical to the plain write. The
    1/img_pixels pre-scaling keeps the quadratic's squares inside f32."""
    return write_floor_boosted(dr, di, cr, ci, floor, img_pixels)[:2]


def write_floor_boosted(dr, di, cr, ci, floor: float, img_pixels: float,
                        total=None):
    """(dr_b, di_b, b): apply_write_floor's boosted delta and its per-image
    boost b (..., 1, 1, 1) f32 in [1, 32]. total: the per-image sum of the
    floor's terms (..., 3, Ky, Kx) -> (..., 1, 1, 1); None is torch.sum."""
    # 0-dim host tensors: an f32 scalar like JAX's, with no host-to-device
    # copy (a blocking upload would stall the stream pipeline)
    s = torch.tensor(1.0 / img_pixels, dtype=dr.dtype)
    hr, hi = (0.5 * s) * dr, (0.5 * s) * di
    wm = ((hr * hr + hi * hi) > 0).to(dr.dtype)
    crs, cis = cr * s, ci * s
    if total is None:
        def total(t):
            return torch.sum(t, (-3, -2, -1), keepdim=True)
    V = total(wm * (crs * crs + cis * cis))
    X = total(crs * hr + cis * hi)
    Hs = total(hr * hr + hi * hi)
    p = V + 2.0 * X + Hs
    e_star = torch.tensor(1.5 * floor ** 2, dtype=dr.dtype)
    disc = torch.clamp_min((V + X) ** 2 - p * (V - e_star), 0.0)
    b = torch.clamp((V + X + torch.sqrt(disc)) / torch.clamp_min(p, 1e-30),
                    1.0, 32.0)
    return (b * dr + 2.0 * (b - 1.0) * wm * cr,
            b * di + 2.0 * (b - 1.0) * wm * ci, b)


def decision_values(ci, sign_sin_a, cr=None, cjd=None, sjd=None):
    """Phase-read decision values of corner values (any shape — the dense
    corner or the values gathered at the walk bins):

        d = sign(sin a) * (Im C * cos jd - Re C * sin jd),

    or sign(sin a) * Im C without jitter (cjd is None; cr is then unused).
    The hard bit is d >= 0; the matched-filter soft decode sums d."""
    d = ci if cjd is None else ci * cjd - cr * sjd
    return d * sign_sin_a


def read_bits_dense(ci, sign_sin_a, cr=None, cjd=None, sjd=None):
    """Phase read: bit = 1 iff decision_values(...) >= 0; with sin(a) == 0
    every bit decodes 1, the reference's tie rule. Re(C) enters only
    through a jitter angle."""
    return (decision_values(ci, sign_sin_a, cr, cjd, sjd) >= 0).to(
        torch.uint8)


def qim_values_dense(cr, ci, dq, L: int, mag_floor: float = 0.0):
    """QIM decision values -cos(L * (theta - d)) * |C| (pipeline/qim.py
    read rule; >= 0 reads bit 1, the magnitude weights the soft combiner).
    Elementwise: cr/ci/dq may be the dense corner with the static dither
    map, or the values gathered at walk bins with each slot's dither.
    mag_floor: the floor under |C| (JAX's per-image-walk reads use 1e-12,
    its dense read none)."""
    mag = torch.sqrt(cr * cr + ci * ci).clamp_min(mag_floor)
    theta = torch.atan2(ci, cr)
    return -torch.cos(L * (theta - dq)) * mag


def qim_lattice_delta(cr, ci, sign, dq, L: int):
    """Pre-doubled delta 2*(nv - v) that moves each value's phase to the
    nearest point of its bit's dithered lattice coset (ops/phase
    embed_phases_qim): theta' = d + (round((theta - d)/Delta - b/2) + b/2)
    * Delta, Delta = 2*pi/L, magnitude kept. torch.round rounds half to
    even, as jnp.round does. Elementwise, like qim_values_dense."""
    mag = torch.sqrt(cr * cr + ci * ci).clamp_min(1e-12)
    theta = torch.atan2(ci, cr)
    delta = float(np.float32(2.0 * math.pi / L))  # JAX's jnp.float32 step
    half_b = (sign + 1.0) * 0.25          # bit/2 from the +-1 sign
    q = (theta - dq) / delta - half_b
    th_q = dq + (torch.round(q) + half_b) * delta
    return (2.0 * (mag * torch.cos(th_q) - cr),
            2.0 * (mag * torch.sin(th_q) - ci))


def write_delta_qim(cr, ci, sign, mask, qm, cos_a, sin_a, dq, L: int,
                    cjd=None, sjd=None, soft: bool = False):
    """write_delta with the PAYLOAD bins quantized by dithered phase QIM
    (steganosaurus_tpu.spectral.corner.write_delta_qim): qm (3, Ky, Kx) is
    1.0 at payload walk bins (frame slot >= 912), dq the static dither map.
    Header bins keep the hard or soft write over mask * (1 - qm); payload
    bins take qim_lattice_delta. Returns the summed deltas."""
    dr, di = write_delta(cr, ci, sign, mask * (1.0 - qm), cos_a, sin_a,
                         cjd, sjd, soft=soft)
    qr, qi = qim_lattice_delta(cr, ci, sign, dq, L)
    return dr + qm * qr, di + qm * qi


def read_bits_dense_qim(cr, ci, sign_sin_a, qm, dq, L: int, cjd=None,
                        sjd=None):
    """read_bits_dense with payload bins (qm > 0) read by the QIM rule."""
    return (decision_values_dense_qim(cr, ci, sign_sin_a, qm, dq, L, cjd,
                                      sjd) >= 0).to(torch.uint8)


def decision_values_dense_qim(cr, ci, sign_sin_a, qm, dq, L: int, cjd=None,
                              sjd=None):
    """Blended soft-decision values: the QIM value at payload bins (qm > 0),
    the half-plane value elsewhere. Every Rep-3/Rep-7 copy group lies on one
    side of the header/payload split, so the two scales never meet inside a
    combiner group."""
    hard = decision_values(ci, sign_sin_a, cr, cjd, sjd)
    return torch.where(qm > 0, qim_values_dense(cr, ci, dq, L), hard)
