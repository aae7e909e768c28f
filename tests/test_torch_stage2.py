"""Forward corner-DFT stage 2 of the torch port under mix_adaptive: the
prep pass and K2 (spectral/corner_kernels.py stage2_prep, fwd_stage2 over
csrc/corner_stage2.cu), on the CPU.

Held here: the prep's plain version (bf16 casts bit-equal to
.to(torch.bfloat16), energies within 1e-6 relative of band_columns' f32
torch.sum); fwd_stage2_plain(band="bf16x6"), K2's spec, and band="bf16x3"
against the JAX package's _fwd_y_split(adaptive=True) on the CPU (whose
band is f32): the same band set, the same bits at every walk bin, spectra
within a bound derived from the split's error, and at the band columns a
smaller error against an f64 product than the bf16 bulk's; band_error
(the card's check of the band columns) passing three terms and failing
two, and bulk_error measuring the sum order's error alone; the layouts of
K2's tables [T0, T1, T2], its band operand and its column mask; a numpy
emulation of the kernel's tile schedule (band tiles of two planes, six K
segments, bulk tiles that skip the masked columns, TMA's zero fill past H
and Kx)
against the plain version; the wrappers' plain versions on the CPU and
their input checks. The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu.spectral import corner as jcorner
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.spectral import corner_kernels as ck

torch.set_num_threads(2)

H, W, B = 384, 640, 4        # a Ky = Kx = 256 corner: the band is a real split
MK = bytes(range(32))
REL = 1e-5                   # f32 sums of the same products in another order
ENERGY_REL = 1e-6
SPLIT_REL = ck.SPLIT_REL     # split bf16's error per term, of |T||a|


def _covers(seed=11):
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 235, W)
    img = base[None, None, :, None] + rng.integers(-18, 19, (B, H, W, 3))
    return np.ascontiguousarray(
        np.clip(img, 0, 255).astype(np.uint8).transpose(0, 3, 1, 2))


def _stage1(imgs, Ky, Kx):
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    x = torch.from_numpy(imgs).reshape(-1, H, W)
    ar, ai = ck.fwd_stage1(x, tabs.exr16, tabs.exi16, False)
    return ar, ai, tabs


def _dims():
    return tcorner.corner_dims(H, W, Params().rmax)


def _random_stage1(seed, P=5, h=70, x=200, scale=1e5):
    """Stage-1-like operands with a few strong columns (the band)."""
    rng = np.random.default_rng(seed)
    col = np.exp(rng.normal(0.0, 2.0, (P, 1, x)))
    ar = (rng.normal(size=(P, h, x)) * col * scale).astype(np.float32)
    ai = (rng.normal(size=(P, h, x)) * col * scale).astype(np.float32)
    return torch.from_numpy(ar), torch.from_numpy(ai)


def _tables(h, Ky, w=96, Kx=96):
    return tcorner.dft_tables_device(h, Ky, w, Kx, "cpu")


# --- the prep pass -----------------------------------------------------------

@pytest.mark.parametrize("P,h,x", [(12, H, 256), (5, 70, 200), (1, 3, 65)])
def test_prep_plain_casts_and_energies(P, h, x):
    ar, ai = _random_stage1(1, P, h, x)
    ar16, ai16, energy = ck.stage2_prep_plain(ar, ai)
    assert torch.equal(ar16, ar.to(torch.bfloat16))
    assert torch.equal(ai16, ai.to(torch.bfloat16))
    ref = torch.sum(ar * ar + ai * ai, dim=-2)            # band_columns'
    assert energy.dtype == torch.float32 and energy.shape == (P, x)
    rel = ((energy - ref).abs() / ref).max().item()
    assert rel <= ENERGY_REL
    exact = torch.sum((ar * ar + ai * ai).double(), dim=-2)
    assert ((energy.double() - exact).abs() / exact).max().item() <= 2.0 ** -24


def _k1_partials_by_loops(ar, ai):
    """K1's energy partials (csrc/corner_stage1_wgmma.cu, energy_partials)
    one value at a time in the kernel's own order: for each row tile and
    plane it touches, each column's lanes' two-row sums, the shuffles xor
    16, 8, 4 (lanes l and l ^ 4, then l ^ 2, then l ^ 1 of a warp's 8 row
    lanes: row 16w + l and 16w + 8 + l is lane l of warp w), then the 8
    warps in order; slots as a dict {(t, p): (Kx,) float64}."""
    P, h, X = ar.shape
    e = (ar * ar + ai * ai).reshape(P * h, X).double().numpy()
    M = P * h
    out = {}
    for t in range(-(-M // 128)):
        rows = range(128 * t, min(128 * t + 128, M))
        for p in sorted({m // h for m in rows}):
            def val(r):
                m = 128 * t + r
                return e[m] if m < M and m // h == p else np.zeros(X)
            s = None
            for w in range(8):
                x = [val(16 * w + l) + val(16 * w + 8 + l) for l in range(8)]
                a = [x[j] + x[j + 4] for j in range(4)]
                b = [a[j] + a[j + 2] for j in range(2)]
                ws = b[0] + b[1]
                s = ws if s is None else s + ws
            out[t, p] = s
    return out


@pytest.mark.parametrize("P,h,x", [(3, 70, 200), (2, 2160, 40), (1, 3, 65),
                                   (2, 128, 33), (5, 256, 64), (1, 130, 96)])
def test_k1_energy_partials_in_the_kernel_order(P, h, x):
    """The plain twin of K1's fused energies (stage1_partials_plain, then
    prep_reduce_plain): each (row tile, plane) slot at row t + p equal bit
    for bit to a loop over the kernel's own sum order, the planes' slots
    added in tile order within 2^-24 of the exact sum and of the prep
    pass's energies, at planes a tile straddles (2160 = 16 * 128 + 112),
    tiles over several planes (h < 128), planes that end on a tile edge
    (h = 128, 256: slots no tile writes) and a ragged last tile."""
    ar, ai = _random_stage1(3 + P + h, P, h, x)
    part = ck.stage1_partials_plain(ar, ai)
    assert part.shape == (ck.energy_slots(P, h), x) == (
        -(-P * h // 128) + P - 1, x)
    assert part.dtype == torch.float64
    loops = _k1_partials_by_loops(ar, ai)
    for (t, p), want in loops.items():
        assert np.array_equal(part[t + p].numpy(), want)
    written = {t + p for t, p in loops}
    for r in set(range(part.shape[0])) - written:
        assert not part[r].any()
    energy = ck.prep_reduce_plain(part, P, h)
    assert torch.equal(energy, ck.stage1_energy_plain(ar, ai))
    assert torch.equal(energy, ck.prep_reduce(part, P, h))
    assert energy.shape == (P, x) and energy.dtype == torch.float32
    exact = torch.sum((ar * ar + ai * ai).double(), dim=-2)
    assert ((energy.double() - exact).abs() / exact).max().item() <= 2.0 ** -24
    by_loop = torch.stack([sum(torch.from_numpy(loops[t, p]) for t in range(
        p * h // 128, (p * h + h - 1) // 128 + 1)) for p in range(P)])
    assert ((energy.double() - by_loop).abs() / exact).max() <= 2.0 ** -24
    prep = ck.stage2_prep_plain(ar, ai)[2]
    assert ((energy - prep).abs() / prep).max().item() <= 2.0 ** -23


def test_k1_prep_on_the_cpu_is_the_plain_prep():
    """fwd_stage1's prep on CPU tensors: the copies ar.to(bf16) and
    ai.to(bf16) of its own output, the energies stage1_energy_plain's,
    none under "copies"; the spectrum's ar and ai those without the prep;
    nothing counted as a launch."""
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    x = torch.from_numpy(_covers()[:1])
    before = dict(ck.LAUNCHES)
    ar, ai = ck.fwd_stage1(x, tabs.exr16, tabs.exi16, True)
    a, b = ar.reshape(3, H, Kx), ai.reshape(3, H, Kx)
    for prep in ck.PREPS:
        r, i, (r16, i16, energy) = ck.fwd_stage1(x, tabs.exr16, tabs.exi16,
                                                 True, None, prep)
        assert torch.equal(r, ar) and torch.equal(i, ai)
        assert r16.shape == (3, H, Kx)
        assert torch.equal(r16, a.to(torch.bfloat16))
        assert torch.equal(i16, b.to(torch.bfloat16))
        if prep == "copies":
            assert energy is None
        else:
            assert torch.equal(energy, ck.stage1_energy_plain(a, b))
    assert ck.LAUNCHES == before
    with pytest.raises(ValueError):
        ck.fwd_stage1(x, tabs.exr16, tabs.exi16, True, None, "energy")
    with pytest.raises(ValueError):  # partials of another shape
        ck.prep_reduce(torch.zeros((5, Kx), dtype=torch.float64), 3, H)


def test_prep_energies_pick_the_band_of_band_columns():
    Ky, Kx = _dims()
    ar, ai, _ = _stage1(_covers(), Ky, Kx)
    _, _, energy = ck.stage2_prep_plain(ar, ai)
    idx = tcorner.band_topk(energy, tcorner.SPLIT_X0)
    ref = tcorner.band_columns(ar, ai, tcorner.SPLIT_X0)
    assert torch.equal(idx.sort(-1).values, ref.sort(-1).values)


# --- the plain versions ------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
def test_band_error_holds_the_band_to_three_terms(seed):
    """band_error, the card's check of K2's band columns, on image planes'
    stage-1 output: K2's spec (three terms, six products) lies below
    SPLIT_REL["bf16x6"], the TPU's HIGH (two terms) above it, and the
    bf16 bulk at those columns above SPLIT_REL["bf16x3"]."""
    Ky, Kx = _dims()
    ar, ai, tabs = _stage1(_covers(seed), Ky, Kx)
    prep = ck.stage2_prep_plain(ar, ai)
    idx = tcorner.band_topk(prep[2], tcorner.SPLIT_X0)
    err = {band: ck.band_error(*ck.fwd_stage2_plain(ar, ai, idx, tabs, band,
                                                    prep), ar, ai, idx, tabs)
           for band in ck.SPLITS}
    assert err["bf16x6"] <= SPLIT_REL["bf16x6"] < err["bf16x3"]
    bulk = (tcorner._mm_bf16(tabs.eyr16, prep[0])
            - tcorner._mm_bf16(tabs.eyi16, prep[1]),
            tcorner._mm_bf16(tabs.eyr16, prep[1])
            + tcorner._mm_bf16(tabs.eyi16, prep[0]))
    assert ck.band_error(*bulk, ar, ai, idx, tabs) > SPLIT_REL["bf16x3"]


def test_bulk_error_is_the_sum_orders_error():
    """bulk_error against the exact sum of the same bf16 products: 0 for
    that sum itself, the offset for the sum moved by a constant, and f32
    noise (above 0, far below a bf16 rounding of the values) for the plain
    version's f32 product; the band columns and the planes past `planes`
    are not looked at."""
    Ky, Kx = _dims()
    ar, ai, tabs = _stage1(_covers(), Ky, Kx)
    ar16, ai16, energy = ck.stage2_prep_plain(ar, ai)
    idx = tcorner.band_topk(energy, tcorner.SPLIT_X0)
    eyr, eyi = tabs.eyr16.double(), tabs.eyi16.double()
    a, b = ar16.double(), ai16.double()
    er, ei = eyr @ a - eyi @ b, eyr @ b + eyi @ a
    assert ck.bulk_error(er, ei, ar16, ai16, idx, tabs) == 0.0
    assert ck.bulk_error(er + 0.5, ei - 0.5, ar16, ai16, idx, tabs) == \
        pytest.approx(0.5, rel=1e-6)
    moved = er.clone()
    moved.scatter_(2, idx[:, None, :].expand_as(er[..., :idx.shape[1]]), 7.0)
    moved[2:] += 1.0
    assert ck.bulk_error(moved, ei, ar16, ai16, idx, tabs, planes=2) == 0.0
    cr, ci = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6",
                                 (ar16, ai16))
    err = ck.bulk_error(cr, ci, ar16, ai16, idx, tabs)
    assert 0.0 < err < 2.0 ** -9 * er.abs().max().item() * 1e-3


def _jax_stego():
    """A JAX embed of 128-byte secrets at fixed salts (nchw)."""
    from steganosaurus_tpu.pipeline import batch as jbatch

    rng = np.random.default_rng(13)
    secrets = [bytes(rng.integers(0, 256, 128, dtype=np.uint8))
               for _ in range(B)]
    res = jbatch.embed_batch(_covers(), secrets, master_key=MK,
                             salts=[bytes([i]) * 16 for i in range(B)],
                             layout="nchw")
    return np.array(res.stego), 912 + (128 + 16) * 56


def _f64_stage2(ar, ai, tabs):
    eyr, eyi = tabs.eyr.double(), tabs.eyi.double()
    a, b = ar.double(), ai.double()
    return eyr @ a - eyi @ b, eyr @ b + eyi @ a


@pytest.mark.parametrize("band_name", ["bf16x6", "bf16x3"])
def test_split_bf16_plain_against_jax_adaptive_split(band_name):
    """K2's spec (bf16x6; and the TPU's HIGH, bf16x3) on a stego against
    JAX's _fwd_y_split(adaptive=True) on the CPU: the same band set, spectra
    within REL of their scale on the bulk columns and within the split's
    bound on the band columns, the same bits at every walk bin; at the band
    columns split bf16 sits closer to the f64 product than the bf16 bulk
    would."""
    stego, nbits = _jax_stego()
    Ky, Kx = _dims()
    ar, ai, tabs = _stage1(stego, Ky, Kx)
    _, _, energy = ck.stage2_prep_plain(ar, ai)
    idx = tcorner.band_topk(energy, tcorner.SPLIT_X0)

    jtabs = jcorner.dft_tables_device(H, Ky, W, Kx)
    planes = jnp.asarray(stego.reshape(-1, H, W), jnp.float32)
    jar = jcorner._mm("phw,xw->phx", planes, jtabs[2], "bf16")
    jai = jcorner._mm("phw,xw->phx", planes, jtabs[3], "bf16")
    _, jidx = jax.lax.top_k(jnp.sum(jar * jar + jai * jai, axis=-2),
                            jcorner.split_x0())
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1),
                                  np.sort(np.asarray(jidx), -1))
    jr, ji = jcorner._fwd_y_split(jar, jai, (jtabs[0], jtabs[1]),
                                  adaptive=True)
    jr, ji = np.asarray(jr), np.asarray(ji)

    cr, ci = ck.fwd_stage2_plain(ar, ai, idx, tabs, band=band_name)
    scale = float(max(np.abs(jr).max(), np.abs(ji).max()))
    band = np.zeros((ar.shape[0], 1, Kx), bool)
    np.put_along_axis(band, idx.numpy()[:, None, :], True, -1)
    # per band column: sum_h |T||a| <= 2 sum_h (|ar| + |ai|) (|ey| <= 1)
    s = 2.0 * (ar.abs() + ai.abs()).double().sum(1, keepdim=True).numpy()
    tol = np.where(band, SPLIT_REL[band_name] * s, 0.0) + REL * scale
    for got, want in ((cr.numpy(), jr), (ci.numpy(), ji)):
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= tol).all()
        assert err[~np.broadcast_to(band, err.shape)].max() <= REL * scale

    er, ei = _f64_stage2(ar, ai, tabs)
    bulk_r = (tcorner._mm_bf16(tabs.eyr16, ar) - tcorner._mm_bf16(tabs.eyi16,
                                                                  ai))
    sel = torch.from_numpy(np.broadcast_to(band, cr.shape).copy())
    err_split = (cr.double() - er).abs()[sel].max().item()
    err_bulk = (bulk_r.double() - er).abs()[sel].max().item()
    assert err_split < err_bulk / 8

    plane, y, xx, _ = tbatch._walk_indices(None, MK, Params(), H, W, nbits)
    sign = float(np.sign(np.sin(np.float32(Params().alpha))))
    walk = tuple(torch.from_numpy(a.astype(np.int64)) for a in (plane, y, xx))
    ci5 = ci.reshape(B, 3, Ky, Kx)
    got = tcorner.read_bits_dense(ci5[(slice(None),) + walk], sign).numpy()
    want = np.asarray(jcorner.read_bits_dense(
        jr.reshape(B, 3, Ky, Kx), ji.reshape(B, 3, Ky, Kx), sign))[
        :, plane, y, xx]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("band", ["tf32", "f32"])
def test_plain_band_must_be_known(band):
    """Only the SPLITS keys: the f32 band is corner._fwd_y_split's."""
    ar, ai = _random_stage1(2, 2, 8, 80)
    idx = torch.topk(ck.stage2_prep_plain(ar, ai)[2], 64).indices
    with pytest.raises(ValueError):
        ck.fwd_stage2_plain(ar, ai, idx, _tables(8, 16), band=band)


# --- the layouts the kernel reads --------------------------------------------

@pytest.mark.parametrize("h,Ky", [(70, 100), (128, 64), (384, 256)])
def test_stage2_tables_layout(h, Ky):
    tabs = _tables(h, Ky)
    t = ck.stage2_tables(tabs.eyr, tabs.eyi)
    Kyp, Hp = -(-Ky // 64) * 64, -(-h // 64) * 64
    assert t.dtype == torch.bfloat16 and t.shape == (3, 2 * Kyp, 2 * Hp)
    assert torch.equal(t[0, :Ky, :h], tabs.eyr16)
    assert torch.equal(t[0, :Ky, Hp:Hp + h], -tabs.eyi16)
    assert torch.equal(t[0, Kyp:Kyp + Ky, :h], tabs.eyi16)
    assert torch.equal(t[0, Kyp:Kyp + Ky, Hp:Hp + h], tabs.eyr16)
    full = torch.zeros((2 * Kyp, 2 * Hp))
    full[:Ky, :h], full[:Ky, Hp:Hp + h] = tabs.eyr, -tabs.eyi
    full[Kyp:Kyp + Ky, :h], full[Kyp:Kyp + Ky, Hp:Hp + h] = tabs.eyi, tabs.eyr
    t0, t1, t2 = (t[i].float() for i in range(3))
    assert torch.equal(t[1], (full - t0).to(torch.bfloat16))
    assert torch.equal(t[2], (full - t0 - t1).to(torch.bfloat16))
    pad = torch.ones_like(full, dtype=torch.bool)
    pad[:Ky, :h] = pad[:Ky, Hp:Hp + h] = False
    pad[Kyp:Kyp + Ky, :h] = pad[Kyp:Kyp + Ky, Hp:Hp + h] = False
    assert not (t0[pad].any() or t1[pad].any() or t2[pad].any())
    assert ((t0 + t1 + t2 - full).abs() <= 2.0 ** -26 * full.abs()).all()


@pytest.mark.parametrize("X", [65, 96, 200, 1024])
def test_band_mask_layout(X):
    rng = np.random.default_rng(X)
    idx = np.stack([rng.choice(X, 64, replace=False) for _ in range(3)])
    idx[0, 0] = 31                                   # bit 31 of a word
    idx[0, 1] = X - 1
    idx[0, 2:] = [i for i in range(X) if i not in (31, X - 1)][:62]
    m = ck.band_mask(torch.from_numpy(idx), X)
    nw = -(-X // 32)
    assert m.dtype == torch.int32 and m.shape == (3, nw)
    words = m.numpy().view(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    got = bits.reshape(3, nw * 32)
    want = np.zeros_like(got)
    np.put_along_axis(want, idx, 1, 1)
    np.testing.assert_array_equal(got, want)


def test_band_operand_layout():
    ar, ai = _random_stage1(3, 3, 40, 120)
    idx = torch.from_numpy(np.stack([np.random.default_rng(i).choice(
        120, 64, replace=False) for i in range(3)]))
    g = ck.band_operand(ar, ai, idx)
    assert g.dtype == torch.bfloat16 and g.shape == (6, 3, 40, 64)
    assert ck.band_operand(ar, ai, idx, levels=2).shape == (4, 3, 40, 64)
    gi = idx[:, None, :].expand(3, 40, 64)
    for k, a in enumerate((ar, ai)):
        col = a.gather(2, gi)
        t0, t1, t2 = (g[2 * i + k].float() for i in range(3))
        assert torch.equal(g[k], col.to(torch.bfloat16))
        assert torch.equal(g[2 + k], (col - t0).to(torch.bfloat16))
        assert torch.equal(g[4 + k], (col - t0 - t1).to(torch.bfloat16))
        assert ((t0 + t1 + t2 - col).abs() <= 2.0 ** -26 * col.abs()).all()


def test_split_order_is_the_kernels():
    """SPLITS["bf16x6"] is every product T_i . a_j with i + j <= 2, the
    lowest-order first, in the order of csrc/corner_stage2.cu's SEG_T /
    SEG_A nibbles; bf16x3 the products with i + j <= 1."""
    six = ck.SPLITS["bf16x6"]
    assert sorted(six) == [(i, j) for i in range(3) for j in range(3)
                           if i + j <= 2]
    assert [i + j for i, j in six] == sorted((i + j for i, j in six),
                                             reverse=True)
    src = (ck.__file__.rsplit("/spectral/", 1)[0]
           + "/csrc/corner_stage2.cu")
    text = open(src).read()
    for name, k in (("SEG_T", 0), ("SEG_A", 1)):
        word = int(text.split(f"constexpr uint32_t {name} = ")[1]
                   .split(";")[0], 16)
        assert [(word >> (4 * s)) & 0xF for s in range(6)] == \
            [p[k] for p in six]
    assert sorted(ck.SPLITS["bf16x3"]) == [(0, 0), (0, 1), (1, 0)]


# --- the kernel's schedule, emulated -----------------------------------------

def _tma_box(src, starts, box):
    """A TMA box of `src` (numpy, dims in TMA order reversed: the last axis
    is dim 0) at `starts` (TMA order): out-of-bounds elements read 0."""
    out = np.zeros(tuple(reversed(box)), src.dtype)
    sl_src, sl_out = [], []
    for ax, (s, b) in enumerate(zip(reversed(starts), reversed(box))):
        n = src.shape[ax]
        lo, hi = max(s, 0), min(s + b, n)
        if hi <= lo:
            return out
        sl_src.append(slice(lo, hi))
        sl_out.append(slice(lo - s, hi - s))
    out[tuple(sl_out)] = src[tuple(sl_src)]
    return out


def _cu_consts(name):
    """The integer and bool constexprs of csrc/`name` given as literals."""
    import re

    text = open(ck.__file__.rsplit("/spectral/", 1)[0] + "/csrc/"
                + name).read()
    return {k: {"true": 1, "false": 0}.get(v, None) if v in ("true", "false")
            else int(v) for k, v in re.findall(
                r"constexpr (?:int|bool) (\w+) = (\d+|true|false);", text)}


K2 = _cu_consts("corner_stage2.cu")


def _k2_tile(unit, rank, n_band, n_mt, n_mp, n_nt, nh):
    """csrc/corner_stage2.cu's tile_of: (band, p, mt, nt, nkb, ghost) of
    block `rank` of the cluster that runs `unit`."""
    if unit < n_band:
        mp, p, nt, nkb, band = (unit % n_mp, (unit // n_mp) * 2, 0,
                                6 * 2 * nh, True)
    else:
        u = unit - n_band
        nt, u = u % n_nt, u // n_nt
        mp, p, nkb, band = u % n_mp, u // n_mp, 2 * nh, False
    mt = 2 * mp + rank
    return band, p, mt, nt, nkb, mt >= n_mt


def _k2_stage(tile, kb, nh):
    """The loads of k-block (stage) kb of a tile as the kernel's producer
    issues them: (the block's A box or None, {64-column atom: (B box, the
    block that loads it)}) with A ("t", k offset, row, term) and B ("g",
    x, h, plane, term) or (map, x, h, plane)."""
    band, p, mt, nt, _, ghost = tile
    b = {}
    if band:
        seg, rem = divmod(kb, 2 * nh)
        part, hb = divmod(rem, nh)
        ti, aj = ck.SPLITS["bf16x6"][seg]
        a_box = ("t", rem * 64, mt * 128, ti)
        # both planes' columns, one box: the block kb % 2 loads it
        b[0] = (("g", 0, hb * 64, p, 2 * aj + part), kb % 2)
    else:
        part, hb = divmod(kb, nh)
        a_box = ("t", kb * 64, mt * 128, 0)
        for j in range(2):     # the atom j: block j loads it
            b[j] = ((("ar", "ai")[part], nt * 128 + 64 * j, hb * 64, p), j)
    return (None if ghost else a_box), b


def _k2_walk(P, X, Ky, H):
    """The kernel's units, n_band and its geometry, as corner_stage2 sets
    them up."""
    Kyp, Hp = -(-Ky // 64) * 64, -(-H // 64) * 64
    nh, n_mt = Hp // 64, 2 * Kyp // 128
    n_mp, n_nt = (n_mt + 1) // 2, -(-X // 128)
    n_band = -(-P // 2) * n_mp
    return n_band + P * n_mp * n_nt, n_band, n_mt, n_mp, n_nt, nh


def _k2_emulation(t2, ar16, ai16, g, mask, idx, P, h, X, Ky, clusters=3):
    """csrc/corner_stage2.cu's schedule in numpy f64: each cluster's units
    in the kernel's order, each block's tile, each k-block's A box (128
    rows of T) and B boxes (two 64 x 64 boxes of ar16 / ai16, or one 4-D
    box of the band operand) as TMA loads them into the stage (the
    partner's multicast half too), its sums promoted every PROMOTE
    k-blocks, and the epilogue's masked and scattered stores; the lone
    block of an odd row-block count loads and stores nothing of its
    own."""
    BM, BN, BK, NP = 128, 128, 64, 2   # NP: planes per band tile
    Kyp, Hp = t2.shape[1] // 2, t2.shape[2] // 2
    n_units, n_band, n_mt, n_mp, n_nt, nh = _k2_walk(P, X, Ky, h)
    cr = np.full((P, Ky, X), np.nan)
    ci = np.full((P, Ky, X), np.nan)
    T = t2.astype(np.float64)
    maps = {"ar": ar16.astype(np.float64), "ai": ai16.astype(np.float64)}
    G = g.astype(np.float64)
    words = mask.view(np.uint32)
    for c in range(clusters):
        for unit in range(c, n_units, clusters):
            for rank in range(2):
                tile = _k2_tile(unit, rank, n_band, n_mt, n_mp, n_nt, nh)
                band, p, mt, nt, nkb, ghost = tile
                acc = np.zeros((BM, BN))
                d = np.zeros((BM, BN))
                for kb in range(nkb):
                    a_box, b = _k2_stage(tile, kb, nh)
                    box, _ = b[0]
                    if band:
                        Bx = _tma_box(G, box[1:], (64, BK, NP, 1))[0]
                        Bm = np.concatenate(list(Bx), axis=1)
                    else:
                        Bm = np.concatenate(
                            [_tma_box(maps[b[j][0][0]], b[j][0][1:],
                                      (64, BK, 1))[0]
                             for j in range(BN // 64)], axis=1)
                    if ghost:
                        continue
                    _, x0, y0, lv = a_box
                    A = _tma_box(T, (x0, y0, lv), (BK, BM, 1))[0]
                    d = (0 if kb % K2["PROMOTE"] == 0 else d) + A @ Bm
                    if kb % K2["PROMOTE"] == K2["PROMOTE"] - 1 or \
                            kb == nkb - 1:
                        acc += d
                if ghost:
                    continue
                for r in range(BM):
                    m = mt * BM + r
                    is_ci, y = (m >= Kyp), (m - Kyp if m >= Kyp else m)
                    if y >= Ky:
                        continue
                    out = ci if is_ci else cr
                    for n in range(BN):
                        if band:
                            pl, j = p + n // 64, n % 64
                            if pl < P:
                                assert np.isnan(out[pl, y, idx[pl, j]])
                                out[pl, y, idx[pl, j]] = acc[r, n]
                        else:
                            x = nt * BN + n
                            if x < X and not (words[p, x // 32]
                                              >> (x % 32)) & 1:
                                assert np.isnan(out[p, y, x])
                                out[p, y, x] = acc[r, n]
    return cr, ci


@pytest.mark.parametrize("P,h,X,Ky", [(5, 70, 200, 100), (4, 64, 300, 64),
                                      (1, 130, 96, 40)])
def test_kernel_schedule_emulation_matches_plain(P, h, X, Ky):
    """Every output element written exactly once (the band tiles fill the
    bulk tiles' holes), equal to fwd_stage2_plain(band="bf16x6") within REL
    of its scale: P not a multiple of 4 (a band tile past the last plane),
    H, Kx and Ky not multiples of 64 (TMA's zero fill)."""
    ar, ai = _random_stage1(4, P, h, X)
    tabs = _tables(h, Ky)
    ar16, ai16, energy = ck.stage2_prep_plain(ar, ai)
    idx = torch.topk(energy, 64).indices
    t2 = ck.stage2_tables(tabs.eyr, tabs.eyi).float().numpy()
    g = ck.band_operand(ar, ai, idx).float().numpy()
    mask = ck.band_mask(idx, X).numpy()
    er, ei = _k2_emulation(t2, ar16.float().numpy(), ai16.float().numpy(), g,
                           mask, idx.numpy(), P, h, X, Ky)
    assert not np.isnan(er).any() and not np.isnan(ei).any()
    pr, pi = ck.fwd_stage2_plain(ar, ai, idx, tabs, band="bf16x6")
    scale = float(max(pr.abs().max(), pi.abs().max()))
    assert np.abs(er - pr.double().numpy()).max() <= REL * scale
    assert np.abs(ei - pi.double().numpy()).max() <= REL * scale


def _k2_consumer(nkb):
    """A consumer warpgroup's k-loop over a tile of nkb k-blocks, one a
    stage (the kernel's): the k-blocks after which it promotes (waits for
    its wgmmas and adds their sum into the f32 sum), and the order in which
    it frees the stages (each once its wgmmas are done)."""
    points, freed, prev = [], [], None
    for kb in range(nkb):
        promote = kb % K2["PROMOTE"] == K2["PROMOTE"] - 1 or kb == nkb - 1
        if prev is not None:
            freed.append(prev)
        if promote:
            points.append(kb)
            freed.append(kb)
        prev = None if promote else kb
    return points, freed


K2_GRIDS = [(2160, 3840), (1080, 1920), (512, 512), (256, 256),
            (1079, 1917), (2160, 3839), (1170, 2532)]


@pytest.mark.parametrize("P", [3, 6])
@pytest.mark.parametrize("grid", K2_GRIDS)
def test_k2_cluster_walk(grid, P):
    """The kernel's walk at the card grids' corners (3 or 6 planes): every
    tile (band: a plane pair and row block; bulk: plane, row block, column
    block) is computed by one block exactly once, the lone block of an odd
    row-block count by none; the two blocks of a cluster run the same kind
    of tile of the same plane (band tiles of one plane pair) and the same
    stages, hold the same B boxes in each stage and load the halves of
    them (each box by one block, multicast to both: a bulk stage's atoms
    one each, a band tile's boxes every other k-block each); and the
    promotions fall every PROMOTE k-blocks (256 products), and at a tile's
    end."""
    H, W = grid
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    n_units, n_band, n_mt, n_mp, n_nt, nh = _k2_walk(P, Kx, Ky, H)
    assert K2["CLUSTER"] == 2 and K2["PROMOTE"] * 64 == 256
    seen = {}
    for unit in range(n_units):
        tiles = [_k2_tile(unit, r, n_band, n_mt, n_mp, n_nt, nh)
                 for r in range(2)]
        assert tiles[0][:2] == tiles[1][:2] and tiles[0][3:5] == \
            tiles[1][3:5]
        assert not tiles[0][5] and tiles[1][5] == (tiles[1][2] == n_mt)
        for band, p, mt, nt, nkb, ghost in tiles:
            if not ghost:
                key = (band, p, mt, nt)
                seen[key] = seen.get(key, 0) + 1
        nkb = tiles[0][4]
        owners = set()
        for kb in range(nkb):
            loads = [_k2_stage(t, kb, nh) for t in tiles]
            assert loads[0][1] == loads[1][1]      # the same B in each slot
            owners |= {who for _, who in loads[0][1].values()}
        assert owners == {0, 1}                    # both blocks load B
        points, freed = _k2_consumer(nkb)
        assert freed == list(range(nkb))
        spans = np.diff([-1] + points) * 64         # products a sum spans
        assert (spans[:-1] == 256).all() and 0 < spans[-1] <= 256
        assert points[-1] == nkb - 1
    want = {(True, p, mt, 0) for p in range(0, P, 2) for mt in range(n_mt)}
    want |= {(False, p, mt, nt) for p in range(P) for mt in range(n_mt)
             for nt in range(n_nt)}
    assert seen == dict.fromkeys(want, 1)


def _tool(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_k2_ablation_edits_apply_to_the_committed_source(monkeypatch):
    """Each variant of tools/k2_ablation_torch.py is a few text edits of
    csrc/corner_stage2.cu (multicast off, the promotion's spans, the
    dropped work): each text it replaces is there, once; --parent may be
    given more than once; and the tool refuses to run without a card (made
    to see none here, so that it never builds or launches anything)."""
    import torch

    tool = _tool("k2_ablation_torch.py")
    src = open(ck.__file__.rsplit("/spectral/", 1)[0]
               + "/csrc/corner_stage2.cu").read()
    names = [name for name, _, _ in tool.VARIANTS]
    assert {"multicast off", "no promotion",
            "loads after the first ring skipped"} <= set(names)
    for name, _, edits in tool.VARIANTS:
        for old, new in edits:
            assert src.count(old) == 1, name
            assert old != new
    assert tool._args(["--parent", "a", "out.txt", "--parent", "b"]) == (
        ["a", "b"], ["out.txt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2


@pytest.mark.parametrize("entry", ["corner_stage2", "corner_stage2_band",
                                   "corner_stage2_grid",
                                   "corner_stage2_prep",
                                   "corner_stage2_prep_reduce"])
def test_k2_entries_take_the_signatures_bound_to_them(entry):
    """Each C entry of csrc/corner_stage2.cu takes the argument kinds
    _build binds it with; K2's entries of the parent of the run-time band
    width (4f717a6: one band group, no bulk flag) take
    parent_kernels_torch.OLD_SIGNATURES', which the ablation and the card
    tests bind a parent build with."""
    from steganosaurus_tpu_torch import _build

    tool = _tool("parent_kernels_torch.py")
    text = (_build.CSRC / "corner_stage2.cu").read_text()
    assert tool.c_kinds(text, entry) == tool.kinds_of(
        _build._SIGNATURES[entry])
    if entry not in tool.OLD_SIGNATURES:
        return
    assert tool.OLD_SIGNATURES[entry] != _build._SIGNATURES[entry]
    src = tool.parent_source("4f717a6", "corner_stage2.cu")
    if src is None:
        pytest.skip("no git history to read the parent's source from")
    assert tool.takes_old_signature(src, entry)


def test_parent_builds_of_two_sources_are_two_libraries(tmp_path,
                                                        monkeypatch):
    """tools/parent_kernels_torch.py builds each source of a revision into
    a library of its own name: a process that loaded one parent build
    (K6's) would get it back from dlopen under the same path in place of
    the next (K2's)."""
    from steganosaurus_tpu_torch import _build

    tool = _tool("parent_kernels_torch.py")
    monkeypatch.setattr(tool, "PARENTS", tmp_path)
    (tmp_path / "abc").mkdir()
    built = []

    def fake(source, variants, work):
        built.append((source, dict(variants), work))
        return ({k: f"lib of {k}" for k in variants},
                {k: "" for k in variants})

    monkeypatch.setattr(_build, "build_variants", fake)
    names = ("corner_ifft_y.cu", "corner_stage2.cu")
    for name in names:
        (tmp_path / "abc" / name).write_text("// old\n")
        assert tool.parent_kernels("abc", name)[0].startswith("lib of")
    keys = [next(iter(v)) for _, v, _ in built]
    assert [s for s, _, _ in built] == list(names)
    assert len(set(keys)) == 2 and all(w == tmp_path / "abc"
                                       for _, _, w in built)


def test_parent_sources_come_from_the_build_directory_or_git(tmp_path,
                                                              monkeypatch):
    """tools/parent_kernels_torch.py: a source already under
    build/parents/REV/ is used as it is (a checkout without history finds
    what was copied there); a revision git does not know gives None, and
    so --parent REV makes the ablation tools refuse before they build."""
    tool = _tool("parent_kernels_torch.py")
    monkeypatch.setattr(tool, "PARENTS", tmp_path)
    (tmp_path / "abc").mkdir()
    (tmp_path / "abc" / "corner_stage2.cu").write_text("// old\n")
    assert tool.parent_source("abc", "corner_stage2.cu").read_text() == \
        "// old\n"
    assert tool.parent_source("no-such-revision", "corner_stage2.cu") is None
    assert not (tmp_path / "no-such-revision").exists()


# --- the wrappers -------------------------------------------------------------

def test_wrappers_take_plain_on_cpu_and_check_inputs():
    ar, ai = _random_stage1(5, 3, 70, 130)
    tabs = _tables(70, 100)
    before = dict(ck.LAUNCHES)
    prep = ck.stage2_prep(ar, ai)
    for got, want in zip(prep, ck.stage2_prep_plain(ar, ai)):
        assert torch.equal(got, want)
    idx = tcorner.band_topk(prep[2], 64)
    band = ck.stage2_band(ar, ai, idx)
    assert torch.equal(band[0], ck.band_operand(ar, ai, idx))
    assert torch.equal(band[1], ck.band_mask(idx, 130))
    cr, ci = ck.fwd_stage2(ar, ai, prep[0], prep[1], idx, tabs, band)
    pr, pi = ck.fwd_stage2_plain(ar, ai, idx, tabs, band="bf16x6")
    assert torch.equal(cr, pr) and torch.equal(ci, pi)
    assert cr.shape == (3, 100, 130) and cr.dtype == torch.float32
    assert ck.LAUNCHES == before           # CPU tensors never count
    assert ck.KERNEL_PREP == "corner_stage2_prep"
    assert ck.KERNEL_BAND == "corner_stage2_band"
    assert ck.KERNEL_STAGE2 == "corner_stage2"

    with pytest.raises(ValueError):
        ck.stage2_prep(ar.double(), ai)
    with pytest.raises(ValueError):
        ck.stage2_prep(ar, ai[:, :, :-1])
    with pytest.raises(ValueError):
        ck.stage2_prep(ar[0], ai[0])
    with pytest.raises(ValueError):
        ck.stage2_prep(ar.transpose(1, 2), ai.transpose(1, 2))
    args = [ar, ai, prep[0], prep[1], idx, tabs, band]
    for k, bad in ((0, ar.double()), (2, prep[0].float()),
                   (3, prep[1][:, :-1]), (4, idx.to(torch.int32)),
                   (4, idx[:, :32]), (5, _tables(71, 100)),
                   (6, (band[0][:4], band[1])),
                   (6, (band[0], band[1][:, :-1]))):
        a = list(args)
        a[k] = bad
        with pytest.raises(ValueError):
            ck.fwd_stage2(*a)
    for bad in ((ar.double(), ai, idx), (ar, ai, idx[:, :8]),
                (ar, ai, idx.to(torch.int32))):
        with pytest.raises(ValueError):
            ck.stage2_band(*bad)
    # without the bulk the band must hold every column: 64 of 130 raises;
    # a band as wide as the corner runs, equal to the plain version
    with pytest.raises(ValueError):
        ck.fwd_stage2(ar, ai, None, None, idx, tabs, band)
    with pytest.raises(ValueError):             # one bf16 copy alone
        ck.fwd_stage2(ar, ai, prep[0], None, idx, tabs, band)
    narrow = [t[..., :64].contiguous() for t in (ar, ai)]
    whole = ck.static_band(3, 64, "cpu")
    got = ck.fwd_stage2(*narrow, None, None, whole, tabs,
                        ck.stage2_band(*narrow, whole))
    want = ck.fwd_stage2_plain(*narrow, whole, tabs, band="bf16x6")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ck.LAUNCHES == before
    assert tabs.stage2 is None                  # built on CUDA devices only


def test_fwd_corner_on_the_cpu_keeps_fwd_y_split(monkeypatch):
    """mix_adaptive on the CPU is _fwd_y_split's numerics (an f32 band, as
    JAX computes on the CPU); the kernels' wrappers are not called."""
    Ky, Kx = _dims()
    imgs = torch.from_numpy(_covers())

    def refuse(*a, **k):
        raise AssertionError("a stage-2 kernel wrapper ran on the CPU")

    monkeypatch.setattr(ck, "stage2_prep", refuse)
    monkeypatch.setattr(ck, "stage2_band", refuse)
    monkeypatch.setattr(ck, "fwd_stage2", refuse)
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    cr, ci = tcorner.fwd_corner(imgs, False, Ky, Kx, tabs, "mix_adaptive")
    ar, ai, _ = _stage1(_covers(), Ky, Kx)
    wr, wi = tcorner._fwd_y_split(ar, ai, tabs)
    assert torch.equal(cr.reshape(-1, Ky, Kx), wr)
    assert torch.equal(ci.reshape(-1, Ky, Kx), wi)
