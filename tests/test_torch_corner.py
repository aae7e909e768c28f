"""The torch port's corner DFT math against the JAX package's
(steganosaurus_tpu_torch.spectral vs steganosaurus_tpu.spectral.corner).

Shapes: 384x640 images, which give a Ky = Kx = 256 corner — the DFT is
pruned on both axes and the 64-column band of mix_adaptive is a real
split. Inputs are numpy arrays made from a seed and handed to both
packages. Tolerances: 1e-5 of the output's scale where both sides compute
the same products in f32 and only the order of the f32 sums differs (the
bound of tests/test_spectral.py's stage-1 kernel test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu import spectral as jspectral
from steganosaurus_tpu.spectral import corner as jcorner
from steganosaurus_tpu.spectral import corner_pallas
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.spectral import corner_kernels as tk

torch.set_num_threads(2)

H, W, B = 384, 640, 4
MK = bytes(range(32))
REL = 1e-5


def _covers(seed=11):
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 235, W)
    img = base[None, None, :, None] + rng.integers(-18, 19, (B, H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _nchw(imgs):
    return np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))


def _dims():
    return tcorner.corner_dims(H, W, Params().rmax)


def _highest():
    return (jax.lax.Precision.HIGHEST,) * 4


def test_corner_dims_match():
    for h, w in ((384, 640), (512, 512), (2160, 3840), (100, 3000)):
        assert tcorner.corner_dims(h, w, 0.45) == jcorner.corner_dims(h, w,
                                                                      0.45)
    assert _dims() == (256, 256)


@pytest.mark.parametrize("N,K", [(640, 256), (384, 256), (3840, 1024)])
def test_dft_tables_equal_exactly(N, K):
    tr, ti = tcorner._dft_tables(N, K)
    jr, ji = jcorner._dft_tables(N, K)
    assert tr.dtype == np.float32 and tr.shape == (K, N)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ti, ji)
    tabs = tcorner.dft_tables_device(H, 256, W, 256, "cpu")
    np.testing.assert_array_equal(tabs.exr.numpy(),
                                  jcorner._dft_tables(W, 256)[0])
    np.testing.assert_array_equal(
        tabs.eyi16.to(torch.float32).numpy(),
        np.asarray(jnp.asarray(jcorner._dft_tables(H, 256)[1])
                   .astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("Wc,Kx", [(640, 256), (203, 64)])
@pytest.mark.parametrize("center", [False, True])
def test_stage1_plain_matches_pallas_and_einsum(center, Wc, Kx):
    """fwd_stage1_plain (what the K1 wrapper runs for CPU tensors) against
    the Pallas kernel in interpret mode and the production bf16 einsum, at
    the covers' width and at an odd width (the load route's; _pick_tile
    takes the whole W there)."""
    imgs = np.ascontiguousarray(_nchw(_covers())[:1, ..., :Wc])  # (1, 3, H, Wc)
    exr, exi = jcorner._dft_tables(Wc, Kx)
    exr16 = torch.from_numpy(exr).to(torch.bfloat16)
    exi16 = torch.from_numpy(exi).to(torch.bfloat16)
    ar, ai = tk.fwd_stage1_plain(torch.from_numpy(imgs), exr16, exi16, center)
    planes = np.asarray(jspectral.apply_center(
        jnp.asarray(imgs[0].astype(np.float32)), center))
    assert corner_pallas._pick_tile(Wc, 512, 128) == (Wc if Wc % 128 else 128)
    pr, pi = corner_pallas.fwd_stage1(planes, exr, exi, interpret=True)
    er = jcorner._mm("phw,xw->phx", jnp.asarray(planes), jnp.asarray(exr),
                     "bf16")
    ei = jcorner._mm("phw,xw->phx", jnp.asarray(planes), jnp.asarray(exi),
                     "bf16")
    scale = float(jnp.max(jnp.abs(er)))
    for got, want in ((ar[0], pr), (ai[0], pi), (ar[0], er), (ai[0], ei)):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) \
            <= REL * scale


def test_stage1_wrapper_takes_plain_on_cpu_and_checks_inputs():
    imgs = torch.from_numpy(_nchw(_covers())[:1])
    exr, exi = (torch.from_numpy(t).to(torch.bfloat16)
                for t in jcorner._dft_tables(W, 256))
    before = dict(tk.LAUNCHES)
    ar, ai = tk.fwd_stage1(imgs, exr, exi, False)
    pr, pi = tk.fwd_stage1_plain(imgs, exr, exi, False)
    torch.testing.assert_close(ar, pr, rtol=0, atol=0)
    torch.testing.assert_close(ai, pi, rtol=0, atol=0)
    assert ar.shape == (1, 3, H, 256) and ar.dtype == torch.float32
    assert tk.LAUNCHES == before  # CPU tensors never count as a launch
    with pytest.raises(ValueError):
        tk.fwd_stage1(imgs.to(torch.float32), exr, exi, False)
    with pytest.raises(ValueError):
        tk.fwd_stage1(imgs, exr.to(torch.float32), exi, False)
    with pytest.raises(ValueError):
        tk.fwd_stage1(imgs, exr[:, :-1], exi[:, :-1], False)


# --- the algebra the wgmma kernel (csrc/corner_stage1_wgmma.cu) relies on ---

def _ragged_stage1_inputs(seed, P=3, Hs=37, Ws=80, Kx=45):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (P, Hs, Ws), dtype=np.uint8))
    exr, exi = (torch.from_numpy(t).to(torch.bfloat16)
                for t in tcorner._dft_tables(Ws, Kx))
    return imgs, exr, exi


def _wgmma_emulation(imgs, tables, Kx, center, paired=True):
    """What the wgmma kernel computes, in plain torch: the u8 rows padded to
    Wp and read in k_order, one f32 product with the concatenated table,
    the (-1)^h row sign, then the split of the columns into ar and ai (the
    paired table's stage1_rows, or exr rows then exi rows at Kxp)."""
    P, Hs, Ws = imgs.shape
    t = tables[1] if center else tables[0]
    Np, Wp = t.shape
    rows = torch.zeros((P * Hs, Wp))
    rows[:, :Ws] = imgs.reshape(-1, Ws).to(torch.float32)
    out = rows[:, tk.k_order(Wp)] @ t.to(torch.float32).T
    if center:
        out *= (1 - 2 * (torch.arange(P * Hs) % Hs % 2)).to(out.dtype)[:, None]
    rr, ri = tk.stage1_rows(Kx)
    if not paired:
        rr, ri = torch.arange(Kx), Np // 2 + torch.arange(Kx)
    return out[:, rr].reshape(P, Hs, Kx), out[:, ri].reshape(P, Hs, Kx)


def test_stage1_centering_folds_out_of_the_operand_bit_for_bit():
    """The plain version fed the (-1)^w-folded tables, then the (-1)^h row
    sign, equals fwd_stage1_plain(..., center=True) bit for bit, at a
    ragged shape: every bf16 x bf16 product is exact in f32, and a sign flip
    of whole terms and of a whole row sum changes no rounding."""
    imgs, exr, exi = _ragged_stage1_inputs(31, Ws=203)
    sw = (1 - 2 * (torch.arange(203) % 2)).to(torch.bfloat16)
    fr, fi = tk.fwd_stage1_plain(imgs, exr * sw, exi * sw, False)
    sh = (1 - 2 * (torch.arange(37) % 2)).to(torch.float32)[:, None]
    pr, pi = tk.fwd_stage1_plain(imgs, exr, exi, True)
    assert torch.equal(fr * sh, pr) and torch.equal(fi * sh, pi)
    assert not torch.equal(fr, pr)  # the centering did change the product


def test_stage1_tables_layout():
    """The paired table: in each 256-row tile 128 rows of exr, then the same
    128 rows of exi (Kx rounded up to 128), zeros elsewhere, columns in
    k_order (a permutation inside every 64-wide block), the centered copy
    the (-1)^w-signed one."""
    _, exr, exi = _ragged_stage1_inputs(32, Ws=80, Kx=45)
    t, tc, kx = tk.stage1_tables(exr, exi)
    assert kx == 45
    assert t.shape == tc.shape == (256, 128) and t.dtype == torch.bfloat16
    order = tk.k_order(128)
    for b in range(2):
        blk = order[64 * b:64 * (b + 1)]
        assert sorted(blk.tolist()) == list(range(64 * b, 64 * (b + 1)))
    # logical k = 16s + r of block 0 reads pixel 16q + 4s + e
    assert order[:16].tolist() == [0, 1, 16, 17, 32, 33, 48, 49,
                                   2, 3, 18, 19, 34, 35, 50, 51]
    inv = torch.argsort(order)
    plain_t = t[:, inv]
    assert torch.equal(plain_t[:45, :80], exr)
    assert torch.equal(plain_t[128:173, :80], exi)
    assert not plain_t[45:128].any() and not plain_t[173:].any()
    assert not plain_t[:, 80:].any()
    sign = (1 - 2 * (torch.arange(128) % 2)).to(torch.bfloat16)
    assert torch.equal(tc[:, inv], plain_t * sign)
    # Kx = 300: three tiles, the last holding exr and exi rows 256..299
    _, exr, exi = _ragged_stage1_inputs(35, Ws=80, Kx=300)
    plain_t = tk.stage1_tables(exr, exi)[0][:, inv]
    assert plain_t.shape == (768, 128)
    for j, n in ((0, 128), (1, 128), (2, 44)):
        k = slice(128 * j, 128 * j + n)
        assert torch.equal(plain_t[256 * j:256 * j + n, :80], exr[k])
        assert torch.equal(plain_t[256 * j + 128:256 * j + 128 + n, :80],
                           exi[k])
    assert not plain_t[512 + 44:640].any() and not plain_t[640 + 44:].any()
    rr, ri = tk.stage1_rows(300)
    assert torch.equal(plain_t[rr, :80], exr)
    assert torch.equal(plain_t[ri, :80], exi)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("Ws,Kx", [(80, 45), (528, 100), (64, 64),
                                   (203, 45), (250, 130), (1917, 512)])
def test_stage1_concatenated_gemm_matches_plain(center, Ws, Kx):
    """The kernel's GEMM emulated on the CPU (k_order, the rows padded
    with zeros to Wp as both routes leave them in shared memory, one
    product with the concatenated table, row sign, the ar/ai column split)
    against fwd_stage1_plain, at widths of both routes: within 1e-5 of
    max|plain| (the f32 sum runs in another order), and bit for bit when
    every partial sum is exact (integer tables of small magnitude)."""
    imgs, exr, exi = _ragged_stage1_inputs(33 + Kx, P=2, Ws=Ws, Kx=Kx)
    tables = tk.stage1_tables(exr, exi)
    er, ei = _wgmma_emulation(imgs, tables, Kx, center)
    pr, pi = tk.fwd_stage1_plain(imgs, exr, exi, center)
    scale = float(max(pr.abs().max(), pi.abs().max()))
    assert er.shape == pr.shape == (2, 37, Kx)
    assert float(max((er - pr).abs().max(), (ei - pi).abs().max())) \
        <= 1e-5 * scale
    rng = np.random.default_rng(Ws)
    ir, ii = (torch.from_numpy(rng.integers(-8, 9, (Kx, Ws))).to(
        torch.bfloat16) for _ in range(2))
    er, ei = _wgmma_emulation(imgs, tk.stage1_tables(ir, ii), Kx, center)
    pr, pi = tk.fwd_stage1_plain(imgs, ir, ii, center)
    assert torch.equal(er, pr) and torch.equal(ei, pi)


def _k1_tool():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "k1_ablation_torch.py")
    spec = importlib.util.spec_from_file_location(path.stem, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("Ws,Kx", [(80, 45), (250, 300), (528, 1000),
                                   (203, 128), (64, 64)])
def test_stage1_paired_table_holds_the_old_tables(Ws, Kx):
    """The paired table against the exr-then-exi one K1 took before
    (tools/k1_ablation_torch.py old_table): the same rows, so
    fwd_stage1_plain on the tables read back from either layout gives the
    same ar and ai bit for bit, and the kernel's GEMM emulated on each
    layout (integer tables: exact sums) too, Kxp/64 odd (Kx = 45, 300,
    1000) and even."""
    tool = _k1_tool()
    imgs, exr, exi = _ragged_stage1_inputs(36 + Kx, P=2, Ws=Ws, Kx=Kx)
    t = tk.stage1_tables(exr, exi)[0]
    old = tool.old_table(t, Kx)
    Kxp = tk._pad64(Kx)
    assert old.shape == (2 * Kxp, t.shape[1])
    inv = torch.argsort(tk.k_order(t.shape[1]))
    rr, ri = tk.stage1_rows(Kx)
    new_tabs = (t[rr][:, inv][:, :Ws], t[ri][:, inv][:, :Ws])
    old_tabs = (old[:Kx][:, inv][:, :Ws], old[Kxp:Kxp + Kx][:, inv][:, :Ws])
    assert torch.equal(new_tabs[0], exr) and torch.equal(new_tabs[1], exi)
    assert not old[Kx:Kxp].any() and not old[Kxp + Kx:].any()
    for center in (False, True):
        a = tk.fwd_stage1_plain(imgs, *new_tabs, center)
        b = tk.fwd_stage1_plain(imgs, *old_tabs, center)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rng = np.random.default_rng(Ws + Kx)
    ir, ii = (torch.from_numpy(rng.integers(-8, 9, (Kx, Ws))).to(
        torch.bfloat16) for _ in range(2))
    t = tk.stage1_tables(ir, ii)
    for center in (False, True):
        a = _wgmma_emulation(imgs, t, Kx, center)
        tc = t[1] if center else t[0]
        out = _wgmma_emulation(imgs, (tool.old_table(tc, Kx),) * 2, Kx,
                               center, paired=False)
        assert torch.equal(a[0], out[0]) and torch.equal(a[1], out[1])


def test_k1_entry_and_ablation_tool():
    """K1's C entry takes the argument kinds _build binds it with (its
    images, table, ar, ai, copies and partials; sizes, ldk and the prep
    flag); the parent before the paired table (5b99743) takes
    parent_kernels_torch.OLD_SIGNATURES'; each variant of
    tools/k1_ablation_torch.py is text of the committed source, there once;
    --parent may be given more than once."""
    import pathlib

    from steganosaurus_tpu_torch import _build

    root = pathlib.Path(__file__).resolve().parent.parent
    tool = _k1_tool()
    pk = _load(root / "tools" / "parent_kernels_torch.py")
    text = (_build.CSRC / "corner_stage1_wgmma.cu").read_text()
    entry = "corner_stage1_wgmma"
    assert pk.c_kinds(text, entry) == pk.kinds_of(_build._SIGNATURES[entry])
    assert pk.OLD_SIGNATURES[entry] != _build._SIGNATURES[entry]
    for name, _, edits in tool.VARIANTS:
        for old, new in edits:
            assert text.count(old) == 1, name
            assert old != new
    assert tool._args(["--parent", "a", "out.txt", "--parent", "b"]) == (
        ["a", "b"], ["out.txt"])
    src = pk.parent_source("5b99743", "corner_stage1_wgmma.cu")
    if src is None:
        pytest.skip("no git history to read the parent's source from")
    assert pk.takes_old_signature(src, entry)


def _load(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage1_kernel_routing_by_width():
    """W % 16 == 0 with a 16-byte-aligned base takes the TMA route, any
    other W or base the load route; each counts under its own name, and a
    CPU tensor counts nothing."""
    assert tk.route_for(3840, 0) == tk.route_for(1920, 4096) == tk.KERNEL_TMA
    assert tk.route_for(512, 16) == tk.route_for(528, 32) == tk.KERNEL_TMA
    assert tk.route_for(203, 0) == tk.route_for(520, 0) == tk.KERNEL_LDG
    assert tk.route_for(3839, 0) == tk.route_for(3841, 16) == tk.KERNEL_LDG
    for addr in (1, 4, 8, 15, 3840 * 7 + 3):  # an unaligned view, W % 16 == 0
        assert tk.route_for(3840, addr) == tk.KERNEL_LDG
    assert set(tk.LAUNCHES) == {tk.KERNEL_TMA, tk.KERNEL_LDG,
                                tk.KERNEL_K1_PREP, tk.KERNEL_PREP,
                                tk.KERNEL_PREP_REDUCE, tk.KERNEL_BAND,
                                tk.KERNEL_STAGE2}
    assert tk.K1_ROUTES == (tk.KERNEL_TMA, tk.KERNEL_LDG)
    assert tk.KERNEL_TMA == "corner_stage1_wgmma"
    assert tk.KERNEL_LDG == "corner_stage1_wgmma_ldg"
    before = dict(tk.LAUNCHES)
    for Ws in (80, 203):
        imgs, exr, exi = _ragged_stage1_inputs(34, Ws=Ws)
        ar, ai = tk.fwd_stage1(imgs, exr, exi, True)
        pr, pi = tk.fwd_stage1_plain(imgs, exr, exi, True)
        assert torch.equal(ar, pr) and torch.equal(ai, pi)
    assert tk.LAUNCHES == before
    tabs = tcorner.dft_tables_device(37, 64, 80, 64, "cpu")
    assert tabs.stage1 is None  # built on CUDA devices only


def _realign16(window: np.ndarray, ro: int) -> np.ndarray:
    """The load route's realign of one lane, in numpy: the staged 32 bytes
    as 8 little-endian words, a word shift by ro // 4 in two selects, then
    four __funnelshift_r by 8 (ro % 4) -> 16 bytes."""
    v = [int(w) for w in window.view("<u4")]
    u = [v[i + 2] if ro & 8 else v[i] for i in range(6)]
    w = [u[i + 1] if ro & 4 else u[i] for i in range(5)]
    bs = 8 * (ro & 3)
    out = [((w[i + 1] << 32 | w[i]) >> bs) & 0xFFFFFFFF for i in range(4)]
    return np.array(out, dtype="<u4").view(np.uint8)


def _load_route_slot(mem, xa, W, M, m0, kb):
    """What the load route's producer warps leave in the A slot of the tile
    at row m0, k-block kb: the kernel's cp.async copies (5 aligned 16-byte
    chunks a row, each read for its source size only) into a staged row,
    then its realign, on the bytes `mem` of an allocation whose address 0 is
    16-byte aligned, the images at byte xa. Returns the slot and the
    (first byte, end, image row) of every copy."""
    c = 64 * kb
    stg = np.full((128, 80), 0xEE, dtype=np.uint8)  # stale bytes
    reads = []
    for r in range(128):                        # lane r % 32 of a warp
        co = (xa + r * W) % 16                  # one constant per lane
        assert co == (xa + (m0 + r) * W) % 16   # tiles are 128W bytes apart
        src0 = xa + (m0 + r) * W + c - co       # aligned: pixel c at +co
        left = W - c + co                       # bytes of the row from src0
        for j in range(5):
            n = min(max(left - 16 * j, 0), 16)
            live = m0 + r < M and n > 0 and (j < 4 or co != 0)
            n = n if live else 0
            src = src0 + 16 * j
            stg[r, 16 * j:16 * j + 16] = 0
            stg[r, 16 * j:16 * j + n] = mem[src:src + n]
            if n:
                reads.append((src, src + n, m0 + r))
    slot = np.zeros((128, 64), dtype=np.uint8)
    for r in range(128):
        rl = r % 32                             # the lane's first row
        ro = (xa + rl * W) % 16                 # one constant per lane
        assert ro == (xa + r * W) % 16          # rows 32 apart: 32W % 16 == 0
        for k in range(4):
            slot[r, 16 * k:16 * k + 16] = _realign16(
                stg[r, 16 * k:16 * k + 32], ro)
    return slot, reads


@pytest.mark.parametrize("W,M,xa", [
    (203, 150, 0), (203, 150, 5), (250, 129, 13), (17, 40, 2), (3, 7, 9),
    (1917, 130, 7), (512, 140, 1)])
def test_stage1_load_route_staging_emulation(W, M, xa):
    """The load route's index arithmetic: every slot it fills holds the
    row's pixels c..c+63, zeros past W and zero rows past P*H, at any width
    and base; no copy reads a byte past the images' last byte, before the
    16-byte chunk that holds their first, or past the end of its row."""
    rng = np.random.default_rng(W + M + xa)
    pad = 64
    mem = rng.integers(0, 256, xa + M * W + pad, dtype=np.uint8)
    imgs = mem[xa:xa + M * W].reshape(M, W)
    Wp = -(-W // 64) * 64
    want = np.zeros((-(-M // 128) * 128, Wp), dtype=np.uint8)
    want[:M, :W] = imgs
    for m0 in range(0, M, 128):
        for kb in range(Wp // 64):
            slot, reads = _load_route_slot(mem, xa, W, M, m0, kb)
            np.testing.assert_array_equal(
                slot, want[m0:m0 + 128, 64 * kb:64 * kb + 64])
            for lo, hi, row in reads:
                assert xa - xa % 16 <= lo and hi <= xa + M * W
                assert hi <= xa + (row + 1) * W  # never past its row's end


@pytest.mark.parametrize("center", [False, True])
def test_fwd_corner_highest_matches_jax(center):
    imgs = _nchw(_covers())
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    cr, ci = tcorner.fwd_corner(torch.from_numpy(imgs), center, Ky, Kx, tabs,
                                "highest")
    planes = jspectral.apply_center(jnp.asarray(imgs, jnp.float32), center)
    jr, ji = jcorner.fwd_corner(planes, Ky, Kx,
                                jcorner.dft_tables_device(H, Ky, W, Kx),
                                _highest())
    scale = float(jnp.max(jnp.maximum(jnp.abs(jr), jnp.abs(ji))))
    assert cr.shape == (B, 3, Ky, Kx)
    assert float(np.max(np.abs(cr.numpy() - np.asarray(jr)))) <= REL * scale
    assert float(np.max(np.abs(ci.numpy() - np.asarray(ji)))) <= REL * scale


def _corner_delta(seed=12):
    """A sparse pre-doubled corner delta like write_delta's output."""
    rng = np.random.default_rng(seed)
    Ky, Kx = _dims()
    mask = rng.random((3, Ky, Kx)) < 0.3
    dr = (rng.normal(size=(B, 3, Ky, Kx)) * 2e4 * mask).astype(np.float32)
    di = (rng.normal(size=(B, 3, Ky, Kx)) * 2e4 * mask).astype(np.float32)
    return dr, di


@pytest.mark.parametrize("mode", ["highest", "mix_adaptive"])
def test_ifft_corner_real_matches_jax(mode, monkeypatch):
    """Under highest both sides are f32 products; under mix_adaptive both
    round the operands through bf16 (on the CPU, JAX's _mm emulation)."""
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    dr, di = _corner_delta()
    Ky, Kx = _dims()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    t = tcorner.ifft_corner_real(torch.from_numpy(dr), torch.from_numpy(di),
                                 H, W, tabs, tcorner.precision())
    jt = jcorner.ifft_corner_real(jnp.asarray(dr), jnp.asarray(di), H, W,
                                  jcorner.dft_tables_device(H, Ky, W, Kx),
                                  jcorner.precision())
    scale = float(jnp.max(jnp.abs(jt)))
    assert t.shape == (B, 3, H, W)
    assert float(np.max(np.abs(t.numpy() - np.asarray(jt)))) <= REL * scale


def test_precision_modes(monkeypatch):
    """Every name the JAX package's precision() takes resolves, in any
    case, to the JAX tuple's stage precisions (its order: stage 1, forward
    stage 2, the inverse's x-stage, its y-stage); an unknown name raises
    (the JAX package runs it as highest)."""
    monkeypatch.delenv("STEGANOSAURUS_MM_PRECISION", raising=False)
    assert tcorner.precision().name == "mix_adaptive"
    names = {jax.lax.Precision.HIGH: "high",
             jax.lax.Precision.HIGHEST: "highest"}
    assert set(tcorner.MODES) == {"mix_split", "mix_adaptive", "mix", "mix3",
                                  "mix2", "mix_conservative", "bf16", "high",
                                  "highest"}
    for name in tcorner.MODES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("STEGANOSAURUS_MM_PRECISION", name.upper())
            p = tcorner.precision()
            want = tuple(names.get(v, v) for v in jcorner.precision())
            assert p.name == name
            assert (p.stage1, p.fwd2, p.inv_x, p.inv_y) == want
    for name in ("mix4", "fp32", "highest "):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("STEGANOSAURUS_MM_PRECISION", name)
            with pytest.raises(ValueError):
                tcorner.precision()


def _jax_stego():
    """A JAX embed of 128-byte secrets at fixed salts (nchw)."""
    from steganosaurus_tpu.pipeline import batch as jbatch

    imgs = _nchw(_covers())
    rng = np.random.default_rng(13)
    secrets = [bytes(rng.integers(0, 256, 128, dtype=np.uint8))
               for _ in range(B)]
    res = jbatch.embed_batch(imgs, secrets, master_key=MK,
                             salts=[bytes([i]) * 16 for i in range(B)],
                             layout="nchw")
    return np.array(res.stego), 912 + (128 + 16) * 56


def test_mix_adaptive_matches_jax_bits_and_band():
    """Under the default mix_adaptive, on a stego: the band columns (top-64
    stage-1 energy per image and plane) are the same set, the corner
    spectra agree to 1e-5 of their scale, and the bits read at every walk
    bin are equal."""
    stego, nbits = _jax_stego()
    Ky, Kx = _dims()
    x = torch.from_numpy(stego)
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    ar, ai = tk.fwd_stage1(x.reshape(-1, H, W), tabs.exr16, tabs.exi16, False)
    assert tcorner.SPLIT_X0 == jcorner.split_x0() == 64
    idx = tcorner.band_columns(ar, ai, tcorner.SPLIT_X0).numpy()

    jtabs = jcorner.dft_tables_device(H, Ky, W, Kx)
    planes = jnp.asarray(stego.reshape(-1, H, W), jnp.float32)
    jar = jcorner._mm("phw,xw->phx", planes, jtabs[2], "bf16")
    jai = jcorner._mm("phw,xw->phx", planes, jtabs[3], "bf16")
    _, jidx = jax.lax.top_k(jnp.sum(jar * jar + jai * jai, axis=-2),
                            jcorner.split_x0())
    np.testing.assert_array_equal(np.sort(idx, -1),
                                  np.sort(np.asarray(jidx), -1))

    cr, ci = tcorner.fwd_corner(x, False, Ky, Kx, tabs, "mix_adaptive")
    jr, ji = jcorner.fwd_corner(jnp.asarray(stego, jnp.float32), Ky, Kx,
                                jtabs, jcorner.precision())
    scale = float(jnp.max(jnp.maximum(jnp.abs(jr), jnp.abs(ji))))
    assert float(np.max(np.abs(cr.numpy() - np.asarray(jr)))) <= REL * scale
    assert float(np.max(np.abs(ci.numpy() - np.asarray(ji)))) <= REL * scale

    plane, y, xx, _ = tbatch._walk_indices(None, MK, Params(), H, W, nbits)
    sign = float(np.sign(np.sin(np.float32(Params().alpha))))
    walk = tuple(torch.from_numpy(a.astype(np.int64)) for a in (plane, y, xx))
    got = tcorner.read_bits_dense(ci[(slice(None),) + walk], sign).numpy()
    want = np.asarray(jcorner.read_bits_dense(jr, ji, sign))[:, plane, y, xx]
    np.testing.assert_array_equal(got, want)


def test_write_delta_and_floor_match_jax():
    """The dense hard write (no jitter) and the quantization write floor,
    in a regime where the floor boosts (b > 1) some images and not
    others."""
    rng = np.random.default_rng(14)
    Ky, Kx = _dims()
    cr = (rng.normal(size=(B, 3, Ky, Kx)) * 1e4).astype(np.float32)
    ci = (rng.normal(size=(B, 3, Ky, Kx)) * 1e4).astype(np.float32)
    cr[0] *= 1e-3                                  # weak cover: floor boosts
    ci[0] *= 1e-3
    sign = (rng.integers(0, 2, (B, 3, Ky, Kx)) * 2 - 1).astype(np.float32)
    mask = (rng.random((3, Ky, Kx)) < 0.2).astype(np.float32)
    alpha = np.float32(Params().alpha)
    ca, sa = np.cos(alpha), np.sin(alpha)
    t = [torch.from_numpy(a) for a in (cr, ci, sign, mask)]
    dr, di = tcorner.write_delta(*t, torch.tensor(ca), torch.tensor(sa))
    jdr, jdi = jcorner.write_delta(*map(jnp.asarray, (cr, ci, sign, mask)),
                                   jnp.float32(ca), jnp.float32(sa))
    np.testing.assert_allclose(dr.numpy(), np.asarray(jdr), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jdr))))
    np.testing.assert_allclose(di.numpy(), np.asarray(jdi), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jdi))))
    floor, pix = Params().write_floor, float(H * W)
    br, bi = tcorner.apply_write_floor(dr, di, t[0], t[1], floor, pix)
    jbr, jbi = jcorner.apply_write_floor(jdr, jdi, jnp.asarray(cr),
                                         jnp.asarray(ci), floor, pix)
    boosted = np.abs(np.asarray(jbr) - np.asarray(jdr)).reshape(B, -1).max(1)
    assert boosted[0] > 0 and boosted[1:].max() == 0  # b > 1 only for img 0
    np.testing.assert_allclose(br.numpy(), np.asarray(jbr), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jbr))))
    np.testing.assert_allclose(bi.numpy(), np.asarray(jbi), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jbi))))


def test_jittered_write_and_read_match_jax():
    """The jittered dense write (theta = jd + s*alpha) and the jittered
    phase read d = sign(sin a) * (Im C cos jd - Re C sin jd) against the
    JAX package's write_delta / read_bits_dense with cjd/sjd maps."""
    rng = np.random.default_rng(15)
    Ky, Kx = _dims()
    cr = (rng.normal(size=(B, 3, Ky, Kx)) * 1e4).astype(np.float32)
    ci = (rng.normal(size=(B, 3, Ky, Kx)) * 1e4).astype(np.float32)
    sign = (rng.integers(0, 2, (B, 3, Ky, Kx)) * 2 - 1).astype(np.float32)
    mask = (rng.random((3, Ky, Kx)) < 0.2).astype(np.float32)
    jd = rng.uniform(-0.2, 0.2, (3, Ky, Kx)).astype(np.float32)
    cjd, sjd = np.cos(jd), np.sin(jd)
    alpha = np.float32(Params().alpha)
    ca, sa = np.cos(alpha), np.sin(alpha)
    t = [torch.from_numpy(a) for a in (cr, ci, sign, mask, cjd, sjd)]
    dr, di = tcorner.write_delta(*t[:4], torch.tensor(ca), torch.tensor(sa),
                                 t[4], t[5])
    jdr, jdi = jcorner.write_delta(*map(jnp.asarray, (cr, ci, sign, mask)),
                                   jnp.float32(ca), jnp.float32(sa),
                                   jnp.asarray(cjd), jnp.asarray(sjd))
    np.testing.assert_allclose(dr.numpy(), np.asarray(jdr), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jdr))))
    np.testing.assert_allclose(di.numpy(), np.asarray(jdi), rtol=0,
                               atol=REL * float(jnp.max(jnp.abs(jdi))))
    # a written bin reads back its bit under the same jitter
    nr, ni = t[0] + 0.5 * dr, t[1] + 0.5 * di
    ssa = float(np.sign(np.sin(alpha)))
    got = tcorner.read_bits_dense(ni, ssa, nr, t[4], t[5]).numpy()
    want = np.asarray(jcorner.read_bits_dense(
        jnp.asarray(nr.numpy()), jnp.asarray(ni.numpy()), ssa,
        jnp.asarray(cjd), jnp.asarray(sjd)))
    np.testing.assert_array_equal(got, want)
    m = mask.astype(bool)[None].repeat(B, 0)
    np.testing.assert_array_equal(got[m], (sign[m] > 0).astype(np.uint8))
