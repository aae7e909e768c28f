"""K4 of the torch port, the inverse DFT's x-stage with the u8 epilogue
fused in (spectral/write_kernels.py ifft_epilogue over corner.ifft_corner_y),
on the CPU.

Held here: on CPU tensors the wrapper is the eager composition it replaced
(ifft_corner_real(scale=False), then K4e's epilogue) byte for byte; against
the JAX package's ifft_corner_real and corner_embed_core's epilogue
expression (parallel/batch.py:623-627) under the default precision, the
stego bytes within +-1 on at most K4_FRAC of them, counted, at 64x50,
128x128, 384x640 and an odd-width crop, both layouts, centering on and off
(both sides round the operands to bf16 and sum f32 products, in other
orders); a numpy f32 emulation of the kernel's operand algebra (the
[exr16; -exi16] table padded to (2Kxp, Wp) with zeros, the two A
descriptors' k-blocks summing to the plain t within 1e-5 of its scale, the
per-row (p, h) sign and the NHWC store offsets); the wrapper's input checks;
which kernel each embed core's epilogue takes in each precision mode. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3c)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu import spectral as jspectral
from steganosaurus_tpu.spectral import corner as jcorner
from steganosaurus_tpu_torch import spectral as tspectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel import batch as tpb
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.spectral import write_kernels as wk

torch.set_num_threads(2)

# stego bytes off by one against JAX's, at most (tests/test_torch_batch.py's
# bound: torch's and XLA's f32 sums of the same bf16 products in other
# orders land a few pixels on the other side of .5)
K4_FRAC = 1e-3
REL = 1e-5
GRIDS = [(2, 64, 50), (2, 128, 128), (1, 384, 640), (1, 384, 637)]
LAYOUTS = [(False, "nchw"), (True, "nchw"), (False, "nhwc"), (True, "nhwc")]


def _delta(B, H, W, seed):
    """A seeded corner delta (dr, di) (B, 3, Ky, Kx) f32 over 30% of the
    corner's bins, scaled so the image-plane write has an RMS of about 3
    (a stego's), and u8 cover planes (B, 3, H, W) with both clamp ends."""
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(seed)
    mask = rng.random((3, Ky, Kx)) < 0.3
    amp = 3.0 * H * W / np.sqrt(0.6 * Ky * Kx)
    dr, di = ((rng.normal(size=(B, 3, Ky, Kx)) * amp * mask).astype(
        np.float32) for _ in range(2))
    planes = rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)
    planes[0, 0, :2] = 0
    planes[0, 1, :2] = 255
    return dr, di, planes, (Ky, Kx)


@pytest.mark.parametrize("grid", GRIDS[:3])
@pytest.mark.parametrize("center,layout", LAYOUTS)
@pytest.mark.parametrize("conjugated", [False, True])
def test_ifft_epilogue_on_cpu_is_the_eager_composition(grid, center, layout,
                                                       conjugated):
    """ifft_corner_y + ifft_epilogue on CPU tensors: the bytes of
    ifft_corner_real(scale=False) + epilogue, on f32 deltas and on K3's
    bf16 operands (conjugated); values=True gives the f32 value before the
    rounding, apply_center(t / (H*W)); nothing is launched."""
    B, H, W = grid
    dr, di, planes, (Ky, Kx) = _delta(B, H, W, sum(grid))
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    dr, di = torch.from_numpy(dr), torch.from_numpy(di)
    if conjugated:
        dr, di = wk.ifft_operands_of(dr, di)
    planes = torch.from_numpy(planes)
    t = tcorner.ifft_corner_real(dr, di, H, W, tabs, "mix_adaptive",
                                 scale=False, conjugated=conjugated)
    want = wk.epilogue(t, planes, center, layout)
    before = dict(wk.LAUNCHES)
    mr16, mi16 = tcorner.ifft_corner_y(dr, di, tabs, conjugated=conjugated)
    assert mr16.dtype == mi16.dtype == torch.bfloat16
    assert mr16.shape == mi16.shape == (3 * B * H, Kx)
    got = wk.ifft_epilogue(mr16, mi16, tabs, planes, center, layout)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    v = wk.ifft_epilogue(mr16, mi16, tabs, planes, center, layout,
                         values=True)
    assert torch.equal(v, tspectral.apply_center(t * (1.0 / (H * W)),
                                                 center))
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("center,layout", LAYOUTS)
def test_ifft_epilogue_matches_jax(grid, center, layout, record_property):
    """The port's y-stage + K4 (plain on the CPU) against JAX's
    ifft_corner_real and corner_embed_core's epilogue under the default
    precision, on the same delta and covers: u8 bytes +-1, on at most
    K4_FRAC of them (counted)."""
    B, H, W = grid
    dr, di, planes, (Ky, Kx) = _delta(B, H, W, 7 * sum(grid) + center)
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    mr16, mi16 = tcorner.ifft_corner_y(torch.from_numpy(dr),
                                       torch.from_numpy(di), tabs)
    got = wk.ifft_epilogue(mr16, mi16, tabs, torch.from_numpy(planes),
                           center, layout).numpy()
    jt = jcorner.ifft_corner_real(jnp.asarray(dr), jnp.asarray(di), H, W,
                                  jcorner.dft_tables_device(H, Ky, W, Kx),
                                  jcorner.precision())
    jt = jspectral.apply_center(jt, center)
    want = jnp.clip(jnp.floor(jnp.asarray(planes, jnp.float32) + jt + 0.5),
                    0.0, 255.0).astype(jnp.uint8)
    if layout != "nchw":
        want = jnp.transpose(want, (0, 2, 3, 1))
    diff = got.astype(np.int16) - np.asarray(want).astype(np.int16)
    n_off = int(np.count_nonzero(diff))
    record_property("bytes_off", n_off)
    print(f"{grid} center {center} {layout}: {n_off} of {diff.size} bytes "
          f"off")
    assert got.shape == want.shape
    assert np.abs(diff).max() <= 1
    assert n_off <= K4_FRAC * diff.size
    assert (got == 0).any() and (got == 255).any()


@pytest.mark.parametrize("grid", GRIDS)
def test_kernel_operand_algebra(grid):
    """The kernel's arithmetic, emulated in numpy f32 on the plain
    operands: the table is [exr16; -exi16] zero-padded to (2Kxp, Wp),
    stored transposed; the k-blocks of 64 read from mr below Kxp and from
    mi above it (two descriptors, columns past Kx read as zeros), and their
    per-block f32 products summed in k order give the plain t within 1e-5
    of its scale; the sign (-1)^(h+w) from each flat row m's (p, h) = (m //
    H, m % H), and the stores at m*W + w (NCHW) and ((b*H + h)*W + w)*3 + c
    (NHWC, p = 3b + c), give the plain version's values and layouts."""
    B, H, W = grid
    dr, di, planes, (Ky, Kx) = _delta(B, H, W, 3 * sum(grid))
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    mr16, mi16 = tcorner.ifft_corner_y(torch.from_numpy(dr),
                                       torch.from_numpy(di), tabs)
    Kxp, Wp = -(-Kx // 64) * 64, -(-W // 64) * 64
    table = tcorner.ifft_x_table(tabs.exr16, tabs.exi16)
    assert table.dtype == torch.bfloat16 and table.is_contiguous()
    assert table.shape == (Wp, 2 * Kxp)
    T = table.float().numpy().T                        # (2Kxp, Wp)
    exr, exi = tabs.exr16.float().numpy(), tabs.exi16.float().numpy()
    np.testing.assert_array_equal(T[:Kx, :W], exr)
    np.testing.assert_array_equal(T[Kxp:Kxp + Kx, :W], -exi)
    pad = np.ones_like(T, dtype=bool)
    pad[:Kx, :W] = pad[Kxp:Kxp + Kx, :W] = False
    assert not T[pad].any()
    # the k loop over both descriptors: k-block kb reads mr (kb < Kxp/64)
    # or mi, zero past column Kx, against the table's rows kb*64..+63
    M = 3 * B * H
    a = [np.zeros((M, Kxp), np.float32) for _ in range(2)]
    a[0][:, :Kx] = mr16.float().numpy()
    a[1][:, :Kx] = mi16.float().numpy()
    acc = np.zeros((M, Wp), np.float32)
    for kb in range(2 * Kxp // 64):
        src = a[0] if kb < Kxp // 64 else a[1]
        k0 = kb * 64 % Kxp
        acc += src[:, k0:k0 + 64] @ T[kb * 64:kb * 64 + 64]
    pv = wk.ifft_epilogue_plain(mr16, mi16, tabs, torch.from_numpy(planes),
                                True, "nchw", values=True).numpy()
    t = tspectral.apply_center(torch.from_numpy(pv), True).numpy() * (H * W)
    scale = np.abs(t).max()
    assert not acc[:, W:].any()
    assert np.abs(acc[:, :W].reshape(B, 3, H, W) - t).max() <= REL * scale
    # the epilogue by flat row, as the kernel indexes it
    m = np.arange(M)[:, None]
    w = np.arange(W)[None, :]
    p, h = m // H, m % H
    inv = np.float32(1.0 / (H * W))
    v = acc[:, :W] * inv
    v = np.where((h + w) % 2 == 1, -v, v)
    x = v + planes.reshape(M, W).astype(np.float32)
    u8 = np.clip(np.floor(x + np.float32(0.5)), 0, 255).astype(np.uint8)
    want = wk.ifft_epilogue(mr16, mi16, tabs, torch.from_numpy(planes), True,
                            "nchw").numpy()
    diff = u8.reshape(B, 3, H, W).astype(np.int16) - want.astype(np.int16)
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= \
        K4_FRAC * diff.size
    nhwc = np.zeros(B * H * W * 3, np.uint8)
    b, c = p // 3, p % 3
    nhwc[(((b * H + h) * W + w) * 3 + c).reshape(-1)] = u8.reshape(-1)
    np.testing.assert_array_equal(
        nhwc.reshape(B, H, W, 3), u8.reshape(B, 3, H, W).transpose(0, 2, 3, 1))


def test_ifft_epilogue_rejects_bad_inputs():
    """Wrong dtypes, shapes, layouts and mixed devices raise, on the CPU as
    on the card; nothing is launched."""
    dr, di, planes, (Ky, Kx) = _delta(1, 64, 64, 5)
    tabs = tcorner.dft_tables_device(64, Ky, 64, Kx, "cpu")
    mr16, mi16 = tcorner.ifft_corner_y(torch.from_numpy(dr),
                                       torch.from_numpy(di), tabs)
    planes = torch.from_numpy(planes)
    before = dict(wk.LAUNCHES)
    meta = torch.empty(mi16.shape, dtype=torch.bfloat16, device="meta")
    for bad, match in (
            ((mr16.float(), mi16, tabs, planes), "mr16"),
            ((mr16, mi16[:-1], tabs, planes), "mi16"),
            ((mr16, mi16, tabs, planes.float()), "planes"),
            ((mr16, mi16, tabs, planes[:, :2]), "planes"),
            ((mr16.t(), mi16, tabs, planes), "mr16"),
            ((mr16[:, 1:].contiguous(), mi16[:, 1:].contiguous(), tabs,
              planes), "exr16"),
            ((mr16, meta, tabs, planes), "tensors on")):
        with pytest.raises(ValueError, match=match):
            wk.ifft_epilogue(*bad, False, "nchw")
    with pytest.raises(ValueError, match="layout"):
        wk.ifft_epilogue(mr16, mi16, tabs, planes, False, "hwc")
    m = torch.empty((3 * 64, Kx), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.ifft_epilogue(m, m, tabs._replace(
            exr16=tabs.exr16.to("meta"), exi16=tabs.exi16.to("meta")),
            planes.to("meta"), False, "nchw")
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("mode", ["mix_adaptive", "highest"])
def test_embed_cores_take_k4_or_k4e_by_precision(mode, monkeypatch):
    """Both embed cores end in K4 (ifft_epilogue, once) under mix_adaptive
    and in the f32 inverse DFT + K4e (epilogue, once) under highest; their
    stegos are those of the eager composition the tests of
    tests/test_torch_write.py hold them to."""
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    calls = []
    for name in ("ifft_epilogue", "epilogue"):
        real = getattr(wk, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(wk, name, counted)
    H, W, nb, n = 128, 192, 2, 1024
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(90)
    imgs = torch.from_numpy(rng.integers(0, 256, (nb, 3, H, W),
                                         dtype=np.uint8))
    flat = rng.choice(3 * Ky * Kx, n, replace=False)
    idx = np.unravel_index(flat, (3, Ky, Kx))
    maps = tpb.corner_statics_core(*(torch.from_numpy(a) for a in idx), Ky,
                                   Kx, n)
    frame = torch.from_numpy(rng.integers(0, 2, (nb, n), dtype=np.uint8))
    kw = dict(Ky=Ky, Kx=Kx, center=False, layout="nchw", floor=0.45)
    out = tpb.corner_embed_core(imgs, frame, maps, 0.5, **kw)
    per = [torch.from_numpy(np.stack([a] * nb)) for a in idx]
    jit = torch.zeros((nb, n), dtype=torch.float32)
    out2 = tpb.corner_piw_embed_core(imgs, frame, *per, jit, 0.5, **kw)
    want = "ifft_epilogue" if mode == "mix_adaptive" else "epilogue"
    assert calls == [want, want]
    assert out.shape == out2.shape == imgs.shape
    assert out.dtype == out2.dtype == torch.uint8


def test_k4_ablation_edits_apply_to_the_committed_source(monkeypatch):
    """Each variant of tools/k4_ablation_torch.py is a few text edits of
    csrc/corner_ifft_epilogue.cu (among them the stores issued by the
    consumers, the cover in registers, the cluster off, 3 stages and a
    fourth for the tiles TMA does not map): each
    text it replaces is there, once; --parent may be given more than once;
    and the tool refuses to run without a card (made to see none here, so
    that it never builds or launches anything)."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "k4_ablation_torch", repo / "tools" / "k4_ablation_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = _K4_SRC
    names = [name for name, _, _ in tool.VARIANTS]
    assert {"no epilogue", "stores by the consumers",
            "cover in registers", "cluster off", "3 stages",
            "plain ring of 4"} <= set(names)
    for name, _, edits in tool.VARIANTS:
        for old, new in edits:
            assert src.count(old) == 1, name
            assert old != new
    assert tool._args(["--parent", "a", "out.txt", "--parent", "b"]) == (
        ["a", "b"], ["out.txt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2


# --- the kernel's schedule, staging and stores, mirrored in numpy ----------

_K4_SRC = (__import__("pathlib").Path(wk.__file__).resolve().parent.parent
           / "csrc" / "corner_ifft_epilogue.cu").read_text()


def _cu_consts():
    """The integer and bool constexprs of the K4 source given as
    literals."""
    import re

    return {k: {"true": 1, "false": 0}.get(v) if v in ("true", "false")
            else int(v) for k, v in re.findall(
                r"constexpr (?:int|bool) (\w+) = (\d+|true|false);",
                _K4_SRC)}


K4 = _cu_consts()
# the smoke's 3c grids (chip_smoke.py K4_GRIDS): (B, H, W)
K4_CARD_GRIDS = [(64, 2160, 3840), (8, 1080, 1920), (8, 512, 512),
                 (1, 256, 256), (4, 1079, 1917), (64, 2160, 3839),
                 (8, 1170, 2532)]


def _stg_offset(lr, c):
    """csrc/corner_ifft_epilogue.cu's stg_offset: the byte of row lr,
    column c of a consumer warpgroup's staging."""
    return ((c >> 7) * 64 * K4["U8_BOX"] + lr * K4["U8_BOX"]
            + ((((c & 127) >> 4) ^ (lr & 7)) << 4) + (c & 15))


def _k4_walk(B, H, W, nhwc):
    """corner_ifft_epilogue's walk(): (n_nt, hblocks, n_mt, n_units)."""
    BM, BN, CL = K4["BM"], K4["BN"], K4["CLUSTER"]
    n_nt, hblocks = -(-W // BN), -(-H // K4["NH"])
    n_mt = B * hblocks if nhwc else -(-3 * B * H // BM)
    return n_nt, hblocks, n_mt, -(-n_mt // CL) * n_nt


def _k4_tile(unit, rank, n_nt, hblocks, n_mt, nhwc):
    """The kernel's tile_of: (ghost, m0, b, h0, n0)."""
    mp, nt = divmod(unit, n_nt)
    mt = K4["CLUSTER"] * mp + rank
    if nhwc:
        b, hb = divmod(mt, hblocks)
        return mt >= n_mt, 0, b, hb * K4["NH"], nt * K4["BN"]
    return mt >= n_mt, mt * K4["BM"], 0, 0, nt * K4["BN"]


@pytest.mark.parametrize("nhwc", [False, True])
@pytest.mark.parametrize("grid", K4_CARD_GRIDS)
def test_k4_cluster_walk_stores_every_tile_once(grid, nhwc):
    """The kernel's walk at the smoke's 3c grids, at the card's grid (66
    clusters of 2 blocks) and at a small one: the two blocks of a cluster
    take row blocks 2mp and 2mp+1 of one column block (the table boxes
    they share), every tile is computed by one block exactly once, and the
    lone block of an odd row-block count (a ghost) computes and stores
    nothing; the stores, mirrored box by box (NCHW: each warpgroup's two 64
    x 128 TMA boxes, issued where their first row is below P*H and first
    column below W, clipped by the map to P*H rows and W columns; NHWC: the
    staged rows h < H of min(BN, W - n0) pixels), write every output
    element exactly once."""
    B, H, W = grid
    M = 3 * B * H
    n_nt, hblocks, n_mt, n_units = _k4_walk(B, H, W, nhwc)
    assert K4["CLUSTER"] in (1, 2)
    for clusters in (min(66, n_units), 3):
        seen = {}
        ghosts = 0
        # NCHW: 64 x 128 cells of the (P*H, W) output; NHWC: the (b, h)
        # rows and 256-pixel column blocks
        cells = (np.zeros((-(-M // 64), -(-W // 128)), np.int64) if not nhwc
                 else np.zeros((B, H, n_nt), np.int64))
        area = 0
        for c in range(clusters):
            for unit in range(c, n_units, clusters):
                tiles = [_k4_tile(unit, r, n_nt, hblocks, n_mt, nhwc)
                         for r in range(K4["CLUSTER"])]
                assert len({tl[4] for tl in tiles}) == 1   # one column block
                for ghost, m0, b, h0, n0 in tiles:
                    if ghost:
                        ghosts += 1
                        continue
                    key = (m0, b, h0, n0)
                    seen[key] = seen.get(key, 0) + 1
                    if nhwc:
                        for hl in range(K4["NH"]):
                            if h0 + hl < H:
                                cells[b, h0 + hl, n0 // K4["BN"]] += 1
                                area += 3 * min(K4["BN"], W - n0)
                        continue
                    for w in range(2):
                        r0 = m0 + 64 * w
                        for j in range(2):
                            x0 = n0 + 128 * j
                            if r0 < M and x0 < W:
                                cells[r0 // 64, x0 // 128] += 1
                                area += (min(r0 + 64, M) - r0) * \
                                    (min(x0 + 128, W) - x0)
        assert ghosts == (n_mt % 2) * n_nt * (K4["CLUSTER"] - 1)
        assert len(seen) == n_mt * n_nt
        assert set(seen.values()) == {1}
        assert (cells == 1).all()
        assert area == M * W


def test_k4_staging_is_the_tma_box_and_banks_are_distinct():
    """A consumer warpgroup's staging: stg_offset gives every (row,
    column) of the 64 x 256 u8 tile its own byte of the 16 KB, and each
    one where a 128-byte-swizzled TMA box of 64 x 128 bytes keeps it (the
    box's linear offset with address bits 4-6 XORed with bits 7-9); the
    vector epilogue's words (the even lane of a pair row r, group g; the
    odd lane row r + 8, group g ^ 1) write every 4-byte word of the staging
    once, and a warp's 32 words of each step lie in 32 distinct banks."""
    lr, c = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    off = _stg_offset(lr, c)
    assert np.unique(off).size == 64 * 256 and off.max() == 64 * 256 - 1
    box, x = c // 128, c % 128
    linear = lr * 128 + x
    swz = linear ^ (((linear >> 7) & 7) << 4)
    np.testing.assert_array_equal(off, box * 64 * 128 + swz)
    words = np.zeros(64 * 256 // 4, np.int64)
    for warp in range(4):
        lane = np.arange(32)
        q, odd = lane & 3, lane & 1
        lv = warp * 16 + (lane >> 2) + 8 * odd
        for g in range(32):
            col = 8 * (g ^ odd) + 4 * (q >> 1)
            addr = _stg_offset(lv, col)
            assert (addr % 4 == 0).all()
            assert np.unique((addr // 4) % 32).size == 32
            np.add.at(words, addr // 4, 1)
    assert (words == 1).all()


def test_k4_u8_maps_take_the_tma_grids():
    """Which 3c grids store by TMA (the cover and stego 2-D u8 maps need
    rows of whole 16-byte words): 4K, 1080p, 512x512, 256x256; the 4b
    grid, 3839 and the phone width store from registers; the NHWC staging
    tile fits the 32 KB staging."""
    tma = [W % 16 == 0 for _, _, W in K4_CARD_GRIDS]
    assert tma == [True, True, True, True, False, False, False]
    assert "mode == OUT_NCHW && W % 16 == 0 && aligned16(planes) &&" in \
        _K4_SRC
    assert K4["NH"] * K4["BN"] * 3 <= 2 * 2 * 64 * K4["U8_BOX"]
