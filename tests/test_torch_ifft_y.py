"""K6 of the torch port, the inverse DFT's y-stage (spectral/write_kernels.py
ifft_y, routed by corner.ifft_corner_y), on the CPU.

Held here: on CPU tensors the routed ifft_corner_y is the eager chain it
replaced (corner._ifft_y's four bf16 products, their difference and sum,
then the casts) byte for byte, on f32 deltas and on K3's bf16 operands;
against the JAX package's ifft_corner_real and corner_embed_core's
epilogue expression under the default precision, the port's y-stage
followed by the x-stage's plain version and the epilogue keeps the stego
bytes within +-1 on at most K4_FRAC of them, counted, at 64x50, 128x128,
384x640 and an odd-width crop; a numpy f32 emulation of the kernel's
operand algebra (ifft_y_table's layout, signs and zero padding; the two B
maps' k-blocks summing to (mr, mi) within 1e-5 of their scale; the row
split into mr and mi with the padding rows skipped; the staging copy of
ifft_y_rows read with the maps' strides); the wrapper's input checks; which
y-stage each embed core takes in each precision mode; and the ablation
tool's edits. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3e)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu import spectral as jspectral
from steganosaurus_tpu.spectral import corner as jcorner
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel import batch as tpb
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch.spectral import write_kernels as wk

torch.set_num_threads(2)

# stego bytes off by one against JAX's, at most (tests/test_torch_batch.py's
# and tests/test_torch_ifft_epilogue.py's bound: torch's and XLA's f32 sums
# of the same bf16 products in other orders land a few pixels on the other
# side of .5)
K4_FRAC = 1e-3
REL = 1e-5
GRIDS = [(2, 64, 50), (2, 128, 128), (1, 384, 640), (1, 384, 637)]


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


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("conjugated", [False, True])
def test_ifft_corner_y_on_cpu_is_the_eager_chain(grid, conjugated):
    """ifft_corner_y on CPU tensors: the bytes of the eager chain
    (corner._ifft_y under mix_adaptive, then .to(bf16)), on f32 deltas and
    on K3's bf16 operands (conjugated); ifft_y's values=True gives that
    chain's f32 sums; nothing is launched."""
    B, H, W = grid
    dr, di, _, (Ky, Kx) = _delta(B, H, W, sum(grid))
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    dr, di = torch.from_numpy(dr), torch.from_numpy(di)
    if conjugated:
        dr, di = wk.ifft_operands_of(dr, di)
    mr, mi = tcorner._ifft_y(dr, di, tabs, "mix_adaptive", conjugated)
    P = 3 * B
    before = dict(wk.LAUNCHES)
    mr16, mi16 = tcorner.ifft_corner_y(dr, di, tabs, conjugated=conjugated)
    assert mr16.dtype == mi16.dtype == torch.bfloat16
    assert mr16.shape == mi16.shape == (P * H, Kx)
    assert torch.equal(mr16, mr.to(torch.bfloat16).reshape(P * H, Kx))
    assert torch.equal(mi16, mi.to(torch.bfloat16).reshape(P * H, Kx))
    dcr, dci = ((dr, di) if conjugated else wk.ifft_operands_of(dr, di))
    vr, vi = wk.ifft_y(dcr, dci, tabs, values=True)
    assert vr.dtype == torch.float32
    assert torch.equal(vr, mr.reshape(P * H, Kx))
    assert torch.equal(vi, mi.reshape(P * H, Kx))
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("conjugated", [False, True])
def test_ifft_y_then_x_stage_matches_jax(grid, conjugated, record_property):
    """The port's y-stage (plain on the CPU), then the x-stage's plain
    version and the u8 epilogue (ifft_epilogue), against JAX's
    ifft_corner_real and corner_embed_core's epilogue under the default
    precision on the same delta and covers: u8 bytes +-1, on at most
    K4_FRAC of them (counted)."""
    B, H, W = grid
    center = conjugated
    dr, di, planes, (Ky, Kx) = _delta(B, H, W, 11 * sum(grid) + center)
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    tdr, tdi = torch.from_numpy(dr), torch.from_numpy(di)
    if conjugated:
        tdr, tdi = wk.ifft_operands_of(tdr, tdi)
    mr16, mi16 = tcorner.ifft_corner_y(tdr, tdi, tabs, conjugated=conjugated)
    got = wk.ifft_epilogue(mr16, mi16, tabs, torch.from_numpy(planes),
                           center, "nchw").numpy()
    jt = jcorner.ifft_corner_real(jnp.asarray(dr), jnp.asarray(di), H, W,
                                  jcorner.dft_tables_device(H, Ky, W, Kx),
                                  jcorner.precision())
    jt = jspectral.apply_center(jt, center)
    want = jnp.clip(jnp.floor(jnp.asarray(planes, jnp.float32) + jt + 0.5),
                    0.0, 255.0).astype(jnp.uint8)
    diff = got.astype(np.int16) - np.asarray(want).astype(np.int16)
    n_off = int(np.count_nonzero(diff))
    record_property("bytes_off", n_off)
    print(f"{grid} conjugated {conjugated}: {n_off} of {diff.size} bytes "
          f"off")
    assert got.shape == want.shape
    assert np.abs(diff).max() <= 1
    assert n_off <= K4_FRAC * diff.size
    assert (got == 0).any() and (got == 255).any()


def _tma_box(buf, ld, Ky, Kx, x0, y0, p, box=64):
    """A 3-D TMA box (x0..x0+63, y0..y0+63, plane p) read from the flat
    storage buf of (P, Ky, ld) rows as K6's maps do: x extent Kx, y extent
    Ky, strides (ld, Ky*ld); what lies outside reads as 0."""
    out = np.zeros((box, box), np.float32)
    for dy in range(box):
        y = y0 + dy
        if y >= Ky:
            break
        xs = np.arange(x0, min(x0 + box, Kx))
        out[dy, :len(xs)] = buf[p * Ky * ld + y * ld + xs]
    return out


@pytest.mark.parametrize("grid", GRIDS)
def test_kernel_operand_algebra(grid):
    """The kernel's arithmetic, emulated in numpy f32 on the plain
    operands: ifft_y_table is [[eyr^T, -eyi^T], [eyi^T, eyr^T]] zero-padded
    to (2Hp, 2Kyp); the k-blocks of 64 read dcr below Kyp and dci above it
    (two maps, rows past Ky as zeros), and their per-block f32 products
    summed in k order give rows [0, H) = mr and [Hp, Hp + H) = mi of the
    plain sums within 1e-5 of their scale, the padding rows zero; the
    epilogue's row split (A row m -> mr row p*H + m, or mi row p*H + m - Hp,
    padding rows skipped) fills the (P*H, Kx) outputs, whose bf16 casts
    stand to the plain bf16 outputs as bf16_compare allows; and the
    operands as
    ifft_y_rows hands them to the maps (a staging copy with padded rows
    where Kx % 8 != 0) give the same boxes."""
    B, H, W = grid
    dr, di, _, (Ky, Kx) = _delta(B, H, W, 3 * sum(grid))
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    assert tabs.ifft_y is None                  # built on CUDA devices only
    dcr, dci = wk.ifft_operands_of(torch.from_numpy(dr), torch.from_numpy(di))
    P = 3 * B
    Hp, Kyp = -(-H // 64) * 64, -(-Ky // 64) * 64
    table = tcorner.ifft_y_table(tabs.eyr16, tabs.eyi16)
    assert table.dtype == torch.bfloat16 and table.is_contiguous()
    assert table.shape == (2 * Hp, 2 * Kyp)
    A = table.float().numpy()
    eyr, eyi = tabs.eyr16.float().numpy().T, tabs.eyi16.float().numpy().T
    np.testing.assert_array_equal(A[:H, :Ky], eyr)
    np.testing.assert_array_equal(A[:H, Kyp:Kyp + Ky], -eyi)
    np.testing.assert_array_equal(A[Hp:Hp + H, :Ky], eyi)
    np.testing.assert_array_equal(A[Hp:Hp + H, Kyp:Kyp + Ky], eyr)
    pad = np.ones_like(A, dtype=bool)
    for r0, c0 in ((0, 0), (0, Kyp), (Hp, 0), (Hp, Kyp)):
        pad[r0:r0 + H, c0:c0 + Ky] = False
    assert not A[pad].any()
    # the operands as the maps see them (ifft_y_rows), and their boxes
    rows = wk.ifft_y_rows(dcr.reshape(P, Ky, Kx), dci.reshape(P, Ky, Kx))
    sr, si, ldd, padded = rows
    assert ldd % 8 == 0 and Kx <= ldd < Kx + 8
    assert padded == (Kx % 8 != 0)
    assert sr.shape == (P, Ky, ldd) and sr.is_contiguous()
    bufs = [t.float().numpy().reshape(-1) for t in (sr, si)]
    nky, nkb = Kyp // 64, 2 * Kyp // 64
    mr_p, mi_p = wk.ifft_y_plain(dcr, dci, tabs, values=True)
    mr16_p, mi16_p = wk.ifft_y_plain(dcr, dci, tabs)
    out = [np.full((P * H, Kx), np.nan, np.float32) for _ in range(2)]
    n_nt = -(-Kx // 256)
    for p in range(P):
        acc = np.zeros((2 * Hp, n_nt * 256), np.float32)
        for kb in range(nkb):
            buf = bufs[0] if kb < nky else bufs[1]
            y0 = (kb % nky) * 64
            blk = np.concatenate([_tma_box(buf, ldd, Ky, Kx, x0, y0, p)
                                  for x0 in range(0, n_nt * 256, 64)], 1)
            acc += A[:, kb * 64:kb * 64 + 64] @ blk
        assert not acc[:, Kx:].any()
        assert not acc[H:Hp].any() and not acc[Hp + H:].any()
        # the epilogue's row split, row by row of A
        for m in range(2 * Hp):
            is_mi = m >= Hp
            h = m - Hp if is_mi else m
            if h < H:
                out[int(is_mi)][p * H + h] = acc[m, :Kx]
    assert not np.isnan(out[0]).any() and not np.isnan(out[1]).any()
    scale = max(np.abs(mr_p.numpy()).max(), np.abs(mi_p.numpy()).max())
    for o, ref, ref16 in ((out[0], mr_p, mr16_p), (out[1], mi_p, mi16_p)):
        assert np.abs(o - ref.numpy()).max() <= REL * scale
        cmp = wk.bf16_compare(torch.from_numpy(o).to(torch.bfloat16), ref16,
                              ref, REL * scale)
        assert cmp["other"] == 0


def _cu_consts(name):
    """The integer and bool constexprs of csrc/`name` given as literals."""
    import re

    text = open(wk.__file__.rsplit("/spectral/", 1)[0] + "/csrc/"
                + name).read()
    return {k: {"true": 1, "false": 0}.get(v, None) if v in ("true", "false")
            else int(v) for k, v in re.findall(
                r"constexpr (?:int|bool) (\w+) = (\d+|true|false);", text)}


K6 = _cu_consts("corner_ifft_y.cu")
# the card grids (chip_smoke.py 3c-3e) and a grid below 256 columns
WALK_GRIDS = [(2160, 3840), (1080, 1920), (512, 512), (256, 256),
              (1079, 1917), (2160, 3839), (1170, 2532), (64, 50)]


def _k6_tile(tile, n_mt, n_nt):
    """csrc/corner_ifft_y.cu's tile_of: (p, mt, nt) of a tile index."""
    nt, u = tile % n_nt, tile // n_nt
    return u // n_mt, u % n_mt, nt


@pytest.mark.parametrize("P", [3, 6])
@pytest.mark.parametrize("grid", WALK_GRIDS)
def test_k6_tile_walk(grid, P):
    """The kernel's walk at the card grids' corners (3 or 6 planes): the
    blocks' strided walk computes every (plane, row block, column block)
    tile exactly once, at the card's grid (a block per SM, at most one per
    tile) and at a small one; each stage receives the A box and the delta
    boxes that hold a column below Kx, the bytes its barrier expects; and
    the staged epilogue's TMA boxes (64 rows of one warpgroup, 64 columns,
    clipped to H rows and Kx columns by the maps) write each element of
    mr16 and mi16 once and start on no padding row (a 128-row tile may
    span the mr / mi split where 2Hp/128 is odd, a warpgroup never)."""
    H, W = grid
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    BM, BN, BK, BOX = K6["BM"], K6["BN"], K6["BK"], K6["BOX"]
    assert (BM, BN, BK, BOX) == (128, 256, 64, 64)
    Hp, Kyp = -(-H // 64) * 64, -(-Ky // 64) * 64
    n_mt, n_nt = 2 * Hp // BM, -(-Kx // BN)
    n_tiles = P * n_mt * n_nt
    for blocks in (min(132, n_tiles), 5):
        seen = {}
        stored = np.zeros((2, P * H, Kx), np.int32)
        for b in range(blocks):
            for tile in range(b, n_tiles, blocks):
                p, mt, nt = _k6_tile(tile, n_mt, n_nt)
                seen[p, mt, nt] = seen.get((p, mt, nt), 0) + 1
                n0 = nt * BN
                boxes = min(BN // BOX, -(-(Kx - n0) // BOX))
                loaded = [x for x in range(n0, n0 + BN, BOX) if x < Kx]
                assert len(loaded) == boxes
                for wg in range(2):
                    m0 = mt * BM + wg * 64
                    is_mi = m0 >= Hp
                    h0 = m0 - Hp if is_mi else m0
                    assert h0 < H               # a box starts on a real row
                    rows = np.arange(h0, min(h0 + 64, H)) + p * H
                    for x0 in loaded:
                        stored[int(is_mi), rows, x0:min(x0 + BOX, Kx)] += 1
        assert seen == dict.fromkeys(
            [(p, mt, nt) for p in range(P) for mt in range(n_mt)
             for nt in range(n_nt)], 1)
        assert (stored == 1).all()


def test_bf16_steps_and_compare():
    """bf16_steps: 0 for equal values (+0 and -0 included), 1 for
    neighbours on either side of a power of two and across 0 at the
    smallest subnormals, more for values further apart; bf16_compare
    counts further values as within the f32 bound only where they lie
    within it and one ulp."""
    one_up = torch.tensor(1.0, dtype=torch.bfloat16).view(torch.int16) + 1
    tiny = torch.tensor(1, dtype=torch.int16).view(torch.bfloat16)
    a = torch.tensor([1.0, 0.0, -0.0, 2.0, 3.0], dtype=torch.bfloat16)
    b = torch.stack([one_up.view(torch.bfloat16), torch.tensor(
        -0.0, dtype=torch.bfloat16), tiny, torch.tensor(
        1.9921875, dtype=torch.bfloat16), torch.tensor(
        3.03125, dtype=torch.bfloat16)])
    assert wk.bf16_steps(a, b).tolist() == [1, 0, 1, 1, 2]
    assert wk.bf16_steps(-tiny.reshape(1), tiny.reshape(1)).tolist() == [2]
    got = torch.tensor([1.0, 100.0, 3.0, 1e5, 2.0], dtype=torch.bfloat16)
    want = torch.tensor([1.0, 101.0, 5.0, 1e5 + 1024, 2.015625],
                        dtype=torch.bfloat16)
    assert wk.bf16_compare(got, want, want.float(), 1.5) == {
        "equal": 1, "one ulp": 1, "within the f32 bound": 1, "other": 2}


def test_ifft_y_rejects_bad_inputs():
    """Wrong dtypes, shapes, tables and mixed devices raise, on the CPU as
    on the card; nothing is launched."""
    dr, di, _, (Ky, Kx) = _delta(1, 64, 64, 5)
    tabs = tcorner.dft_tables_device(64, Ky, 64, Kx, "cpu")
    dcr, dci = wk.ifft_operands_of(torch.from_numpy(dr), torch.from_numpy(di))
    before = dict(wk.LAUNCHES)
    meta = torch.empty(dci.shape, dtype=torch.bfloat16, device="meta")
    for bad, match in (
            ((dcr.float(), dci, tabs), "dcr16"),
            ((dcr, dci.float(), tabs), "dci16"),
            ((dcr, dci[..., :-1].contiguous(), tabs), "dci16"),
            ((dcr.transpose(-1, -2), dci, tabs), "dcr16"),
            ((dcr[0, 0, 0], dci, tabs), "dcr16"),
            ((dcr, dci, tabs._replace(eyr16=tabs.eyr16[:-1])), "eyr16"),
            ((dcr, dci, tabs._replace(eyi16=tabs.eyi16[:, :-1])), "eyi16"),
            ((dcr, dci, tabs._replace(eyr16=tabs.eyr)), "eyr16"),
            ((dcr, meta, tabs), "tensors on")):
        with pytest.raises(ValueError, match=match):
            wk.ifft_y(*bad)
    m = torch.empty(dcr.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.ifft_y(m, m, tabs._replace(eyr16=tabs.eyr16.to("meta"),
                                      eyi16=tabs.eyi16.to("meta")))
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("mode", ["mix_adaptive", "highest"])
def test_embed_cores_take_k6_or_the_f32_chain(mode, monkeypatch):
    """Every corner embed core (the shared walk through K3's write_floor,
    QIM, per-image walks) runs its y-stage through ifft_y (K6's wrapper),
    once, on bf16 operands, under mix_adaptive (the f32 deltas of QIM and
    per-image walks cast to bf16(dr), bf16(-di) first), and the f32 chain
    (corner._ifft_y under highest, inside ifft_corner_real) under
    highest, where ifft_y never runs."""
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    calls = []
    real_y, real_chain = wk.ifft_y, tcorner._ifft_y

    def counted_y(dcr, dci, tabs, **kw):
        calls.append(("ifft_y", dcr.dtype, dci.dtype))
        return real_y(dcr, dci, tabs, **kw)

    def counted_chain(dr, di, tabs, m, conjugated):
        calls.append(("chain", m))
        return real_chain(dr, di, tabs, m, conjugated)

    monkeypatch.setattr(wk, "ifft_y", counted_y)
    monkeypatch.setattr(tcorner, "_ifft_y", counted_chain)
    H, W, nb, n = 128, 192, 2, 1024
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(91)
    imgs = torch.from_numpy(rng.integers(0, 256, (nb, 3, H, W),
                                         dtype=np.uint8))
    flat = rng.choice(3 * Ky * Kx, n, replace=False)
    idx = np.unravel_index(flat, (3, Ky, Kx))
    t_idx = [torch.from_numpy(a) for a in idx]
    maps = tpb.corner_statics_core(*t_idx, Ky, Kx, n)
    qmaps = tpb.corner_statics_core(
        *t_idx, Ky, Kx, n, dither=torch.from_numpy(
            rng.uniform(-np.pi, np.pi, n).astype(np.float32)))
    frame = torch.from_numpy(rng.integers(0, 2, (nb, n), dtype=np.uint8))
    kw = dict(Ky=Ky, Kx=Kx, center=False, layout="nchw", floor=0.45)
    outs = [tpb.corner_embed_core(imgs, frame, maps, 0.5, **kw),
            tpb.corner_embed_core(imgs, frame, qmaps, 0.5, qim_levels=3,
                                  **kw)]
    per = [torch.from_numpy(np.stack([a] * nb)) for a in idx]
    jit = torch.zeros((nb, n), dtype=torch.float32)
    outs.append(tpb.corner_piw_embed_core(imgs, frame, *per, jit, 0.5, **kw))
    if mode == "mix_adaptive":
        # the plain version (CPU tensors) runs the eager chain inside
        y = ("ifft_y", torch.bfloat16, torch.bfloat16)
        assert calls == [y, ("chain", "mix_adaptive")] * 3
    else:
        assert calls == [("chain", "highest")] * 3
    for out in outs:
        assert out.shape == imgs.shape and out.dtype == torch.uint8


def test_k6_ablation_edits_apply_to_the_committed_source(monkeypatch):
    """Each variant of tools/k6_ablation_torch.py is a few text edits of
    csrc/corner_ifft_y.cu (among them the staged stores turned off): each
    text it replaces is there, once; --parent may be
    given more than once; and the tool refuses to run without a card (made
    to see none here, so that it never builds or launches anything)."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "k6_ablation_torch", repo / "tools" / "k6_ablation_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (repo / "steganosaurus_tpu_torch" / "csrc"
           / "corner_ifft_y.cu").read_text()
    names = [name for name, _, _ in tool.VARIANTS]
    assert {"no epilogue", "operands loaded once", "register stores",
            "wait_group 0"} <= set(names)
    for name, _, edits in tool.VARIANTS:
        for old, new in edits:
            assert src.count(old) == 1, name
            assert old != new
    assert tool._args(["--parent", "a", "out.txt", "--parent", "b"]) == (
        ["a", "b"], ["out.txt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
