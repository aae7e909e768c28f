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


def test_k4_ablation_edits_apply_to_the_committed_source():
    """Each variant of tools/k4_ablation_torch.py is a few text edits of
    csrc/corner_ifft_epilogue.cu: each text it replaces is there, once; and
    the tool refuses to run without a card."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "k4_ablation_torch", repo / "tools" / "k4_ablation_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (repo / "steganosaurus_tpu_torch" / "csrc"
           / "corner_ifft_epilogue.cu").read_text()
    assert len(tool.VARIANTS) == 6
    for name, _, edits in tool.VARIANTS:
        for old, new in edits:
            assert src.count(old) == 1, name
            assert old != new
    assert tool.main() == 2
