"""The embed's write, write floor and u8 epilogue of the torch port
(spectral/write_kernels.py: the plain versions of the K3 and K4e kernels)
against the JAX package's math (steganosaurus_tpu.spectral.corner
write_delta, write_delta_qim, apply_write_floor, and corner_embed_core's
epilogue expression), the K3 kernel's blocked reduction emulated in numpy
(and the ordered twin, its torch version, bit-equal to the emulation),
the embed cores against the eager composition the kernels replaced, and the
kernels' byte counts in utils/cost.py.

Inputs are numpy arrays made from a seed and handed to both packages, at a
B=3, 3 x 64 x 64 corner (the epilogue at 384x640). Tolerances: the write
and the boosted write within 1e-5 of the output's scale, and the boost b
within 1e-5 relative (the same f32 products; the three per-image sums in
another order, torch against XLA); the u8 epilogue byte-equal. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

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
from steganosaurus_tpu_torch.utils import cost

torch.set_num_threads(2)

B, KY, KX = 3, 64, 64
BUCKET = 4096
NBITS = 3000
REL = 1e-5
ALPHA = np.float32(Params().alpha)
# floors: none, the default, one that boosts every image, one that clips
# every boost at 32
FLOORS = {"0": 0.0, "0.45": Params().write_floor, "boost": 6.0,
          "clip": 1e4}


def _inputs(seed, Ky=KY, Kx=KX, nb=B):
    """cr, ci (nb, 3, Ky, Kx) f32 with a weak first image; a slot map pos
    (3, Ky, Kx) int32 with NBITS walk bins (slots in [0, BUCKET)) and
    `BUCKET` elsewhere; frame bits (nb, BUCKET) u8; jitter angles and
    per-bin amplitudes (3, Ky, Kx) f32."""
    rng = np.random.default_rng(seed)
    cr = (rng.normal(size=(nb, 3, Ky, Kx)) * 1e4).astype(np.float32)
    ci = (rng.normal(size=(nb, 3, Ky, Kx)) * 1e4).astype(np.float32)
    cr[0] *= 1e-3
    ci[0] *= 1e-3
    pos = np.full(3 * Ky * Kx, BUCKET, np.int32)
    bins = rng.choice(3 * Ky * Kx, NBITS, replace=False)
    pos[bins] = rng.choice(BUCKET, NBITS, replace=False)
    frame = rng.integers(0, 2, (nb, BUCKET), dtype=np.uint8)
    jd = rng.uniform(-0.3, 0.3, (3, Ky, Kx)).astype(np.float32)
    al = (ALPHA * rng.uniform(0.5, 1.5, (3, Ky, Kx))).astype(np.float32)
    return cr, ci, pos.reshape(3, Ky, Kx), frame, jd, al


def _sign_mask(pos, frame):
    """The JAX core's bit lookup, in numpy: the sentinel slot reads 0."""
    table = np.concatenate([frame, np.zeros((frame.shape[0], 1), np.uint8)],
                           axis=1)
    sign = table[:, pos.reshape(-1)].reshape(-1, *pos.shape) * 2.0 - 1.0
    return sign.astype(np.float32), (pos < frame.shape[1]).astype(np.float32)


def _boost_of(br, bi, dr, di, cr, ci):
    """Each image's boost b from a floor's output: at a moved bin D_b + 2C
    = b (D + 2C), so b is the median of that ratio over the image's moved
    bins (f64), or 1 where no bin moved."""
    out = []
    for k in range(br.shape[0]):
        num = np.hypot(br[k] + 2.0 * cr[k], bi[k] + 2.0 * ci[k],
                       dtype=np.float64)
        den = np.hypot(dr[k] + 2.0 * cr[k], di[k] + 2.0 * ci[k],
                       dtype=np.float64)
        moved = (dr[k] != 0) | (di[k] != 0)
        moved &= den > 1e-3 * den.max()
        out.append(float(np.median(num[moved] / den[moved]))
                   if moved.any() else 1.0)
    return np.array(out)


def _close(got, want, what):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


WRITE_CASES = [
    ("hard", "0"), ("hard", "0.45"), ("hard", "boost"), ("hard", "clip"),
    ("soft", "0.45"), ("soft", "boost"),
    ("jitter", "0.45"), ("jitter", "boost"), ("soft+jitter", "boost"),
    ("spread", "0.45"), ("spread", "boost"), ("spread+jitter+soft", "0.45"),
]


@pytest.mark.parametrize("mode,floor", WRITE_CASES)
def test_write_floor_plain_matches_jax(mode, floor):
    """write_floor_plain (the bit lookup, write_delta, apply_write_floor)
    against JAX's write_delta + apply_write_floor fed the same lookup: dr/di
    within 1e-5 of their scale, b within 1e-5 relative; b == 1 exactly
    where the floor leaves the write alone, and then the output is the
    write itself, bit for bit."""
    cr, ci, pos, frame, jd, al = _inputs(20 + WRITE_CASES.index((mode,
                                                                floor)))
    soft = "soft" in mode
    jit = "jitter" in mode
    if "spread" in mode:
        ca, sa = np.cos(al), np.sin(al)
        tca, tsa = torch.from_numpy(ca), torch.from_numpy(sa)
    else:
        ca, sa = np.cos(ALPHA), np.sin(ALPHA)
        tca, tsa = tpb._cos_sin(float(ALPHA))
        assert float(tca) == float(ca) and float(tsa) == float(sa)
    cjd, sjd = (np.cos(jd), np.sin(jd)) if jit else (None, None)
    fl = FLOORS[floor]
    pix = float(384 * 640)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    dr, di, b = wk.write_floor_plain(
        t(cr), t(ci), t(pos), t(frame), tca, tsa, t(cjd), t(sjd), floor=fl,
        img_pixels=pix, soft=soft)
    sign, mask = _sign_mask(pos, frame)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jdr, jdi = jcorner.write_delta(j(cr), j(ci), j(sign), j(mask),
                                   j(np.float32(ca)), j(np.float32(sa)),
                                   j(cjd), j(sjd), soft=soft)
    wr, wi = wk.write_floor_plain(
        t(cr), t(ci), t(pos), t(frame), tca, tsa, t(cjd), t(sjd), floor=0.0,
        img_pixels=pix, soft=soft)[:2]
    _close(wr.numpy(), np.asarray(jdr), "write re")
    _close(wi.numpy(), np.asarray(jdi), "write im")
    if not fl:
        assert b is None
        return
    jbr, jbi = jcorner.apply_write_floor(jdr, jdi, j(cr), j(ci), fl, pix)
    _close(dr.numpy(), np.asarray(jbr), "boosted re")
    _close(di.numpy(), np.asarray(jbi), "boosted im")
    b = b.numpy()
    want = _boost_of(*(np.asarray(a) for a in (jbr, jbi, jdr, jdi)), cr, ci)
    np.testing.assert_allclose(b, want, rtol=REL)
    one = b == 1.0
    for k in np.flatnonzero(one):
        assert torch.equal(dr[k], wr[k]) and torch.equal(di[k], wi[k])
        assert np.array_equal(np.asarray(jbr)[k], np.asarray(jdr)[k])
    if floor == "0.45":
        assert one[1:].all()               # the strong covers clear it
    elif floor == "boost":                 # the weak cover may clip
        assert (b > 1.0).all() and (b[1:] < 32.0).all()
    elif floor == "clip":
        assert (b == 32.0).all()


def _bits16(t):
    """A bf16 tensor's bit patterns (int16), for bit-for-bit comparison."""
    assert t.dtype == torch.bfloat16
    return t.view(torch.int16)


@pytest.mark.parametrize("mode,floor", WRITE_CASES)
def test_write_floor_ifft_operands_on_cpu(mode, floor):
    """The wrapper's bf16 mode (ifft_operands=True) on CPU tensors returns
    the plain version's f32 output cast as _mm_bf16 casts it, bf16(dr) and
    bf16(-di), bit for bit, with the same boost; and counts no launch."""
    cr, ci, pos, frame, jd, al = _inputs(90 + WRITE_CASES.index((mode,
                                                                floor)))
    if "spread" in mode:
        ca, sa = torch.from_numpy(np.cos(al)), torch.from_numpy(np.sin(al))
    else:
        ca, sa = tpb._cos_sin(float(ALPHA))
    jit = "jitter" in mode
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    args = (t(cr), t(ci), t(pos), t(frame), ca, sa,
            t(np.cos(jd)) if jit else None, t(np.sin(jd)) if jit else None)
    kw = dict(floor=FLOORS[floor], img_pixels=float(384 * 640),
              soft="soft" in mode)
    dr, di, b = wk.write_floor_plain(*args, **kw)
    before = dict(wk.LAUNCHES)
    gr, gi, gb = wk.write_floor(*args, **kw, ifft_operands=True)
    assert wk.LAUNCHES == before
    assert gr.shape == dr.shape and gi.shape == di.shape
    assert torch.equal(_bits16(gr), _bits16(dr.to(torch.bfloat16)))
    assert torch.equal(_bits16(gi), _bits16((-di).to(torch.bfloat16)))
    assert (gb is None) == (b is None)
    if b is not None:
        assert torch.equal(gb, b)
    # the f32 mode is the plain version itself
    fr, fi, _ = wk.write_floor(*args, **kw)
    assert torch.equal(fr, dr) and torch.equal(fi, di)


@pytest.mark.parametrize("H,W", [(384, 640), (128, 128)])
def test_ifft_of_conjugated_bf16_operands_equals_the_f32_call(H, W):
    """ifft_corner_real given the inverse DFT's operands, bf16(dr) and
    bf16(-di) with conjugated=True, computes under mix_adaptive what it
    computes from the f32 delta, bit for bit: the negation and the casts it
    leaves out are the ones _mm_bf16 made."""
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(H + W)
    dr = torch.from_numpy((rng.normal(size=(2, 3, Ky, Kx)) * 1e4)
                          .astype(np.float32))
    di = torch.from_numpy((rng.normal(size=(2, 3, Ky, Kx)) * 1e4)
                          .astype(np.float32))
    dr[:, :, ::3] = 0.0                    # unwalked bins, signed zeros too
    di[:, :, ::3] = -0.0
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    for scale in (True, False):
        want = tcorner.ifft_corner_real(dr, di, H, W, tabs, "mix_adaptive",
                                        scale=scale)
        got = tcorner.ifft_corner_real(*wk.ifft_operands_of(dr, di), H, W,
                                       tabs, "mix_adaptive", scale=scale,
                                       conjugated=True)
        assert got.dtype == torch.float32 and got.shape == (2, 3, H, W)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # conjugated f32 operands under highest: the same as the f32 call
    want = tcorner.ifft_corner_real(dr, di, H, W, tabs, "highest")
    got = tcorner.ifft_corner_real(dr, -di, H, W, tabs, "highest",
                                   conjugated=True)
    assert torch.equal(got, want)


def _rep_rule_bits(words, stream_bytes, bucket):
    """The K3 kernel's bit of each slot of a RepFrame (stream_bit in
    csrc/corner_write_floor.cu), in numpy: header bit slot/3 below slot 912,
    payload bit 304 + (slot - 912)/7 below the frame's end, else the last
    bit; bit i is bit 31 - i%32 of word i/32."""
    nbits = 8 * stream_bytes
    nmax = 912 + 7 * (nbits - 304)
    p = np.arange(bucket)
    i = np.where(p < 912, p // 3,
                 np.where(p < nmax, 304 + (p - 912) // 7, nbits - 1))
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[:, i >> 5] >> (31 - (i & 31))) & 1).astype(np.uint8)


@pytest.mark.parametrize("stream_bytes,bucket", [
    (138, 6512), (138, 8192), (94, BUCKET), (16438, 921600)])
def test_rep_frame_rule_matches_frame_from_words(stream_bytes, bucket):
    """The kernel's slot -> stream bit rule for a RepFrame gives the frame
    _frame_from_words builds (RepFrame.bits()), slot for slot: a frame
    that fills its bucket, one whose last bit repeats to the bucket's end,
    and the 4K headline's 16 KB frame; and the CPU wrapper writes the same
    delta from either form."""
    rng = np.random.default_rng(stream_bytes + bucket)
    words = rng.integers(-2 ** 31, 2 ** 31, (3, -(-stream_bytes // 4)),
                         dtype=np.int64).astype(np.int32)
    rep = wk.RepFrame(torch.from_numpy(words), stream_bytes, bucket)
    want = rep.bits().numpy()
    assert want.shape == (3, bucket) and wk.frame_bits(rep).shape == \
        (3, bucket)
    np.testing.assert_array_equal(_rep_rule_bits(words, stream_bytes,
                                                 bucket), want)
    if bucket != BUCKET:
        return
    cr, ci, pos, _, _, _ = _inputs(95)
    args = (torch.from_numpy(cr), torch.from_numpy(ci), torch.from_numpy(pos))
    kw = dict(floor=FLOORS["boost"], img_pixels=float(384 * 640))
    ca, sa = tpb._cos_sin(float(ALPHA))
    got = wk.write_floor(*args, rep, ca, sa, **kw, ifft_operands=True)
    ref = wk.write_floor(*args, rep.bits(), ca, sa, **kw, ifft_operands=True)
    assert all(torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, r.view(torch.int16)
                           if r.dtype == torch.bfloat16 else r)
               for g, r in zip(got, ref))


@pytest.mark.parametrize("floor", ["0.45", "boost"])
@pytest.mark.parametrize("soft", [False, True])
def test_floor_only_plain_matches_jax_on_the_qim_write(floor, soft):
    """The QIM write stays eager; floor_only_plain boosts it as JAX's
    write_delta_qim + apply_write_floor do."""
    cr, ci, pos, frame, jd, _ = _inputs(40 + soft)
    rng = np.random.default_rng(41)
    L = 3
    qm = ((pos < BUCKET) & (pos >= 912)).astype(np.float32)
    dq = rng.uniform(-np.pi, np.pi, pos.shape).astype(np.float32) * qm
    sign, mask = _sign_mask(pos, frame)
    ca, sa = np.cos(ALPHA), np.sin(ALPHA)
    fl, pix = FLOORS[floor], float(384 * 640)
    t = [torch.from_numpy(a) for a in (cr, ci, sign, mask, qm, dq)]
    dr, di = tcorner.write_delta_qim(t[0], t[1], t[2], t[3], t[4],
                                     torch.tensor(ca), torch.tensor(sa), t[5],
                                     L, soft=soft)
    br, bi, b = wk.floor_only_plain(dr, di, t[0], t[1], floor=fl,
                                    img_pixels=pix)
    jdr, jdi = jcorner.write_delta_qim(
        *map(jnp.asarray, (cr, ci, sign, mask, qm)), jnp.float32(ca),
        jnp.float32(sa), jnp.asarray(dq), L, soft=soft)
    jbr, jbi = jcorner.apply_write_floor(jdr, jdi, jnp.asarray(cr),
                                         jnp.asarray(ci), fl, pix)
    _close(br.numpy(), np.asarray(jbr), "boosted re")
    _close(bi.numpy(), np.asarray(jbi), "boosted im")
    want = _boost_of(*(np.asarray(a) for a in (jbr, jbi, jdr, jdi)), cr, ci)
    np.testing.assert_allclose(b.numpy(), want, rtol=REL)
    assert (b > 1.0).any()
    # the wrapper takes the plain version for CPU tensors, and counts none
    before = dict(wk.LAUNCHES)
    got = wk.floor_only(dr, di, t[0], t[1], floor=fl, img_pixels=pix)
    assert all(torch.equal(g, w) for g, w in zip(got, (br, bi, b)))
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("center", [False, True])
def test_epilogue_plain_matches_jax(center, layout):
    """epilogue_plain against JAX's: ifft_corner_real's 1/(H*W) scale,
    apply_center, clip(floor(planes + t + 0.5), 0, 255), u8, the NHWC
    transpose: the same bytes. t is left as it was."""
    H, W = 384, 640
    rng = np.random.default_rng(50 + 2 * center + (layout == "nhwc"))
    t = (rng.normal(size=(B, 3, H, W)) * 3.0 * H * W).astype(np.float32)
    planes = rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)
    planes[0, 0, :8] = 0                 # the clamp at both ends
    planes[0, 1, :8] = 255
    tt = torch.from_numpy(t.copy())
    got = wk.epilogue_plain(tt, torch.from_numpy(planes), center, layout)
    assert np.array_equal(tt.numpy(), t)
    js = jnp.asarray(t) * jnp.float32(1.0 / (H * W))
    js = jspectral.apply_center(js, center)
    want = jnp.clip(jnp.floor(jnp.asarray(planes, jnp.float32) + js + 0.5),
                    0.0, 255.0).astype(jnp.uint8)
    if layout != "nchw":
        want = jnp.transpose(want, (0, 2, 3, 1))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any() and (got.numpy() == 255).any()
    before = dict(wk.LAUNCHES)
    assert torch.equal(wk.epilogue(torch.from_numpy(t),
                                   torch.from_numpy(planes), center, layout),
                       got)
    assert wk.LAUNCHES == before


# --- the kernel's reduction --------------------------------------------------

def _f32(a):
    return np.asarray(a, np.float32)


def _block_tree(v):
    """K3's block_sum over the last axis (THREADS values): a warp tree
    (__shfl_down_sync 16, 8, 4, 2, 1; out-of-range lanes keep their own
    value), then the 8 warp sums added in order."""
    w = v.reshape(*v.shape[:-1], wk.THREADS // 32, 32).copy()
    for off in (16, 8, 4, 2, 1):
        w[..., :32 - off] = _f32(w[..., :32 - off] + w[..., off:])
    s = w[..., 0, 0].copy()
    for k in range(1, wk.THREADS // 32):
        s = _f32(s + w[..., k, 0])
    return s


def _emulated_sums(terms):
    """K3's two-pass sum of terms (B, N) f32, in f32: pass 1, thread t of
    block k adds bins k*CHUNK + j*THREADS + t for j in order, then the
    block tree; pass 2, thread t adds partials t, t + THREADS, ... in order,
    then the block tree. Returns (B,)."""
    Bn, N = terms.shape
    nblk = -(-N // wk.CHUNK)
    x = np.zeros((Bn, nblk * wk.CHUNK), np.float32)
    x[:, :N] = terms
    x = x.reshape(Bn, nblk, wk.PER_THREAD, wk.THREADS)
    acc = np.zeros((Bn, nblk, wk.THREADS), np.float32)
    for j in range(wk.PER_THREAD):
        acc = _f32(acc + x[:, :, j])
    part = _block_tree(acc)                                # (B, nblk)
    rounds = -(-nblk // wk.THREADS)
    p = np.zeros((Bn, rounds * wk.THREADS), np.float32)
    p[:, :nblk] = part
    p = p.reshape(Bn, rounds, wk.THREADS)
    acc = np.zeros((Bn, wk.THREADS), np.float32)
    for r in range(rounds):
        acc = _f32(acc + p[:, r])
    return _block_tree(acc)


def _emulated_boost(dr, di, cr, ci, floor, pix):
    """K3's boost: its per-bin terms (the plain version's f32 products),
    its sums, and apply_write_floor's closed form in f32."""
    s = np.float32(1.0 / pix)
    hs = np.float32(0.5) * s
    hr, hi = _f32(hs * dr), _f32(hs * di)
    hh = _f32(_f32(hr * hr) + _f32(hi * hi))
    wm = (hh > 0).astype(np.float32)
    rs, is_ = _f32(cr * s), _f32(ci * s)
    Bn = dr.shape[0]
    v = _f32(wm * _f32(_f32(rs * rs) + _f32(is_ * is_))).reshape(Bn, -1)
    x = _f32(_f32(rs * hr) + _f32(is_ * hi)).reshape(Bn, -1)
    V, X, Hs = (_emulated_sums(a) for a in (v, x, hh.reshape(Bn, -1)))
    e = np.float32(1.5 * floor ** 2)
    vx = _f32(V + X)
    p = _f32(_f32(V + _f32(2 * X)) + Hs)
    disc = np.maximum(_f32(_f32(vx * vx) - _f32(p * _f32(V - e))), 0)
    b = _f32(_f32(vx + np.sqrt(disc)) / np.maximum(p, np.float32(1e-30)))
    return np.clip(b, 1, 32), (V, X, Hs), (v, x, hh.reshape(Bn, -1))


@pytest.mark.parametrize("Ky,Kx,nb", [(64, 50, 3), (1024, 1024, 1)])
def test_kernel_reduction_emulation_matches_torch_sum(Ky, Kx, nb):
    """The K3 kernel's blocked two-pass reduction, emulated in numpy at its
    block size, gives sums within 1e-6 of the exact (f64) ones and a boost
    within 1e-6 relative of the plain version's (torch.sum): at a ragged
    corner (N not a multiple of the block's 4096 bins) and at the 4K
    corner, whose 768 partials per image take three rounds of pass 2."""
    cr, ci, pos, frame, _, _ = _inputs(60 + nb, Ky, Kx, nb)
    fl, pix = FLOORS["boost"], float(2160 * 3840 if Ky == 1024 else 384 * 640)
    tc = [torch.from_numpy(a) for a in (cr, ci, pos, frame)]
    ca, sa = tpb._cos_sin(float(ALPHA))
    dr, di, _ = wk.write_floor_plain(*tc, ca, sa, floor=0.0, img_pixels=pix)
    _, _, b = wk.floor_only_plain(dr, di, tc[0], tc[1], floor=fl,
                                  img_pixels=pix)
    eb, sums, terms = _emulated_boost(dr.numpy(), di.numpy(), cr, ci, fl,
                                      pix)
    for got, t in zip(sums, terms):
        exact = t.astype(np.float64).sum(1)
        scale = np.abs(t.astype(np.float64)).sum(1)
        assert (np.abs(got - exact) <= 1e-6 * scale).all()
    b = b.numpy()
    assert (b > 1.0).any()
    np.testing.assert_allclose(eb, b, rtol=1e-6)


@pytest.mark.parametrize("Ky,Kx,nb", [(64, 50, 3), (1024, 1024, 1)])
def test_ordered_twin_sums_in_the_kernels_order(Ky, Kx, nb):
    """The ordered twin (ordered_sum, the plain versions with ordered=True)
    equals the numpy emulation of K3's reduction bit for bit: each of the
    three sums, the boost b and the boosted write, at the ragged corner and
    at the 4K corner (three rounds of pass 2)."""
    cr, ci, pos, frame, _, _ = _inputs(60 + nb, Ky, Kx, nb)
    fl, pix = FLOORS["boost"], float(2160 * 3840 if Ky == 1024 else 384 * 640)
    tc = [torch.from_numpy(a) for a in (cr, ci, pos, frame)]
    ca, sa = tpb._cos_sin(float(ALPHA))
    dr, di, _ = wk.write_floor_plain(*tc, ca, sa, floor=0.0, img_pixels=pix)
    eb, sums, terms = _emulated_boost(dr.numpy(), di.numpy(), cr, ci, fl,
                                      pix)
    for want, t in zip(sums, terms):
        got = wk.ordered_sum(torch.from_numpy(t))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
    br, bi, b = wk.floor_only_plain(dr, di, tc[0], tc[1], floor=fl,
                                    img_pixels=pix, ordered=True)
    assert (eb > 1.0).any()
    assert b.numpy().tobytes() == eb.astype(np.float32).tobytes()
    wr, wi, wb = wk.write_floor_plain(*tc, ca, sa, floor=fl, img_pixels=pix,
                                      ordered=True)
    assert torch.equal(wb, b) and torch.equal(wr, br) and torch.equal(wi, bi)
    # the boosted write with that b, term by term as apply_write_floor
    bb = torch.from_numpy(eb.astype(np.float32)).reshape(-1, 1, 1, 1)
    wm = torch.from_numpy((terms[2].reshape(dr.shape) > 0).astype(
        np.float32))
    assert torch.equal(br, bb * dr + 2.0 * (bb - 1.0) * wm * tc[0])
    assert torch.equal(bi, bb * di + 2.0 * (bb - 1.0) * wm * tc[1])


def test_kernel_reduction_order_does_not_depend_on_b():
    """The kernel's sums run per image over that image's bins alone: the
    same image alone (B=1) and in batches of 3 and 8 (at other rows) gets
    the same b, bit for bit, in the emulated order, and the same b from the
    plain version. So shards of a batch boost an image alike."""
    Ky, Kx = 64, 50
    cr, ci, pos, frame, _, _ = _inputs(66, Ky, Kx, 8)
    fl, pix = FLOORS["boost"], float(384 * 640)
    ca, sa = tpb._cos_sin(float(ALPHA))
    got = {}
    for nb, row in ((1, 0), (3, 2), (8, 5)):
        idx = [(k + 3) % 8 for k in range(nb)]
        idx[row] = 0                         # image 0 at row `row`
        tc = [torch.from_numpy(np.ascontiguousarray(a[idx]))
              for a in (cr, ci)]
        fr = torch.from_numpy(np.ascontiguousarray(frame[idx]))
        dr, di, _ = wk.write_floor_plain(tc[0], tc[1], torch.from_numpy(pos),
                                         fr, ca, sa, floor=0.0,
                                         img_pixels=pix)
        eb = _emulated_boost(dr.numpy(), di.numpy(), tc[0].numpy(),
                             tc[1].numpy(), fl, pix)[0]
        pb_ = wk.floor_only_plain(dr, di, tc[0], tc[1], floor=fl,
                                  img_pixels=pix)[2].numpy()
        got[nb] = (eb[row], pb_[row])
    assert got[1][0] > 1.0
    assert got[1][0].tobytes() == got[3][0].tobytes() == got[8][0].tobytes()
    assert got[1][1].tobytes() == got[3][1].tobytes() == got[8][1].tobytes()


def test_resident_schedule_takes_only_what_fits():
    """The wrapper's schedule rule: the resident schedule where the card's
    grid for the corner is > 0, N is a multiple of 4 and the spectrum's
    tensors start on 16 bytes; the two-pass schedule otherwise."""
    a = torch.zeros(64)
    assert a.data_ptr() % 16 == 0
    assert wk.resident_fits(3 * 1024 * 1024, 128, (a, a))
    assert not wk.resident_fits(3 * 1024 * 1024, 0, (a, a))
    assert not wk.resident_fits(3 * 37 * 17, 1, (a, a))
    assert not wk.resident_fits(3 * 256 * 256, 48, (a, a[1:]))
    assert wk.SCHEDULES == ("resident", "two_pass")


# --- the embed cores against the composition they replaced -------------------

def _replaced_core(imgs, frame, maps, alpha, *, Ky, Kx, center, layout,
                   floor, soft=False, has_jitter=False, has_spread=False,
                   qim_levels=0):
    """corner_embed_core as it was before the K3 and K4e kernels: the bit
    lookup, write_delta / write_delta_qim, apply_write_floor, the scaled
    inverse DFT and the eager epilogue."""
    planes = tpb._planes_u8(imgs, layout)
    Bn, _, H, W = planes.shape
    pos, cjd, sjd, cad, sad, dq, qm = tpb._unpack_maps(
        maps, has_jitter, has_spread, bool(qim_levels))
    bucket = frame.shape[1]
    mode = tcorner.precision()
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, planes.device)
    cr, ci = tcorner.fwd_corner(planes, center, Ky, Kx, tabs, mode)
    table = torch.cat([frame, frame.new_zeros((Bn, 1))], dim=1)
    bit = table[:, pos.reshape(-1)].reshape(Bn, 3, Ky, Kx)
    sign = bit.to(torch.float32) * 2.0 - 1.0
    mask = (pos < bucket).to(torch.float32)
    ca, sa = tpb._cos_sin(alpha) if cad is None else (cad, sad)
    if qim_levels:
        dr, di = tcorner.write_delta_qim(cr, ci, sign, mask, qm, ca, sa, dq,
                                         qim_levels, cjd, sjd, soft=soft)
    else:
        dr, di = tcorner.write_delta(cr, ci, sign, mask, ca, sa, cjd, sjd,
                                     soft=soft)
    if floor:
        dr, di = tcorner.apply_write_floor(dr, di, cr, ci, floor,
                                           float(H) * float(W))
    t = tcorner.ifft_corner_real(dr, di, H, W, tabs, mode)
    t = tspectral.apply_center(t, center)
    out = t.add_(planes).add_(0.5).floor_().clamp_(0.0, 255.0)
    out = out.to(torch.uint8)
    if layout != "nchw":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


CORE_CASES = {
    "default": dict(),
    "floor 0, center, nhwc": dict(floor=0.0, center=True, layout="nhwc"),
    "soft + jitter": dict(soft=True, has_jitter=True),
    "spread": dict(has_spread=True),
    "qim": dict(qim_levels=3),
    "qim + soft + jitter, boost": dict(qim_levels=4, soft=True,
                                       has_jitter=True, floor=6.0),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_embed_core_equals_the_replaced_composition(case):
    """corner_embed_core through the new wrappers (CPU: their plain
    versions) writes the same stego bytes as the eager composition it
    replaced, in every corner wire mode of a shared walk."""
    kw = dict(floor=Params().write_floor, center=False, layout="nchw")
    kw.update(CORE_CASES[case])
    H, W, nb = 128, 192, 2
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(70 + list(CORE_CASES).index(case))
    imgs = rng.integers(0, 256, (nb, 3, H, W), dtype=np.uint8)
    if kw["layout"] == "nhwc":
        imgs = np.ascontiguousarray(imgs.transpose(0, 2, 3, 1))
    bucket = 4096
    nbits = 1500
    flat = rng.choice(3 * Ky * Kx, bucket, replace=False)
    flat[nbits:] = flat[nbits - 1]           # tail-padded, as the walk is
    plane, y, x = (torch.from_numpy(a) for a in np.unravel_index(
        flat, (3, Ky, Kx)))
    per_slot = lambda lo, hi: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, bucket).astype(np.float32))
    maps = tpb.corner_statics_core(
        plane, y, x, Ky, Kx, bucket,
        per_slot(-0.2, 0.2) if kw.get("has_jitter") else None,
        alphas=per_slot(0.3, 0.7) if kw.get("has_spread") else None,
        dither=per_slot(-3, 3) if kw.get("qim_levels") else None)
    assert maps[0].dtype == torch.int32
    frame = torch.from_numpy(rng.integers(0, 2, (nb, bucket),
                                          dtype=np.uint8))
    args = (torch.from_numpy(imgs), frame, maps, float(ALPHA))
    want = _replaced_core(*args, Ky=Ky, Kx=Kx, **kw)
    before = dict(wk.LAUNCHES)
    got = tpb.corner_embed_core(*args, Ky=Ky, Kx=Kx, **kw)
    assert wk.LAUNCHES == before
    assert got.dtype == torch.uint8 and got.shape == imgs.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("fl,frac", [(0.45, 1e-3), (50.0, 5e-3)])
def test_embed_core_operands_path_equals_f32_and_jax(fl, frac):
    """corner_embed_core under mix_adaptive (K3 storing the inverse DFT's
    bf16 operands, ifft_corner_real taking them as they are) writes the
    bytes of the f32 composition (K3's f32 delta, the negating and casting
    inverse DFT, K4e), at the default floor (b == 1 on these covers) and
    at one that boosts every image; and JAX's corner_embed_core's bytes
    within +-1 on at most `frac` of them: 0.1% as
    tests/test_torch_batch.py (torch's and XLA's bf16 products sum in other
    orders), 0.5% where the boost, whose sums also run in another order,
    scales every write."""
    import jax

    from steganosaurus_tpu.parallel import batch as jpb

    H, W, nb = 128, 192, 3
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(85)
    imgs = rng.integers(0, 256, (nb, 3, H, W), dtype=np.uint8)
    bucket, nbits = 4096, 1500
    flat = rng.choice(3 * Ky * Kx, bucket, replace=False)
    flat[nbits:] = flat[nbits - 1]
    idx = np.unravel_index(flat, (3, Ky, Kx))
    maps = tpb.corner_statics_core(*(torch.from_numpy(a) for a in idx), Ky,
                                   Kx, bucket)
    frame = rng.integers(0, 2, (nb, bucket), dtype=np.uint8)
    kw = dict(Ky=Ky, Kx=Kx, center=False, layout="nchw", floor=fl)
    args = (torch.from_numpy(imgs), torch.from_numpy(frame), maps,
            float(ALPHA))
    got = tpb.corner_embed_core(*args, **kw)
    # the f32 composition, stage by stage
    planes = args[0]
    tabs = tcorner.dft_tables_device(H, Ky, W, Kx, "cpu")
    cr, ci = tcorner.fwd_corner(planes, False, Ky, Kx, tabs, "mix_adaptive")
    dr, di, b = wk.write_floor(cr, ci, maps[0], args[1],
                               *tpb._cos_sin(float(ALPHA)), floor=fl,
                               img_pixels=float(H * W))
    assert (b == 1).all() if fl < 1 else (b > 1).all()
    t = tcorner.ifft_corner_real(dr, di, H, W, tabs, "mix_adaptive",
                                 scale=False)
    want = wk.epilogue(t, planes, False, "nchw")
    assert torch.equal(got, want)
    # JAX's core on the same covers, walk and frame (its batch-packed table)
    table = np.concatenate([np.asarray(jpb._pack_batch_words(
        jnp.asarray(frame))).T, np.zeros((1, 1), np.int32)])
    jfn = jpb.corner_embed_core(H, W, Ky, Kx, False, layout="nchw",
                                floor=fl)
    js = np.asarray(jax.device_get(jfn(jnp.asarray(imgs), jnp.asarray(table),
                                       jnp.asarray(maps[0].numpy()),
                                       jnp.float32(ALPHA))))
    diff = got.numpy().astype(np.int16) - js.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= frac * diff.size


def test_piw_embed_core_equals_the_replaced_composition():
    """corner_piw_embed_core with the floor through floor_only and the
    epilogue through K4e's plain version: the bytes of the eager
    composition (its scatter, apply_write_floor, the scaled inverse DFT and
    the eager epilogue)."""
    H, W, nb, n = 128, 192, 2, 1024
    Ky, Kx = tcorner.corner_dims(H, W, Params().rmax)
    rng = np.random.default_rng(80)
    imgs = torch.from_numpy(rng.integers(0, 256, (nb, 3, H, W),
                                         dtype=np.uint8))
    flat = np.stack([rng.choice(3 * Ky * Kx, n, replace=False)
                     for _ in range(nb)])
    plane, y, x = (torch.from_numpy(a) for a in np.unravel_index(
        flat, (3, Ky, Kx)))
    jit = torch.from_numpy(rng.uniform(-0.2, 0.2, (nb, n)).astype(np.float32))
    frame = torch.from_numpy(rng.integers(0, 2, (nb, n), dtype=np.uint8))
    kw = dict(Ky=Ky, Kx=Kx, center=True, layout="nchw", floor=6.0)
    real = wk.floor_only, wk.epilogue
    got = tpb.corner_piw_embed_core(imgs, frame, plane, y, x, jit,
                                    float(ALPHA), **kw)

    def old_floor(dr, di, cr, ci, *, floor, img_pixels):
        return (*tcorner.apply_write_floor(dr, di, cr, ci, floor,
                                           img_pixels), None)

    def old_epilogue(t, planes, center, layout):
        H, W = t.shape[-2:]
        t = tspectral.apply_center(t * (1.0 / (H * W)), center)
        return t.add_(planes).add_(0.5).floor_().clamp_(0.0, 255.0).to(
            torch.uint8)

    wk.floor_only, wk.epilogue = old_floor, old_epilogue
    try:
        want = tpb.corner_piw_embed_core(imgs, frame, plane, y, x, jit,
                                         float(ALPHA), **kw)
    finally:
        wk.floor_only, wk.epilogue = real
    assert torch.equal(got, want)


def test_wrappers_refuse_other_devices():
    """A device other than the CPU or a CUDA card raises; nothing falls
    back."""
    m = torch.empty((1, 3, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.epilogue(m, torch.empty((1, 3, 4, 4), dtype=torch.uint8,
                                   device="meta"), False, "nchw")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.floor_only(m, m, m, m, floor=0.45, img_pixels=16.0)
    with pytest.raises(ValueError, match="tensors on"):
        wk.floor_only(m, m, torch.zeros((1, 3, 4, 4)), m, floor=0.45,
                      img_pixels=16.0)


def test_k3_ablation_edits_apply_to_the_committed_source():
    """Each variant of tools/k3_ablation_torch.py is one text edit of
    csrc/corner_write_floor.cu: the text it replaces is there, once; and
    the tool refuses to run without a card."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "k3_ablation_torch", repo / "tools" / "k3_ablation_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (repo / "steganosaurus_tpu_torch" / "csrc"
           / "corner_write_floor.cu").read_text()
    assert len(tool.VARIANTS) == 3
    for name, _, old, new in tool.VARIANTS:
        assert src.count(old) == 1, name
        assert old != new
    assert tool.main() == 2


# --- the kernels' bytes ------------------------------------------------------

def test_kernel_costs_at_the_main_shape():
    """write_floor_cost and epilogue_cost at 4K B=64 16 KB: each input read
    once and each output written once, ~3.29e9 and 9.555e9 bytes, ~0.98 and
    2.85 ms at the H100's 3.35 TB/s; the round trip's stage table counts
    the write and the floor as the one K3 launch of the main path (stream
    words in, bf16 operands out), the inverse DFT as the y-stage and K4
    and stage 2 as the prep, the band operand and K2, and the extract's
    read as the 32-byte sectors a uniform walk touches (36.97 ms in
    all)."""
    g = cost._geometry(2160, 3840, 16384, Params())
    assert (g["Ky"], g["Kx"], g["bucket"]) == (1024, 1024, 921600)
    peaks = dict(cost._PEAKS[0][1])
    k3 = cost.write_floor_cost(64, 1024, 1024, g["bucket"], 0)
    E = 3 * 64 * 1024 * 1024
    assert k3["hbm_bytes"] == 4 * E * 4 + 3 * 1024 * 1024 * 4 + 64 * 921600
    ms, by = cost.stage_bound(k3, peaks)
    assert by == "bytes" and ms == pytest.approx(0.9830, abs=1e-3)
    # the main path's bf16 operands: cr, ci read once, the outputs at 2 B
    k3b = cost.write_floor_cost(64, 1024, 1024, g["bucket"], 0, out_bytes=2)
    assert k3b["hbm_bytes"] == 2 * E * 4 + 3 * 1024 * 1024 * 4 \
        + 64 * 921600 + 2 * E * 2
    ms, by = cost.stage_bound(k3b, peaks)
    assert by == "bytes" and ms == pytest.approx(0.7426, abs=1e-3)
    with pytest.raises(ValueError):
        cost.write_floor_cost(1, 8, 8, 16, 0, out_bytes=8)
    # the main path's frame: a RepFrame's stream words, 16,438 B an image
    k3r = cost.write_floor_cost(64, 1024, 1024, g["bucket"], 0, out_bytes=2,
                                stream_bytes=g["stream_bytes"])
    assert g["stream_bytes"] == 16438
    assert k3r["hbm_bytes"] == k3b["hbm_bytes"] - 64 * 921600 \
        + 64 * 4110 * 4
    ms, by = cost.stage_bound(k3r, peaks)
    assert by == "bytes" and ms == pytest.approx(0.7253, abs=1e-3)
    k4 = cost.epilogue_cost(64, 2160, 3840, "nchw")
    assert k4["hbm_bytes"] == 6 * 3 * 64 * 2160 * 3840
    assert cost.epilogue_cost(64, 2160, 3840, "nhwc")["hbm_bytes"] == \
        k4["hbm_bytes"]
    ms, by = cost.stage_bound(k4, peaks)
    assert by == "bytes" and ms == pytest.approx(2.852, abs=1e-3)
    assert cost.write_floor_cost(64, 1024, 1024, 921600, 2)["hbm_bytes"] == \
        k3["hbm_bytes"] + 2 * 3 * 1024 * 1024 * 4
    assert cost.floor_only_cost(64, 1024, 1024)["hbm_bytes"] == 6 * E * 4
    with pytest.raises(ValueError):
        cost.epilogue_cost(1, 8, 8, "hwc")
    rep = cost.roundtrip_cost(64, 2160, 3840, 16384)
    assert [s for s in rep["stages"] if s["stage"].startswith("K3")] == [k3r]
    assert cost.roundtrip_bound(rep, peaks)["roundtrip_ms"] == \
        pytest.approx(36.97, abs=0.01)
