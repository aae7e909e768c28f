"""K5, the extract's walk read and repetition decode
(spectral/read_kernels.py: read_decode and its plain version), on the CPU.

- read_decode_plain, and the three extract cores of parallel/batch.py that
  now read through read_decode, against the eager chain they replaced
  (_walk_decisions, then _decode_sections / _decode_sections_soft /
  _soft_parts / pack_bits_words), word for word: seeded spectra (numpy,
  the forward DFT stubbed out) at a B=3, 3 x 32 x 48 corner with planted
  ties (d = +0.0 and -0.0 read 1), a tiny negative d that rounds to -0.0
  in bf16, a copy group whose sum is exactly zero, partial groups and
  sections whose bit counts are not multiples of 32; every flag of the
  three cores (header 912 or 0, Rep-7 or RS, jitter, bf16 or f32 soft
  rows, raw bits, sign(sin alpha) of +1, -1 and 0).
- The three cores on a 512x512 batch the port embedded, against the JAX
  package's cores (steganosaurus_tpu/parallel/batch.py
  corner_extract_fused_core, corner_soft_extract_core, corner_bits_core +
  corner_gather_raw_core) run on the CPU: the decoded words equal; the raw
  bits equal but where the two packages' forward DFTs (bf16 stages that
  round in other places) put a bin's d on either side of zero, each such
  bin within RAW_NEAR of zero; every secret recovered.
- QIM reads and per-image walks still take the eager chain, counted under
  read_kernels.KERNEL_READ_EAGER; K5 is never counted on the CPU.
- The wrapper's checks, and csrc/corner_read_decode.cu's C signature and
  tile, row and chunk sizes against the wrapper's; the signature
  tools/parent_kernels_torch.py binds a parent's K5 with.
- The kernel's read plan (read_kernels.read_plan) of the 512x512 and
  1080p walks and of a walk with repeated bins: every slot once, the
  offsets sorted, rows of at most ROW_SLOTS slots of one tile, each slot's
  int16 offset in its tile, the rows' unit masks exactly the 32-byte
  sectors their slots touch; a torch emulation of the kernel's two phases
  over the plan (the scratch chunk by chunk of CHUNK_IMAGES images, each
  slot's values taken only from its row's masked units, then the decode
  in slot order) bit-equal to read_decode_plain at B 1, 3, 8 and 9 on
  every flag set of the card's READ_FLAGS, and through the three cores
  equal to the JAX package's; two extract_batch calls under one key build
  one plan, kept in the walk's cache entry, where the kernel reads
  through plans (read_kernels.uses_plan stubbed to say so), and none on
  the CPU.

The kernel itself is held bit-equal to read_decode_plain on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3f).
"""

import dataclasses
import functools
import pathlib
import re
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.parallel import batch as jpb
from steganosaurus_tpu.pipeline import batch as jbatch
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch import _build
from steganosaurus_tpu_torch import spectral as tspectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.parallel import batch as pb
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.spectral import corner
from steganosaurus_tpu_torch.spectral import read_kernels as rk
from steganosaurus_tpu_torch.utils import cost

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
MK = bytes(range(32))
B, KY, KX = 3, 32, 48
HDR = 912
# raw bits of the 512x512 batch: the packages' decision values differ by
# the forward DFTs' bf16 roundings, so a bin whose d lies this close to
# zero (relative to the batch's RMS |d|) may read either bit
RAW_NEAR = 0.05


def jp(p: Params) -> JParams:
    return JParams(**dataclasses.asdict(p))


# --- seeded spectra, the eager chain and the cores --------------------------

def _spectra(seed: int):
    """cr, ci (B, 3, KY, KX) f32 of a seed, scaled as a corner spectrum."""
    rng = np.random.default_rng(seed)
    cr, ci = (torch.from_numpy((rng.normal(size=(B, 3, KY, KX)) * 1e3)
                               .astype(np.float32)) for _ in range(2))
    return cr, ci


def _walk(seed: int, n: int):
    """A shared walk of n distinct corner bins: plane, y, x (n,) int64 and
    jitter angles (n,) f32."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(3 * KY * KX, n, replace=False)
    jit = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    return (torch.from_numpy(flat // (KY * KX)),
            torch.from_numpy(flat // KX % KY), torch.from_numpy(flat % KX),
            torch.from_numpy(jit))


# slots of the walk whose value is planted in every image: +0.0, -0.0, a
# tiny negative that rounds to -0.0 in bf16 (a payload slot of the RS
# cases), and a Rep-3 header group (slots 12-14) whose copies sum to zero
PLANTED = {0: 0.0, 1: -0.0, 2: 0.0, HDR + 8: -1e-42, 12: 3.0, 13: -3.0,
           14: -0.0}


def _plant(ci, plane, y, x, n: int):
    """ci with PLANTED's values at those walk slots below n."""
    ci = ci.clone()
    for s, v in PLANTED.items():
        if s < n:
            ci[:, plane[s], y[s], x[s]] = v
    return ci


def _stubbed(monkeypatch, cr, ci):
    """Stub the forward DFT: the cores read (cr, ci) whatever the images."""
    monkeypatch.setattr(pb, "_spectrum",
                        lambda imgs, **kw: (cr.clone(), ci.clone()))
    return torch.zeros((cr.shape[0], 3, 8, 8), dtype=torch.uint8)


KW = dict(Ky=KY, Kx=KX, center=False, layout="nchw")


def _eager(core: str, imgs, alpha, walk, hdr: int, rep: int, jit):
    """The chain the cores ran before K5, over _walk_decisions' d."""
    plane, y, x = walk
    d = pb._walk_decisions(imgs, alpha, plane, y, x, jit=jit, **KW)
    if core == "fused":
        return (pb._decode_sections((d >= 0).to(torch.uint8), hdr, rep),
                pb._decode_sections_soft(d.to(torch.bfloat16)
                                         .to(torch.float32), hdr, rep))
    if core == "soft":
        words, conf = pb._soft_parts(d, hdr, rep)
        return words if conf is None else (words, conf)
    return bit_ops.pack_bits_words((d >= 0).to(torch.uint8))


def _core(core: str, imgs, alpha, walk, hdr: int, rep: int, jit):
    plane, y, x = walk
    if core == "fused":
        return pb.corner_extract_fused_core(
            imgs, alpha, plane, y, x, hdr_stream_bits=hdr, with_soft=True,
            jit=jit, payload_rep=rep, **KW)
    if core == "soft":
        return pb.corner_soft_extract_core(
            imgs, alpha, plane, y, x, hdr_stream_bits=hdr, jit=jit,
            payload_rep=rep, **KW)
    return pb.corner_raw_bits_core(imgs, alpha, plane, y, x, jit=jit, **KW)


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# (core, header slots, payload rep, payload groups, jitter, alpha): alpha
# 0.5 reads with sign(sin alpha) = +1, -0.5 with -1, 0 with 0
CASES = {
    "main": ("fused", HDR, 7, 200, False, 0.5),
    "no header": ("fused", 0, 7, 200, False, 0.5),
    "rs": ("fused", HDR, 1, 8 * 150, False, 0.5),
    "jitter": ("fused", HDR, 7, 200, True, 0.5),
    "jitter rs": ("fused", HDR, 1, 8 * 150, True, 0.5),
    "ssa -1": ("fused", HDR, 7, 200, False, -0.5),
    "ssa 0": ("fused", HDR, 7, 200, False, 0.0),
    "soft f32": ("soft", HDR, 7, 200, False, 0.5),
    "soft f32 rs": ("soft", HDR, 1, 8 * 150, False, 0.5),
    "soft f32 jitter": ("soft", HDR, 7, 200, True, 0.5),
    "soft f32 ssa -1": ("soft", HDR, 7, 200, False, -0.5),
    "raw bits": ("raw", 0, 1, HDR + 8 * 150, False, 0.5),
    "raw bits jitter": ("raw", 0, 1, HDR + 8 * 150, True, 0.5),
    "raw bits ssa 0": ("raw", 0, 1, HDR + 8 * 150, False, 0.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cores_through_k5_equal_the_eager_chain(monkeypatch, name):
    """Each core, now through read_decode (the plain version on the CPU),
    word for word against the eager chain on the same spectrum, and
    read_decode_plain called directly against the same rows; the kernel
    route counts no eager read (and no K5 launch on the CPU), the eager
    chain one read."""
    core, hdr, rep, groups, jitter, alpha = CASES[name]
    seed = 100 + list(CASES).index(name)
    n = hdr + groups * rep + (3 if rep == 7 else 0)  # a partial group
    plane, y, x, jit = _walk(seed, n)
    cr, ci = _spectra(seed)
    ci = _plant(ci, plane, y, x, n)
    imgs = _stubbed(monkeypatch, cr, ci)
    jit = jit if jitter else None
    before = dict(rk.LAUNCHES)
    got = _core(core, imgs, alpha, (plane, y, x), hdr, rep, jit)
    assert rk.LAUNCHES == before
    want = _eager(core, imgs, alpha, (plane, y, x), hdr, rep, jit)
    assert rk.LAUNCHES[rk.KERNEL_READ_EAGER] == \
        before[rk.KERNEL_READ_EAGER] + 1
    _equal(got, want)
    ssa = pb._sign_sin(alpha)
    assert ssa == {0.5: 1.0, -0.5: -1.0, 0.0: 0.0}[alpha]
    cjd, sjd = (None, None) if jit is None else (torch.cos(jit),
                                                 torch.sin(jit))
    kw = dict(hdr_stream_bits=hdr, payload_rep=rep)
    if core == "raw":
        kw = dict(hdr_stream_bits=0, payload_rep=1)
    soft = {"fused": "bf16", "soft": "f32", "raw": None}[core]
    hard, rows = rk.read_decode_plain(ci, plane, y, x, ssa, cr, cjd, sjd,
                                      soft=soft, **kw)
    if core == "fused":
        _equal((hard, rows), want)
    elif core == "raw":
        _equal(hard, want)
    else:
        hw, pw, _ = rk.row_words(n, hdr, rep)
        words = want if rep == 7 else want[0]
        _equal(rows[:, :hw + pw], words)
        if rep == 1:
            _equal(rows[:, hw + pw:].view(torch.float32), want[1])


def test_ties_and_the_bf16_round_read_as_the_spec_says(monkeypatch):
    """At sign(sin alpha) = +1: the planted +0.0 and -0.0 read 1 (a value
    compare, not the sign bit), the tiny negative reads 0 hard and 1 in the
    bf16 soft row (it rounds to -0.0) and 0 in the f32 one; the Rep-3 group
    3.0, -3.0, -0.0, whose copies sum to exactly +0.0, reads 1 both ways,
    and so does the group +0.0, -0.0, +0.0."""
    n = HDR + 8 * 150
    plane, y, x, _ = _walk(7, n)
    cr, ci = _spectra(7)
    ci = _plant(ci, plane, y, x, n)
    hard, soft16 = rk.read_decode_plain(ci, plane, y, x, 1.0,
                                        hdr_stream_bits=HDR, payload_rep=1,
                                        soft="bf16")
    _, soft32 = rk.read_decode_plain(ci, plane, y, x, 1.0,
                                     hdr_stream_bits=HDR, payload_rep=1,
                                     hard=False, soft="f32")
    raw, _ = rk.read_decode_plain(ci, plane, y, x, 1.0, hdr_stream_bits=0,
                                  payload_rep=1)
    bits = bit_ops.unpack_words_host(raw.numpy(), n)
    assert (bits[:, [0, 1, 2, 14]] == 1).all()
    assert (bits[:, 13] == 0).all() and (bits[:, HDR + 8] == 0).all()
    hw = rk.row_words(n, HDR, 1)[0]

    def payload_bit(rows, k):
        return bit_ops.unpack_words_host(rows[:, hw:].numpy(), k + 1)[:, k]

    assert (payload_bit(hard, 8) == 0).all()
    assert (payload_bit(soft16, 8) == 1).all()
    assert (payload_bit(soft32, 8) == 0).all()
    # header group 4 = slots 12-14: copies 3.0, -3.0, -0.0
    hdr_hard = bit_ops.unpack_words_host(hard[:, :hw].numpy(), 304)
    hdr_soft = bit_ops.unpack_words_host(soft32[:, :hw].numpy(), 304)
    assert (hdr_hard[:, 4] == 1).all() and (hdr_soft[:, 4] == 1).all()
    # group 0 (slots 0-2: +0.0, -0.0, +0.0) reads 1 both ways
    assert (hdr_hard[:, 0] == 1).all() and (hdr_soft[:, 0] == 1).all()


@pytest.mark.parametrize("hdr,rep,pay,soft", [
    (100, 7, 7 * 45 + 3, "bf16"),   # 33 header groups + 1 slot; 45 groups
    (100, 1, 8 * 13, "bf16"),       # 104 payload bits: 4 words, 8 bits used
    (0, 7, 7 * 33, "f32"),          # 33 groups: a second word of one bit
    (HDR, 7, 0, "bf16"),            # a header alone: no payload word
])
def test_partial_groups_and_ragged_sections(hdr, rep, pay, soft):
    """Sections whose groups do not fill their last word, a trailing
    partial group dropped, an empty payload: read_decode_plain equals the
    eager section decode over the same decision values."""
    n = hdr + pay
    plane, y, x, _ = _walk(hdr + pay, n)
    cr, ci = _spectra(hdr + pay)
    d = corner.decision_values(ci[:, plane, y, x], 1.0)
    hard, rows = rk.read_decode_plain(ci, plane, y, x, 1.0,
                                      hdr_stream_bits=hdr, payload_rep=rep,
                                      soft=soft)
    v = d.to(torch.bfloat16).to(torch.float32) if soft == "bf16" else d
    _equal(hard, pb._decode_sections((d >= 0).to(torch.uint8), hdr, rep))
    _equal(rows, pb._decode_sections_soft(v, hdr, rep))
    assert hard.shape[1] == sum(rk.row_words(n, hdr, rep)[:2])
    assert rows.shape[1] == sum(rk.row_words(n, hdr, rep, True))


# --- the eager route ---------------------------------------------------------

def test_qim_and_per_image_walks_take_the_eager_chain(monkeypatch):
    """A QIM read and a per-image-walk read (fused, retry and raw cores)
    run _walk_decisions, each counted once under KERNEL_READ_EAGER, and K5
    never; their rows are the eager chain's."""
    n = HDR + 7 * 100
    plane, y, x, jit = _walk(5, n)
    cr, ci = _spectra(5)
    imgs = _stubbed(monkeypatch, cr, ci)
    dither = torch.from_numpy(np.random.default_rng(6).uniform(
        -np.pi, np.pi, n).astype(np.float32))
    per = tuple(t[None].expand(B, n).contiguous() for t in (plane, y, x,
                                                            jit))
    calls = [
        lambda: pb.corner_extract_fused_core(
            imgs, 0.5, plane, y, x, hdr_stream_bits=HDR, with_soft=True,
            dither=dither, qim_levels=4, qim_from=HDR, **KW),
        lambda: pb.corner_soft_extract_core(
            imgs, 0.5, plane, y, x, hdr_stream_bits=HDR, dither=dither,
            qim_levels=4, **KW),
        lambda: pb.corner_raw_bits_core(imgs, 0.5, plane, y, x,
                                        dither=dither, qim_levels=4, **KW),
        lambda: pb.corner_extract_fused_core(
            imgs, 0.5, *per[:3], hdr_stream_bits=HDR, with_soft=True,
            jit=per[3], **KW),
        lambda: pb.corner_soft_extract_core(
            imgs, 0.5, *per[:3], hdr_stream_bits=HDR, jit=per[3], **KW)]
    for call in calls:
        before = dict(rk.LAUNCHES)
        call()
        assert rk.LAUNCHES[rk.KERNEL_READ_EAGER] == \
            before[rk.KERNEL_READ_EAGER] + 1
        assert rk.LAUNCHES[rk.KERNEL_READ_DECODE] == \
            before[rk.KERNEL_READ_DECODE]
    d = pb._walk_decisions(imgs, 0.5, plane, y, x, dither=dither,
                           qim_levels=4, qim_from=HDR, **KW)
    _equal(calls[0](), (pb._decode_sections((d >= 0).to(torch.uint8), HDR),
                        pb._decode_sections_soft(
                            d.to(torch.bfloat16).to(torch.float32), HDR)))
    # the per-image walk that repeats the shared walk in every row reads
    # what the shared walk reads through K5
    _equal(calls[4](), pb.corner_soft_extract_core(
        imgs, 0.5, plane, y, x, hdr_stream_bits=HDR, jit=jit, **KW))


# --- the wrapper and the kernel source ---------------------------------------

def test_read_decode_checks_its_arguments():
    n = HDR + 8 * 10
    plane, y, x, jit = _walk(9, n)
    cr, ci = _spectra(9)
    kw = dict(hdr_stream_bits=HDR, payload_rep=7)
    with pytest.raises(ValueError, match="payload_rep"):
        rk.read_decode(ci, plane, y, x, 1.0, hdr_stream_bits=HDR,
                       payload_rep=3)
    with pytest.raises(ValueError, match="soft"):
        rk.read_decode(ci, plane, y, x, 1.0, soft="fp16", **kw)
    with pytest.raises(ValueError, match="no row"):
        rk.read_decode(ci, plane, y, x, 1.0, hard=False, **kw)
    with pytest.raises(ValueError, match="jitter"):
        rk.read_decode(ci, plane, y, x, 1.0, None, torch.cos(jit),
                       torch.sin(jit), **kw)
    with pytest.raises(ValueError, match="shared"):
        rk.read_decode(ci, plane[None], y[None], x[None], 1.0, **kw)
    with pytest.raises(ValueError, match="whole bytes"):
        rk.read_decode(ci, plane[:-3], y[:-3], x[:-3], 1.0, soft="f32",
                       hdr_stream_bits=HDR, payload_rep=1)
    with pytest.raises(ValueError, match="tensors on"):
        rk.read_decode(ci, plane.to("meta"), y, x, 1.0, **kw)


def test_row_words_match_the_extract_jobs_soft_layout():
    """row_words gives the word counts _ExtractJob._soft_sections expects
    of a soft row (hdr_bits, n_slots, rep)."""
    for hdr, n, rep in ((HDR, HDR + 4096 * 3 - HDR, 7), (HDR, 8192, 1),
                        (0, 4096, 7), (0, 4096, 1)):
        hw = (hdr // 3 + 31) // 32 if hdr else 0
        wh = hw + ((n - hdr) // rep + 31) // 32
        c = (n - hdr) // 8 if rep == 1 else 0
        got = rk.row_words(n, hdr, rep, soft=True)
        assert (got[0], got[0] + got[1], got[2]) == (hw, wh, c)


def test_kernel_source_matches_the_wrapper():
    """csrc/corner_read_decode.cu's entry point takes what _build's
    signature passes (pointers, ints, the float ssa, the stream), its tile,
    row and chunk sizes are the wrapper's (the plan's masks and rows, the
    scratch's entries), and it is built with -fmad=false, as the other
    bit-exact kernels are."""
    src = (REPO / "steganosaurus_tpu_torch" / "csrc"
           / "corner_read_decode.cu").read_text()
    assert _kinds(src) == _kinds_of(_build._SIGNATURES["corner_read_decode"])

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TILE") == rk.TILE
    assert const("ROW_SLOTS") == rk.ROW_SLOTS
    assert const("CHUNK") == rk.CHUNK_IMAGES
    assert const("TILE") // 8 // 32 == rk.MASK_WORDS
    assert "-fmad=false" in _build.NVCC_SOURCE_FLAGS["corner_read_decode.cu"]


def _kinds(src: str) -> list:
    """"p", "i" or "f" for each argument of the C entry corner_read_decode
    in the source text `src`."""
    m = re.search(r'extern "C" int corner_read_decode\(([^)]*)\)', src)
    return ["p" if "*" in a else "f" if a.strip().startswith("float")
            else "i" for a in m.group(1).split(",")]


def _kinds_of(argtypes) -> list:
    return ["p" if t is _build._P else "f" if t is _build._F else "i"
            for t in argtypes]


def test_parent_entry_binds_the_gather_only_builds_signature():
    """The C entry corner_read_decode of the commit whose K5 was the gather
    alone (d14bcd8) takes the walk's indices in place of a plan:
    tools/parent_kernels_torch.py binds it with that commit's signature
    (OLD_SIGNATURES), not the committed one."""
    import sys
    sys.path.insert(0, str(REPO / "tools"))
    import parent_kernels_torch as pk

    src = pk.parent_source("d14bcd8", "corner_read_decode.cu")
    if src is None:
        pytest.skip("no git history to read the commit's source from")
    old = _kinds_of(pk.OLD_SIGNATURES["corner_read_decode"])
    assert _kinds(src.read_text()) == old
    assert old != _kinds_of(_build._SIGNATURES["corner_read_decode"])


# --- the read plan and an emulation of the kernel's phases ------------------

# the card's flag sets (tests/test_torch_cuda.py, chip_smoke.py phase 3f):
# (header slots, payload rep, hard row, soft row, jitter, sign(sin alpha))
READ_FLAGS = {
    "main": (912, 7, True, "bf16", False, 1.0),
    "hard only": (912, 7, True, None, False, 1.0),
    "no header": (0, 7, True, "bf16", False, 1.0),
    "rs": (912, 1, True, "bf16", False, 1.0),
    "rs retry": (912, 1, False, "f32", False, 1.0),
    "jitter": (912, 7, True, "bf16", True, 1.0),
    "jitter rs retry": (912, 1, False, "f32", True, -1.0),
    "retry": (912, 7, False, "f32", False, 1.0),
    "raw bits": (0, 1, True, None, False, 1.0),
    "ssa -1": (912, 7, True, "bf16", False, -1.0),
    "ssa 0": (912, 7, True, "f32", False, 0.0),
}
# walk slots planted in every image (the card's READ_PLANTED)
READ_PLANTED = {0: 0.0, 1: -0.0, 2: 0.0, 12: 3.0, 13: -3.0, 14: -0.0,
                920: -1e-42}
# (H, W, secret bytes) of the walks: 512x512 and 1080p
PLAN_GRIDS = {"512": (512, 512, 200), "1080p": (1080, 1920, 4096)}


@functools.lru_cache(maxsize=None)
def _grid_walk(grid: str):
    """The shared walk of a default-Params frame of the grid's secret on
    the CPU (its bucket's tail padding included), its jitter angles at
    0.2, and (Ky, Kx)."""
    H, W_, secret = PLAN_GRIDS[grid]
    PH, PW = tspectral.fft_dims(H, W_)
    Ky, Kx = corner.corner_dims(PH, PW, Params().rmax)
    total = HDR + tbatch._payload_stream_bits(secret + 16, False)
    bucket = tbatch._bucket(total)
    cpu = torch.device("cpu")
    (pl, yy, xx, _), nprod = tbatch._walk_indices_device(
        None, MK, Params(), PH, PW, total, 0, bucket, cpu)
    assert nprod >= total and bucket > total
    (_, _, _, jj), _ = tbatch._walk_indices_device(
        None, MK, Params(jitter=0.2), PH, PW, total, 0, bucket, cpu)
    return pl, yy, xx, jj, Ky, Kx


@functools.lru_cache(maxsize=None)
def _grid_spectra(grid: str, nb: int):
    """Seeded cr, ci (nb, 3, Ky, Kx) f32 with READ_PLANTED's values at
    those slots of the grid's walk."""
    pl, yy, xx, _, Ky, Kx = _grid_walk(grid)
    rng = np.random.default_rng(nb + len(grid))
    cr, ci = (torch.from_numpy((rng.normal(size=(nb, 3, Ky, Kx)) * 1e3)
                               .astype(np.float32)) for _ in range(2))
    for s, v in READ_PLANTED.items():
        ci[:, pl[s], yy[s], xx[s]] = v
    return cr, ci


def _mask_bits(plan) -> torch.Tensor:
    """(R, TILE // 8) bool: the plan rows' unit masks, unit by unit."""
    words = plan.rows[:, 3:].long() & 0xFFFFFFFF
    bit = torch.arange(32)
    return ((words[:, :, None] >> bit) & 1).bool().reshape(
        len(plan.rows), -1)


def _row_of(plan) -> torch.Tensor:
    """(n,) the plan row of each sorted position."""
    start, end = plan.rows[:, 1].long(), plan.rows[:, 2].long()
    return torch.repeat_interleave(torch.arange(len(start)), end - start)


def _flat_offs(plan) -> torch.Tensor:
    """(n,) each sorted slot's flat corner offset: its row's tile and its
    offset in the tile."""
    n = plan.order.shape[0]
    return (plan.rows[_row_of(plan), 0].long() * rk.TILE
            + plan.offs[:n].long())


def _check_plan(plan, plane, y, x, Ky: int, Kx: int) -> None:
    """A plan's properties: every slot once; the offsets sorted (ties in
    slot order), each an int16 within its tile; the rows partition the
    sorted list, each holding slots of one TILE-float tile, at most
    ROW_SLOTS of them and fewer only where the tile's slots end; each
    row's mask exactly the units its slots touch, so the masks' units,
    each counted once, are the walk's sectors (utils/cost.walk_sectors)."""
    n = plane.shape[0]
    assert plan.order.dtype == plan.rows.dtype == torch.int32
    assert plan.offs.dtype == torch.int16
    assert plan.offs.shape == (n + n % 2,)
    inside = plan.offs[:n].long()
    assert bool(((inside >= 0) & (inside < rk.TILE)).all())
    order, offs = plan.order.long(), _flat_offs(plan)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    flat = (plane.long() * Ky + y.long()) * Kx + x.long()
    assert torch.equal(offs, flat[order])
    same = offs[1:] == offs[:-1]
    assert bool((offs[1:] >= offs[:-1]).all())
    assert bool((order[1:][same] > order[:-1][same]).all())
    idx, start, end = (plan.rows[:, k].long() for k in range(3))
    assert bool((idx[1:] >= idx[:-1]).all())
    assert int(start[0]) == 0 and int(end[-1]) == n
    assert torch.equal(start[1:], end[:-1]) and bool((end > start).all())
    assert bool((end - start <= rk.ROW_SLOTS).all())
    short = (end - start < rk.ROW_SLOTS)[:-1]
    assert bool((idx[1:][short] > idx[:-1][short]).all())
    row_of = _row_of(plan)
    bits = _mask_bits(plan)
    want = torch.zeros_like(bits)
    want[row_of, inside // 8] = True
    assert torch.equal(bits, want)
    rows, units = torch.nonzero(bits).T
    touched = torch.unique(idx[rows] * (rk.TILE // 8) + units)
    assert touched.numel() == cost.walk_sectors(plane, y, x, Ky, Kx)
    assert plan.nbytes == 4 * n + 2 * (n + n % 2) + 4 * plan.rows.numel()


@pytest.mark.parametrize("grid", list(PLAN_GRIDS))
def test_read_plan_of_the_grids_walks(grid):
    """The plans of the 512x512 and 1080p walks, whose buckets end in tail
    padding that repeats the last bin: every property of _check_plan, the
    padding's duplicates each kept as a slot of its own, in rows of their
    own; one build counted each."""
    pl, yy, xx, _, Ky, Kx = _grid_walk(grid)
    before = rk.PLANS_BUILT
    plan = rk.read_plan(pl, yy, xx, Ky, Kx)
    assert rk.PLANS_BUILT == before + 1
    assert (plan.Ky, plan.Kx) == (Ky, Kx)
    _check_plan(plan, pl, yy, xx, Ky, Kx)
    # the padding's slots [total - 1, n) all read the last frame slot's bin
    H, W_, secret = PLAN_GRIDS[grid]
    total = HDR + tbatch._payload_stream_bits(secret + 16, False)
    n = pl.shape[0]
    pad_bin = int((pl[-1] * Ky + yy[-1]) * Kx + xx[-1])
    on_bin = _flat_offs(plan) == pad_bin
    at = plan.order[on_bin].long()
    assert n - total + 1 > 1
    assert set(range(total - 1, n)) <= set(at.tolist())
    # ... in rows of at most ROW_SLOTS each
    rows = torch.unique(_row_of(plan)[on_bin])
    assert rows.numel() >= -(-int(on_bin.sum()) // rk.ROW_SLOTS)


def test_read_plan_keeps_repeated_bins_and_ragged_corners():
    """A walk that reads some bins several times (in and out of order) over
    a corner of 3 x 32 x 48 floats, not a multiple of TILE: every slot
    keeps its entry, the last tile is partial, and the masks still count
    the touched sectors."""
    plane, y, x, _ = _walk(21, 400)
    rep = torch.tensor([5, 0, 399, 5, 17, 5])
    plane, y, x = (torch.cat([t, t[rep]]) for t in (plane, y, x))
    plan = rk.read_plan(plane, y, x, KY, KX)
    _check_plan(plan, plane, y, x, KY, KX)
    assert plan.order.shape == (406,)
    assert int(plan.rows[-1, 0]) == (3 * KY * KX - 1) // rk.TILE
    with pytest.raises(ValueError, match="shared"):
        rk.read_plan(plane[None], y[None], x[None], KY, KX)


def _stream_emulation(ci, plane, y, x, ssa: float, cr=None, cjd=None,
                      sjd=None, *, hdr_stream_bits: int, payload_rep: int,
                      hard: bool = True, soft: str | None = None, plan=None):
    """The kernel in torch ops over `plan` (built here when None):
    for each chunk of CHUNK_IMAGES images, phase A fills a NaN-poisoned
    scratch (n, CHUNK_IMAGES): each sorted slot takes its values at its
    offset from its row's tile, where its row's mask marks the unit (the
    row's copies: nothing else reaches the row's shared memory), NaN
    elsewhere, and writes slot order[i]'s entry; phase B takes the
    scratch's rows in slot order and decodes them (read_kernels
    .decode_rows, the decode read_decode_plain shares). Raises if a slot
    read a float its row's mask did not mark."""
    B, _, Ky, Kx = ci.shape
    if plan is None:
        plan = rk.read_plan(plane, y, x, Ky, Kx)
    N = 3 * Ky * Kx
    n = plan.order.shape[0]
    order, offs = plan.order.long(), _flat_offs(plan)
    row = _row_of(plan)
    inside = offs - plan.rows[row, 0].long() * rk.TILE
    copied = (inside >= 0) & (inside < rk.TILE)
    copied &= _mask_bits(plan)[row, inside.clamp(0, rk.TILE - 1) // 8]
    d = torch.empty((B, n), dtype=torch.float32)
    for c0 in range(0, B, rk.CHUNK_IMAGES):
        nb = min(rk.CHUNK_IMAGES, B - c0)
        scratch = torch.full((n, rk.CHUNK_IMAGES), float("nan"))
        ring = []
        for t in (ci, cr) if cjd is not None else (ci,):
            v = t[c0:c0 + nb].reshape(nb, N)[:, offs]
            ring.append(torch.where(copied, v, float("nan")))
        vals = corner.decision_values(
            ring[0], ssa, ring[1] if cjd is not None else None,
            None if cjd is None else cjd[order],
            None if sjd is None else sjd[order])
        scratch[order, :nb] = vals.T
        assert not bool(torch.isnan(scratch[:, :nb]).any())
        d[c0:c0 + nb] = scratch[:, :nb].T
    return rk.decode_rows(d, hdr_stream_bits, payload_rep, hard, soft)


@pytest.mark.parametrize("B", [1, 3, 8, 9])
@pytest.mark.parametrize("grid", list(PLAN_GRIDS))
@pytest.mark.parametrize("flags", list(READ_FLAGS))
def test_stream_emulation_is_bit_equal_to_plain(grid, flags, B):
    """The emulation of the kernel's phases over the grid walk's plan
    against read_decode_plain on the same spectrum: every word equal, on
    every flag set, with B below, at and above one chunk."""
    hdr, rep, hard, soft, jitter, ssa = READ_FLAGS[flags]
    pl, yy, xx, jj, Ky, Kx = _grid_walk(grid)
    cr, ci = _grid_spectra(grid, B)
    extra = ((cr, torch.cos(jj), torch.sin(jj)) if jitter
             else (None, None, None))
    kw = dict(hdr_stream_bits=hdr, payload_rep=rep, hard=hard, soft=soft)
    plan = _grid_plan(grid)
    got = _stream_emulation(ci, pl, yy, xx, ssa, *extra, plan=plan, **kw)
    want = rk.read_decode_plain(ci, pl, yy, xx, ssa, *extra, **kw)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _equal(g, w)


@functools.lru_cache(maxsize=None)
def _grid_plan(grid: str):
    pl, yy, xx, _, Ky, Kx = _grid_walk(grid)
    return rk.read_plan(pl, yy, xx, Ky, Kx)


@pytest.mark.parametrize("card", [True, False])
def test_two_extract_batch_calls_build_one_plan(monkeypatch, card):
    """Under one key (an empty walk cache to start from), two hinted
    extract_batch calls of the same 512x512 stego: where read_decode reads
    through plans (read_kernels.uses_plan stubbed to say so, as on a card)
    the first pass builds one read plan and keeps it in its walk's cache
    entry, the second finds it there; on the CPU, whose plain version
    needs none, no plan is built."""
    p = Params()
    _, secrets, st = _stego(p)
    monkeypatch.setattr(tbatch, "_DEV_IDX_CACHE", OrderedDict())
    if card:
        monkeypatch.setattr(rk, "uses_plan", lambda device: True)
    before = rk.PLANS_BUILT
    for _ in range(2):
        assert stt.extract_batch(st, master_key=MK, params=p,
                                 clen_hint=SECRET, device="cpu") == secrets
        assert rk.PLANS_BUILT == before + card
    plans = [plan for ent in tbatch._DEV_IDX_CACHE.values() if len(ent) == 3
             for plan in ent[2].values()]
    assert len(plans) == card
    assert all(isinstance(plan, rk.ReadPlan) for plan in plans)


# --- the three cores against the JAX package's, 512x512 ---------------------

H = W = 512
NB = 3
SECRET = 200
SALTS = [bytes([i]) * 16 for i in range(NB)]
_STEGO: dict = {}


def _stego(p: Params):
    """Covers, secrets and the port's stego of one Params, made once."""
    key = dataclasses.astuple(p)
    if key not in _STEGO:
        rng = np.random.default_rng(17)
        base = np.linspace(150, 235, W)
        covers = np.clip(base[None, None, :, None]
                         + rng.integers(-18, 19, (NB, H, W, 3)), 0,
                         255).astype(np.uint8)
        secrets = [bytes(rng.integers(0, 256, SECRET, dtype=np.uint8))
                   for _ in range(NB)]
        st = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                             salts=SALTS, device="cpu").stego
        _STEGO[key] = (covers, secrets, np.asarray(st))
    return _STEGO[key]


def _geometry(p: Params):
    PH, PW = tspectral.fft_dims(H, W)
    Ky, Kx = corner.corner_dims(PH, PW, p.rmax)
    nbytes = SECRET + 16
    total = HDR + tbatch._payload_stream_bits(nbytes, p.rs)
    return PH, PW, Ky, Kx, total, tbatch._bucket(total)


def _jax_maps(p: Params, PH, PW, total, bucket, Ky, Kx):
    if not p.jitter:
        return ()
    maps, _ = jbatch._corner_statics_device(None, MK, jp(p), PH, PW, total,
                                            bucket, Ky, Kx, None)
    return jbatch._read_maps(maps, jp(p))


JAX_CASES = {"default": Params(), "jitter": Params(jitter=0.2),
             "rs": Params(rs=True)}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_three_cores_equal_jax_on_a_512_batch(name):
    """The port's fused pass (hard and bf16 soft rows), retry pass (f32
    soft rows, RS confidences) and raw bits, each through read_decode, on
    the port's 512x512 stego against the JAX package's cores on the same
    stego and walk: the decoded rows equal; the raw bits equal but at bins
    whose d lies within RAW_NEAR of zero; the confidences within 1e-2 of
    their scale; both packages' extract_batch recover every secret."""
    _three_cores_vs_jax(name)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_three_cores_through_the_stream_emulation_equal_jax(monkeypatch,
                                                           name):
    """test_three_cores_equal_jax_on_a_512_batch with read_decode's CPU
    version replaced by the emulation of the kernel over the walk's plan:
    the same rows as the JAX package's cores."""
    monkeypatch.setattr(rk, "read_decode_plain", _stream_emulation)
    _three_cores_vs_jax(name)


def _three_cores_vs_jax(name: str) -> None:
    p = JAX_CASES[name]
    covers, secrets, st = _stego(p)
    PH, PW, Ky, Kx, total, bucket = _geometry(p)
    rep = 1 if p.rs else 7
    (pl, yy, xx, jj), nprod = tbatch._walk_indices_device(
        None, MK, p, PH, PW, total, 0, bucket, torch.device("cpu"))
    assert nprod >= total
    jit = jj if p.jitter else None
    imgs = torch.from_numpy(st)
    kw = dict(Ky=Ky, Kx=Kx, center=p.center, layout="nhwc")
    hard, soft = pb.corner_extract_fused_core(
        imgs, p.alpha, pl, yy, xx, hdr_stream_bits=HDR, with_soft=True,
        jit=jit, payload_rep=rep, **kw)
    retry = pb.corner_soft_extract_core(imgs, p.alpha, pl, yy, xx,
                                        hdr_stream_bits=HDR, jit=jit,
                                        payload_rep=rep, **kw)
    raw = pb.corner_raw_bits_core(imgs, p.alpha, pl, yy, xx, jit=jit, **kw)

    maps = _jax_maps(p, PH, PW, total, bucket, Ky, Kx)
    alpha = jnp.float32(p.alpha)
    jw = tuple(jnp.asarray(t.numpy().astype(np.int32)) for t in (pl, yy, xx))
    jst = jnp.asarray(st)
    fused = jpb.corner_extract_fused_core(
        H, W, Ky, Kx, p.center, bool(p.jitter), "nhwc", HDR, NB,
        payload_rep=rep, with_soft=True)(jst, *maps, alpha, *jw)
    jretry = jpb.corner_soft_extract_core(
        H, W, Ky, Kx, p.center, bool(p.jitter), "nhwc", HDR,
        payload_rep=rep)(jst, *maps, alpha, *jw)
    bd = jpb.corner_bits_core(H, W, Ky, Kx, p.center, None, bool(p.jitter),
                              layout="nhwc")(jst, *maps, alpha)
    jraw = np.asarray(jpb.corner_gather_raw_core(None, B=NB)(bd, *jw))

    np.testing.assert_array_equal(hard.numpy(), np.asarray(fused[0]))
    hw, pw, _ = rk.row_words(bucket, HDR, rep)
    words = retry if rep == 7 else retry[0]
    jwords = jretry if rep == 7 else jretry[0]
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    jsoft = np.asarray(fused[1])
    np.testing.assert_array_equal(soft.numpy()[:, :hw + pw],
                                  jsoft[:, :hw + pw])
    if rep == 1:
        for got, want in ((soft.numpy()[:, hw + pw:].view(np.float32),
                           jsoft[:, hw + pw:].view(np.float32)),
                          (retry[1].numpy(), np.asarray(jretry[1]))):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-2 * float(np.abs(want).max()))
    got_bits = bit_ops.unpack_words_host(raw.numpy(), bucket)
    want_bits = bit_ops.unpack_words_host(jraw, bucket)
    off = got_bits != want_bits
    d = pb._walk_decisions(imgs, p.alpha, pl, yy, xx, jit=jit, **kw).numpy()
    rms = float(np.sqrt(np.mean(d * d)))
    print(f"{name}: {int(off.sum())} of {off.size} raw bits differ, "
          f"max |d| there {float(np.abs(d[off]).max(initial=0)) / rms:.4f} "
          f"of the RMS")
    assert off.sum() <= 1e-3 * off.size
    assert (np.abs(d[off]) <= RAW_NEAR * rms).all()
    assert stt.extract_batch(st, master_key=MK, params=p,
                             device="cpu") == secrets
    assert jbatch.extract_batch(st, master_key=MK, params=jp(p)) == secrets
