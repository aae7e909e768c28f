"""Card-only tests of the torch port: the hand-written K1 kernel
(csrc/corner_stage1_wgmma.cu, A by TMA for W % 16 == 0 on an aligned base,
by the producer's loads for any other W or base) against its plain version,
at both routes' edge shapes and on views that end at the last byte of their
storage, the wrapper's routing, checks and launch counts, round trips
through the kernel (small, and 1080p B=8), a two-batch stream, the soft-
decision retry pass (Rep-7 and RS), a QIM extract and a per-image-walk
embed; the single-image path: a 1080p embed_array -> extract_array round
trip, the exact median (kthvalue against the bisection twin) at 4K, a 1080p
adaptive_alpha batch through the full-grid cores, and a complex128 round
trip that stays on the card; the serve worker at 512x512 (K1 launched by
every op) and the CLI's embed -> extract on the card; a round trip over a
2-shard logical mesh on the card (K1 once per shard per pass), the sharded
FFT and median against the dense ones, the graft entry (graft_entry:
entry() against the CPU, the dry run over 2 logical shards), the cost
model's peak rates for the card; and the embed's K3 kernel (both entry
points) and K4e against their plain versions at 512x512 B=8 and 1079x1917
B=4 (K3 bit-exact against its ordered twin, which sums in the kernel's
order, K4e bit-exact), K6 (the inverse DFT's y-stage) against its plain
version (the f32 sums within 1e-5 of their scale, the bf16 outputs one ulp
apart at most) and its staging copy, write_floor's bf16 operand mode
against its f32
output cast and its two schedules against each other (bit for bit), its
boost independent of the batch, the write wrappers' checks, and the K3 /
K4e launches of each corner embed path; forward stage 2's prep pass
(bf16 copies bit-equal, energies against the exact sum) and K2 against its
bf16x6 twin at edge shapes, the band kernel bit-exact, a plane's bits
independent of its batch, the
stage-2 wrappers' counts and checks, and fwd_corner's launches on the card;
K6, K2 and K4 bit-equal to their builds before the redesigns (K6's and
K4's staged stores, K2's cluster; tools/parent_kernels_torch.py), and a
launch K6 or K2 refuses raising in its wrapper.

They skip without CUDA. This file imports neither jax nor the JAX package's
device code, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REL = 1e-5  # f32 sums of exact bf16 products, in another order


@pytest.fixture
def dev(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from steganosaurus_tpu_torch import runtime

    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", str(tmp_path))
    runtime.configure_precision()
    return torch.device("cuda", 0)


def _tables(W, Kx, dev):
    from steganosaurus_tpu_torch.spectral import corner

    return tuple(torch.from_numpy(t).to(dev).to(torch.bfloat16)
                 for t in corner._dft_tables(W, Kx))


@pytest.mark.parametrize("shape,Kx,center", [
    ((1, 3, 67, 203), 45, True),        # nothing aligned: the load route
    ((2, 3, 100, 250), 130, False),     # W % 16 != 0: the load route
    ((1, 3, 128, 512), 64, True),       # exact tiles
    ((3, 384, 640), 256, False),        # no batch axis
    ((1, 3, 2160, 3840), 1024, False),  # one 4K image of the main path
])
def test_k1_matches_plain(dev, shape, Kx, center):
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    exr, exi = _tables(shape[-1], Kx, dev)
    ar, ai = ck.fwd_stage1(x, exr, exi, center)
    pr, pi = ck.fwd_stage1_plain(x, exr, exi, center)
    torch.cuda.synchronize()
    assert ar.shape == pr.shape == (*shape[:-1], Kx)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (ar - pr).abs().max().item() <= REL * scale
    assert (ai - pi).abs().max().item() <= REL * scale


def test_k1_wrapper_counts_and_checks(dev):
    """Each route counts under its own name, chosen by W % 16 and the base
    address; bad inputs raise before any launch."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    x = torch.zeros((1, 3, 64, 256), dtype=torch.uint8, device=dev)
    exr, exi = _tables(256, 64, dev)
    n = dict(ck.LAUNCHES)
    ck.fwd_stage1(x, exr, exi, False)
    assert ck.LAUNCHES == {**n, ck.KERNEL_TMA: n[ck.KERNEL_TMA] + 1}
    y = torch.zeros((1, 3, 64, 250), dtype=torch.uint8, device=dev)
    ck.fwd_stage1(y, *_tables(250, 64, dev), True)
    assert ck.LAUNCHES[ck.KERNEL_LDG] == n[ck.KERNEL_LDG] + 1
    n = dict(ck.LAUNCHES)
    with pytest.raises(ValueError):
        ck.fwd_stage1(x.transpose(-1, -2).contiguous().transpose(-1, -2),
                      exr, exi, False)
    with pytest.raises(ValueError):
        ck.fwd_stage1(x, exr.cpu(), exi.cpu(), False)
    with pytest.raises(ValueError):
        ck.fwd_stage1(x, exr.float(), exi.float(), False)
    with pytest.raises(ValueError):  # a table of another Kx
        ck.fwd_stage1(x, exr, exi, False, ck.stage1_tables(
            torch.cat([exr, exr]), torch.cat([exi, exi])))
    with pytest.raises(ValueError):  # the TMA route at an unaligned base
        v = torch.zeros(1 + 64 * 256, dtype=torch.uint8,
                        device=dev)[1:].view(1, 64, 256)
        ck._launch(v, ck.stage1_tables(exr, exi)[0],
                   *(torch.empty((1, 64, 64), device=dev) for _ in range(2)),
                   64, False, ck.KERNEL_TMA)
    assert ck.LAUNCHES == n
    # an unaligned base with W % 16 == 0 goes to the load route and
    # matches the plain version there
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.integers(0, 256, 1 + 64 * 256,
                                      dtype=np.uint8)).to(dev)[1:]
    v = v.view(1, 64, 256)
    ar, ai = ck.fwd_stage1(v, exr, exi, False)
    pr, pi = ck.fwd_stage1_plain(v, exr, exi, False)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**n, ck.KERNEL_LDG: n[ck.KERNEL_LDG] + 1}
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (ar - pr).abs().max().item() <= REL * scale
    assert (ai - pi).abs().max().item() <= REL * scale


@pytest.mark.parametrize("shape,Kx,center,offset", [
    ((2, 3, 100, 1917), 300, False, 0),  # P*H % 128 != 0, Kx % 256 != 0
    ((1, 3, 37, 17), 17, True, 0),       # W < 64: one K block
    ((2, 1, 129, 250), 130, True, 0),    # one row past a whole tile
    ((1, 3, 301, 1917), 512, True, 7),   # a view ending at its storage's end
    ((3, 45, 203), 64, False, 3),
    ((2, 3, 67, 512), 300, True, 1),     # W % 16 == 0, unaligned base
])
def test_k1_load_route_matches_plain(dev, shape, Kx, center, offset):
    """The load route at its edge shapes, on images `offset` bytes into a
    storage of exactly their size: its last row ends at the storage's last
    byte, which no copy may read past."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(sum(shape) + Kx + offset)
    n_img = int(np.prod(shape))
    buf = torch.from_numpy(rng.integers(0, 256, offset + n_img,
                                        dtype=np.uint8)).to(dev)
    x = buf[offset:].view(shape)
    assert ck.route_for(shape[-1], x.data_ptr()) == ck.KERNEL_LDG
    exr, exi = _tables(shape[-1], Kx, dev)
    n = ck.LAUNCHES[ck.KERNEL_LDG]
    ar, ai = ck.fwd_stage1(x, exr, exi, center)
    pr, pi = ck.fwd_stage1_plain(x, exr, exi, center)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[ck.KERNEL_LDG] == n + 1
    assert ar.shape == pr.shape == (*shape[:-1], Kx)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (ar - pr).abs().max().item() <= REL * scale
    assert (ai - pi).abs().max().item() <= REL * scale


@pytest.mark.parametrize("shape,Kx,center", [
    ((1, 1, 67, 528), 45, True),      # P = 1, W % 64 != 0, Kx % 64 != 0
    ((2, 3, 67, 528), 1000, False),   # P*H % 128 != 0, Kx % 256 != 0
    ((1, 3, 100, 256), 45, False),
    ((2, 3, 67, 512), 1000, True),
    ((1, 3, 37, 64), 64, True),       # a single K block
    ((1, 3, 1080, 1920), 512, True),  # one 1080p image
])
def test_k1_wgmma_edges_match_plain(dev, shape, Kx, center):
    """The TMA route at its edge shapes, with and without the cached
    concatenated table."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(sum(shape) + Kx)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    assert ck.route_for(shape[-1], x.data_ptr()) == ck.KERNEL_TMA
    exr, exi = _tables(shape[-1], Kx, dev)
    n = ck.LAUNCHES[ck.KERNEL_TMA]
    pr, pi = ck.fwd_stage1_plain(x, exr, exi, center)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    for tables in (None, ck.stage1_tables(exr, exi)):
        ar, ai = ck.fwd_stage1(x, exr, exi, center, tables)
        torch.cuda.synchronize()
        assert ar.shape == pr.shape == (*shape[:-1], Kx)
        assert (ar - pr).abs().max().item() <= REL * scale
        assert (ai - pi).abs().max().item() <= REL * scale
    assert ck.LAUNCHES[ck.KERNEL_TMA] == n + 2


# (shape, Kx, center, offset into the images' storage): 4K-tall planes
# (2160 = 16 * 128 + 112: a plane boundary inside a row tile), H = 70 (a
# row tile over three planes), P = 1 and 3, an odd Kxp/64 (Kx = 300), the
# 2160 x 3839 load route, an unaligned view (the load route at W % 16 ==
# 0), Kx % 4 != 0 (the scalar stores)
K1_PREP_CASES = [
    ((1, 3, 2160, 512), 256, False, 0), ((1, 3, 2160, 512), 256, True, 0),
    ((3, 70, 256), 300, True, 0), ((1, 70, 250), 130, False, 0),
    ((1, 1, 2160, 3839), 1024, False, 0), ((2, 3, 67, 512), 300, True, 1),
    ((1, 37, 203), 45, False, 3)]
# the commit before K1's paired table and prep: its K1 took the table as
# exr rows then exi rows
K1_PARENT = "5b99743"


def _u8_at(shape, offset, seed, dev):
    """Seeded u8 images of `shape` `offset` bytes into a storage of exactly
    their size."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.integers(0, 256, offset + n,
                                        dtype=np.uint8)).to(dev)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("prep", ["energies", "copies"])
@pytest.mark.parametrize("shape,Kx,center,offset", K1_PREP_CASES)
def test_k1_prep_matches_k1_and_the_prep_pass(dev, monkeypatch, shape, Kx,
                                             center, offset, prep):
    """K1 with stage 2's prep in its epilogue against K1 alone followed by
    the prep pass: ar and ai bit-equal; the bf16 copies bit-equal to
    .to(bf16) and the prep pass's, in rows ldk apart whose padding columns
    are never written; under "energies" the energies equal to
    stage1_energy_plain's bit for bit, within 2^-24 of the exact sum and
    picking the top-64 band band_columns picks; the launch counted under
    its route, KERNEL_K1_PREP and (energies) KERNEL_PREP_REDUCE."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    x = _u8_at(shape, offset, sum(shape) + Kx + offset, dev)
    H, W = shape[-2:]
    P = x.numel() // (H * W)
    exr, exi = _tables(W, Kx, dev)
    real = ck._copies

    def marked(*a):  # the padding columns hold a mark no copy can take
        buf = real(*a)
        buf.view(torch.int16).fill_(-1)
        return buf

    monkeypatch.setattr(ck, "_copies", marked)
    n = dict(ck.LAUNCHES)
    ar, ai, (ar16, ai16, energy) = ck.fwd_stage1(x, exr, exi, center,
                                                 prep=prep)
    route = ck.route_for(W, x.data_ptr())
    assert {k: ck.LAUNCHES[k] - n[k] for k in n if ck.LAUNCHES[k] != n[k]} \
        == {route: 1, ck.KERNEL_K1_PREP: 1,
            **({ck.KERNEL_PREP_REDUCE: 1} if prep == "energies" else {})}
    want_r, want_i = ck.fwd_stage1(x, exr, exi, center)
    torch.cuda.synchronize()
    assert torch.equal(ar, want_r) and torch.equal(ai, want_i)
    a, b = ar.reshape(P, H, Kx), ai.reshape(P, H, Kx)
    pass16r, pass16i, pass_energy = ck.stage2_prep(a, b)
    for got, f32, other in ((ar16, a, pass16r), (ai16, b, pass16i)):
        assert torch.equal(got, f32.to(torch.bfloat16))
        assert torch.equal(got, other)
        ldk = -(-Kx // 8) * 8
        assert got.shape == (P, H, Kx) and got.stride() == (H * ldk, ldk, 1)
        pad = got.as_strided((P, H, ldk - Kx), got.stride(),
                             got.storage_offset() + Kx)
        assert (pad.view(torch.int16) == -1).all()
    if prep == "copies":
        assert energy is None
        return
    assert energy.shape == (P, Kx) and energy.dtype == torch.float32
    assert torch.equal(energy, ck.stage1_energy_plain(a, b))
    exact = torch.sum((a * a + b * b).double(), dim=1)
    assert ((energy.double() - exact).abs() / exact).max() <= 2.0 ** -24
    assert ((energy - pass_energy).abs() / pass_energy).max() <= 2.0 ** -23
    X0 = min(64, Kx)
    mine = corner.band_topk(energy, X0).sort(1).values
    assert torch.equal(mine, corner.band_columns(a, b, X0).sort(1).values)


@pytest.mark.parametrize("shape,Kx,center,offset", K1_PREP_CASES)
def test_k1_bit_equal_to_its_parent(dev, shape, Kx, center, offset):
    """The paired table moves data only: K1's ar and ai, without the prep
    and with it, equal those of K1_PARENT's build (its exr-then-exi table,
    its own signature: tools/k1_ablation_torch.py parent_stage1) bit for
    bit on both routes."""
    import importlib.util
    import pathlib

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    first = _first_version("corner_stage1_wgmma.cu", K1_PARENT)
    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "k1_ablation_torch.py")
    spec = importlib.util.spec_from_file_location("k1_ablation_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = _parent_tool().parent_source(K1_PARENT, "corner_stage1_wgmma.cu")
    x = _u8_at(shape, offset, 2 * sum(shape) + Kx, dev)
    exr, exi = _tables(shape[-1], Kx, dev)
    t = ck.stage1_tables(exr, exi)
    want = tool.parent_stage1(first, source, x, t[1] if center else t[0], Kx,
                              center)
    for prep in (None, "energies"):
        got = ck.fwd_stage1(x, exr, exi, center, t, prep)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_1080p_round_trip_through_the_wgmma_kernel(dev):
    """1080p, B=8, 1 KB: embed and extract on the card through the kernel's
    TMA route (and never the load route), every secret read back."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(8)
    base = np.linspace(150, 235, 1920)[None, None, :]
    imgs = np.clip(base + rng.integers(-18, 19, (8, 3, 1080, 1920)), 0,
                   255).astype(np.uint8)
    secrets = [bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
               for _ in range(8)]
    n = dict(ck.LAUNCHES)
    res = stt.embed_batch(torch.from_numpy(imgs).to(dev), secrets,
                          master_key=bytes(32), device_resident=True,
                          layout="nchw")
    got = stt.extract_batch(res.stego, master_key=bytes(32), layout="nchw")
    torch.cuda.synchronize()
    assert got == secrets
    assert ck.LAUNCHES[ck.KERNEL_TMA] >= n[ck.KERNEL_TMA] + 2
    assert ck.LAUNCHES[ck.KERNEL_LDG] == n[ck.KERNEL_LDG]


def test_round_trip_on_card_goes_through_k1(dev):
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(100, 160, (2, 3, 256, 256),
                                         dtype=np.uint8)).to(dev)
    secrets = [b"x" * 32, b"y" * 32]
    n = ck.LAUNCHES[ck.KERNEL_TMA]
    res = stt.embed_batch(imgs, secrets, master_key=bytes(32),
                          device_resident=True, layout="nchw")
    assert res.stego.device == imgs.device
    got = stt.extract_batch(res.stego, master_key=bytes(32), clen_hint=32,
                            layout="nchw")
    torch.cuda.synchronize()
    assert got == secrets
    assert ck.LAUNCHES[ck.KERNEL_TMA] >= n + 2


def test_stream_on_card_matches_batches(dev):
    """A stream of two 512x512 batches (depth 2, nchw) yields the stegos of
    per-batch embed_batch calls byte for byte, and extract_stream reads
    them back."""
    import steganosaurus_tpu_torch as stt

    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.integers(90, 170, (4, 3, 512, 512),
                                          dtype=np.uint8)).to(dev)
            for _ in range(2)]
    secrets = [[bytes([k * 4 + i]) * (60 + i) for i in range(4)]
               for k in range(2)]
    salts = [[bytes([k * 4 + i + 1]) * 16 for i in range(4)]
             for k in range(2)]
    mk = bytes(range(32))
    streamed = list(stt.embed_stream(
        zip(imgs, secrets, salts), master_key=mk, depth=2, layout="nchw"))
    for k, res in enumerate(streamed):
        ref = stt.embed_batch(imgs[k], secrets[k], master_key=mk,
                              salts=salts[k], device_resident=True,
                              layout="nchw")
        torch.cuda.synchronize()
        assert res.stego.device == imgs[k].device
        assert torch.equal(res.stego, ref.stego)
    got = list(stt.extract_stream((r.stego for r in streamed),
                                  master_key=mk, depth=2, layout="nchw"))
    assert got == secrets


def test_soft_retry_pass_on_card_launches_k1(dev, monkeypatch):
    """The soft-decision retry pass on the margin workload (256x256 noise
    cover, 240 B, B=8), with the fused pass's inline soft rows dropped so
    the retry pass is what recovers: it recovers more than the hard decode
    and launches K1."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.pipeline import batch as tbatch
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    B, mk = 8, bytes(range(32))
    covers = torch.from_numpy(np.stack([cover] * B)).to(dev)
    hard_p = stt.Params(soft_decode_fallback=False)
    stego = stt.embed_batch(covers, [secret] * B, master_key=mk,
                            params=hard_p, salts=[bytes([i]) * 16
                                                  for i in range(B)],
                            device_resident=True).stego
    hard = stt.extract_batch(stego, master_key=mk, params=hard_p)
    n_hard = sum(g is not None for g in hard)
    assert n_hard < B, "the margin workload no longer fails hard"

    real_dispatch = tbatch._ExtractJob._dispatch_pass
    real_retry = tbatch._ExtractJob._soft_retry_failed
    retry_launches = []

    def no_inline(self, *a, **kw):
        hard_rows, _, _ = real_dispatch(self, *a, **kw)
        return hard_rows, None, None

    def counted_retry(self, headers, out):
        n = ck.LAUNCHES[ck.KERNEL_TMA]
        real_retry(self, headers, out)
        retry_launches.append(ck.LAUNCHES[ck.KERNEL_TMA] - n)

    monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_pass", no_inline)
    monkeypatch.setattr(tbatch._ExtractJob, "_soft_retry_failed",
                        counted_retry)
    got = stt.extract_batch(stego, master_key=mk)
    torch.cuda.synchronize()
    assert retry_launches and retry_launches[0] >= 1
    assert sum(g is not None for g in got) > n_hard
    assert all(g is None or g == secret for g in got)


def test_qim_extract_on_card_launches_k1(dev):
    """A QIM stego made on the CPU reads back on the card (payload-only
    pass under the header's level: no hint), through K1, and equals the
    card's own stego to +-1."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(11)
    imgs = rng.integers(90, 170, (2, 256, 256, 3), dtype=np.uint8)
    secrets = [b"qim-0" * 8, b"qim-1" * 8]
    p = stt.Params(qim=3, pbkdf2_iter=500)
    salts = [bytes([i + 1]) * 16 for i in range(2)]
    cpu = stt.embed_batch(imgs, secrets, master_key=bytes(32), params=p,
                          salts=salts, device="cpu").stego
    n = ck.LAUNCHES[ck.KERNEL_TMA]
    got = stt.extract_batch(torch.from_numpy(cpu).to(dev),
                            master_key=bytes(32), params=p)
    torch.cuda.synchronize()
    assert got == secrets
    assert ck.LAUNCHES[ck.KERNEL_TMA] >= n + 2   # probe + payload pass
    card = stt.embed_batch(imgs, secrets, master_key=bytes(32), params=p,
                           salts=salts, device=dev).stego
    assert np.abs(card.astype(np.int16) - cpu.astype(np.int16)).max() <= 1


def test_piw_embed_on_card_launches_k1(dev):
    """Params.stealth() (per-image walks, QIM, spread, soft write, jitter)
    embeds on the card through K1, and the CPU port reads it back."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(12)
    imgs = torch.from_numpy(rng.integers(90, 170, (3, 3, 256, 256),
                                         dtype=np.uint8)).to(dev)
    secrets = [bytes([i]) * (30 + i) for i in range(3)]
    p = stt.Params.stealth(pbkdf2_iter=500)
    n = ck.LAUNCHES[ck.KERNEL_TMA]
    res = stt.embed_batch(imgs, secrets, master_key=bytes(32), params=p,
                          device_resident=True, layout="nchw")
    torch.cuda.synchronize()
    assert ck.LAUNCHES[ck.KERNEL_TMA] == n + 1
    assert res.stego.device == imgs.device
    assert stt.extract_batch(res.stego.cpu().numpy(), master_key=bytes(32),
                             params=p, layout="nchw",
                             device="cpu") == secrets


def test_rs_soft_retry_on_card_launches_k1(dev, monkeypatch):
    """The RS margin workload (256x256 noise cover, 1200 B, B=8) with the
    fused pass's inline soft rows dropped: the retry pass recovers more
    than the hard decode through its per-coded-byte confidences, and
    launches K1."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.pipeline import batch as tbatch
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 1200, dtype=np.uint8))
    B, mk = 8, bytes(range(32))
    covers = torch.from_numpy(np.stack([cover] * B)).to(dev)
    hard_p = stt.Params(rs=True, soft_decode_fallback=False)
    stego = stt.embed_batch(covers, [secret] * B, master_key=mk,
                            params=hard_p, salts=[bytes([i]) * 16
                                                  for i in range(B)],
                            device_resident=True).stego
    n_hard = sum(g is not None for g in stt.extract_batch(
        stego, master_key=mk, params=hard_p))
    assert n_hard < B, "the RS margin workload no longer fails hard"

    real_dispatch = tbatch._ExtractJob._dispatch_pass
    real_retry = tbatch._ExtractJob._soft_retry_failed
    retry_launches = []

    def no_inline(self, *a, **kw):
        return real_dispatch(self, *a, **kw)[0], None, None

    def counted_retry(self, headers, out):
        n = ck.LAUNCHES[ck.KERNEL_TMA]
        real_retry(self, headers, out)
        retry_launches.append(ck.LAUNCHES[ck.KERNEL_TMA] - n)

    monkeypatch.setattr(tbatch._ExtractJob, "_dispatch_pass", no_inline)
    monkeypatch.setattr(tbatch._ExtractJob, "_soft_retry_failed",
                        counted_retry)
    got = stt.extract_batch(stego, master_key=mk,
                            params=stt.Params(rs=True))
    torch.cuda.synchronize()
    assert retry_launches and retry_launches[0] >= 1
    assert sum(g is not None for g in got) > n_hard
    assert all(g is None or g == secret for g in got)


def _photo_like(h, w, seed, n=1):
    """Smooth gradients plus noise, (n, h, w, 3) u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (96 + 60 * np.sin(xx / 97.0) * np.cos(yy / 61.0))[None, ..., None]
    return np.clip(base + rng.integers(-20, 21, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


def test_1080p_single_image_round_trip_on_card(dev):
    """embed_array -> extract_array on a 1080p cover on the card (tensor in,
    tensor out on the card), and the CPU port reads the card's stego; the
    card and CPU stegos differ by at most 1."""
    import steganosaurus_tpu_torch as stt

    cover = _photo_like(1080, 1920, 31)[0]
    secret = bytes(np.random.default_rng(32).integers(0, 256, 4096,
                                                      dtype=np.uint8))
    p = stt.Params(pbkdf2_iter=500)
    res = stt.embed_array(torch.from_numpy(cover).to(dev), secret,
                          password="pw", params=p, salt=bytes(16))
    assert res.stego.device.type == "cuda"
    assert stt.extract_array(res.stego, password="pw", params=p) == secret
    cpu = stt.embed_array(cover, secret, password="pw", params=p,
                          salt=bytes(16), device="cpu").stego
    card = res.stego.cpu().numpy()
    assert np.abs(card.astype(np.int16) - cpu.astype(np.int16)).max() <= 1
    assert stt.extract_array(card, password="pw", params=p,
                             device="cpu") == secret


def test_median_kthvalue_equals_bisection_at_4k(dev):
    """torch.kthvalue on the card returns the bisection twin's element, bit
    for bit, on a 4K cover's spectrum magnitudes (3 x 8.3M)."""
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.ops import stats

    cover = torch.from_numpy(_photo_like(2160, 3840, 33)[0]).to(dev)
    spec = spectral.fft2(spectral.to_planes(cover))
    mags = spec.abs().reshape(3, -1)
    k = mags.shape[1] // 2
    a = stats.median_upper(mags)
    b = stats.kth_smallest_nonneg(mags, k)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a, mags.sort(dim=1).values[:, k])


def test_adaptive_alpha_batch_round_trip_1080p_on_card(dev):
    """An adaptive_alpha batch (full-grid cores) at 1080p, B=4, 4 KB: embed
    and extract on the card, read back by the CPU port too."""
    import steganosaurus_tpu_torch as stt

    covers = _photo_like(1080, 1920, 34, n=4)
    rng = np.random.default_rng(35)
    secrets = [bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
               for _ in range(4)]
    p = stt.Params(adaptive_alpha=True, pbkdf2_iter=500)
    res = stt.embed_batch(torch.from_numpy(covers).to(dev), secrets,
                          master_key=bytes(32), params=p,
                          device_resident=True, verify=True)
    assert res.verified == [True] * 4
    assert stt.extract_batch(res.stego, master_key=bytes(32),
                             params=p) == secrets
    assert stt.extract_batch(res.stego.cpu().numpy(), master_key=bytes(32),
                             params=p, device="cpu") == secrets


def test_complex128_round_trip_stays_on_card(dev):
    """Params(fft_dtype="complex128") on a card tensor runs in f64 on the
    card (a complex128 spectrum there, cuFFT's Z2Z), round-trips at 1080p,
    and its stego is within +-1 of the CPU port's f64 host backend's and
    read back by it."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.pipeline import device as device_mod

    cover = _photo_like(1080, 1920, 36)[0]
    secret = bytes(np.random.default_rng(37).integers(0, 256, 4096,
                                                      dtype=np.uint8))
    p = stt.Params(pbkdf2_iter=500, fft_dtype="complex128")
    cover_d = torch.from_numpy(cover).to(dev)
    be, src, _, _ = device_mod.backend_input(cover_d, p)
    assert isinstance(be, device_mod.TorchBackend)
    spec = be.analyze(spectral.to_planes(src), p, lazy=True)[0]
    assert spec.device.type == "cuda" and spec.dtype == torch.complex128
    res = stt.embed_array(cover_d, secret, password="pw", params=p,
                          salt=bytes(16))
    assert res.stego.device.type == "cuda"
    assert stt.extract_array(res.stego, password="pw", params=p) == secret
    card = res.stego.cpu().numpy()
    cpu = stt.embed_array(cover, secret, password="pw", params=p,
                          salt=bytes(16), device="cpu").stego
    assert np.abs(card.astype(np.int16) - cpu.astype(np.int16)).max() <= 1
    assert stt.extract_array(card, password="pw", params=p,
                             device="cpu") == secret


def _scripted(reqs, counts):
    """serve_loop's stdin for [(name, request)]: each request's line, with
    every K1 count set to 0 just before it; the counts after each request
    land in counts[name] (read when the loop asks for the next line)."""
    import json

    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    prev = None
    for name, req in reqs:
        if prev is not None:
            counts[prev] = dict(ck.LAUNCHES)
        for k in ck.LAUNCHES:
            ck.LAUNCHES[k] = 0
        prev = name
        yield json.dumps(req) + "\n"
    if prev is not None:
        counts[prev] = dict(ck.LAUNCHES)


def _pngs(tmp_path, n, hw=(512, 512), seed=1):
    from steganosaurus_tpu_torch.io import image as image_io

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = np.clip(np.linspace(120, 200, hw[1])[None, :, None]
                      + rng.integers(-20, 21, (*hw, 3)), 0,
                      255).astype(np.uint8)
        paths.append(str(tmp_path / f"c{i}.png"))
        image_io.save_png(paths[-1], img)
    return paths


def test_serve_loop_on_card_launches_k1_per_op(dev, tmp_path):
    """The worker on the card at 512x512: embed (embed_batch at B=1),
    extract (the hinted extract_batch), embed_batch and extract_batch of 3
    images read every secret back, and each op launches K1."""
    import base64
    import io
    import json

    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.pipeline.serve import serve_loop

    covers = _pngs(tmp_path, 3)
    outs = [str(tmp_path / f"s{i}.png") for i in range(3)]
    reqs = [("embed", {"op": "embed", "in": covers[0], "out": outs[0],
                       "secret": "card serve"}),
            ("extract", {"op": "extract", "in": outs[0]}),
            ("embed_batch", {"op": "embed_batch", "jobs": [
                {"in": c, "out": o, "secret": f"job {i}"}
                for i, (c, o) in enumerate(zip(covers, outs))]}),
            ("extract_batch", {"op": "extract_batch", "ins": outs})]
    counts: dict = {}
    stdout = io.StringIO()
    rc = serve_loop(None, bytes(range(32)), Params(pbkdf2_iter=500),
                    stdin=_scripted(reqs, counts), stdout=stdout,
                    warmup=[(512, 512, 10)])
    assert rc == 0
    rs = [json.loads(x) for x in stdout.getvalue().splitlines()]
    assert rs[0]["op"] == "ready" and rs[0]["warmed"] == ["512x512:10"]
    assert all(r["ok"] for r in rs[1:]), rs
    assert base64.b64decode(rs[2]["secret_b64"]) == b"card serve"
    assert [base64.b64decode(r["secret_b64"]).decode()
            for r in rs[4]["results"]] == [f"job {i}" for i in range(3)]
    for name, n in counts.items():
        assert sum(n.values()) > 0, (name, counts)


def test_cli_embed_extract_on_card(dev, tmp_path, monkeypatch, capsys):
    """The CLI with STEGANOSAURUS_PLATFORM unset runs on the card: a 512x512
    embed -> extract round trip that allocates device memory (the
    single-image path: torch.fft, no K1)."""
    from steganosaurus_tpu_torch import cli

    monkeypatch.delenv("STEGANOSAURUS_PLATFORM", raising=False)
    cover = _pngs(tmp_path, 1, seed=2)[0]
    stego = str(tmp_path / "s.png")
    torch.cuda.reset_peak_memory_stats()
    assert cli.main(["turtlefft", "embed", "--in", cover, "--out", stego,
                     "--secret", "on the card", "--pass", "pw",
                     "--pbkdf2_iter", "500"]) == 0
    assert torch.cuda.max_memory_allocated() > 0
    assert cli.main(["turtlefft", "extract", "--in", stego, "--pass", "pw",
                     "--pbkdf2_iter", "500"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "on the card"


def test_mesh_round_trip_on_card_matches_unsharded(dev):
    """A 2-shard logical mesh on the card: 4/4 back, the stego within +-1
    of the unsharded call's on at most 0.5% of bytes (stage 2's GEMMs see
    other batch counts), K1 launched once per shard per pass."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import parallel
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.integers(90, 170, (4, 3, 512, 512),
                                         dtype=np.uint8)).to(dev)
    secrets = [bytes([i]) * (48 + i) for i in range(4)]
    salts = [bytes([i + 1]) * 16 for i in range(4)]
    mk = bytes(range(32))
    mesh = parallel.make_mesh(2, device="cuda:0")
    ref = stt.embed_batch(imgs, secrets, master_key=mk, salts=salts,
                          device_resident=True, layout="nchw")
    n = dict(ck.LAUNCHES)
    res = stt.embed_batch(imgs, secrets, master_key=mk, salts=salts,
                          mesh=mesh, device_resident=True, layout="nchw")
    got = stt.extract_batch(res.stego, master_key=mk, clen_hint=51,
                            layout="nchw")
    torch.cuda.synchronize()
    assert got == secrets
    assert ck.LAUNCHES[ck.KERNEL_TMA] == n[ck.KERNEL_TMA] + 4
    assert [p.device for p in res.stego.parts] == [dev, dev]
    diff = (res.stego.gather(dev).to(torch.int16)
            - ref.stego.to(torch.int16)).abs()
    assert diff.max().item() <= 1
    assert diff.count_nonzero().item() <= 0.005 * diff.numel()
    assert stt.extract_batch(np.asarray(res.stego), master_key=mk,
                             layout="nchw", device=dev) == secrets


def test_fft_dist_on_card_matches_dense(dev):
    from steganosaurus_tpu_torch import parallel, spectral
    from steganosaurus_tpu_torch.parallel import fft_dist

    rng = np.random.default_rng(10)
    planes = torch.from_numpy(rng.uniform(0, 255, (3, 256, 512)).astype(
        np.float32)).to(dev)
    mesh = parallel.make_mesh(4, axis="image", device=dev)
    spec = fft_dist.fft2_distributed(planes, mesh)
    dense = spectral.fft2(planes)
    got = spec.gather(dev)
    assert (got - dense).abs().max().item() <= REL * dense.abs().max().item()
    med = fft_dist.median_abs_distributed(spec, mesh)
    assert torch.equal(med, spectral.median_abs(got))
    back = fft_dist.ifft2_real_distributed(spec, mesh).gather(dev)
    assert (back - planes).abs().max().item() <= 5e-3


def test_graft_entry_on_card(dev):
    """The graft entry on the card: entry()'s step (random bins, each one
    named twice carrying its last bit) within +-1 of the CPU's on at most
    0.5% of the bytes; the dry run over 2 logical shards of the card, K1,
    both K3 entry points and K4 launched."""
    from steganosaurus_tpu_torch import graft_entry
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    fn, args = graft_entry.entry()
    assert args[0].device.type == "cuda"
    out = fn(*args).cpu().numpy().astype(np.int16)
    fn, args = graft_entry.entry(device="cpu")
    diff = out - fn(*args).numpy().astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 5e-3 * diff.size
    k1, k3 = dict(ck.LAUNCHES), dict(wk.LAUNCHES)
    report = graft_entry.dryrun_multichip(2, device=dev)
    assert report["flips"] <= 2
    assert ck.LAUNCHES[ck.KERNEL_TMA] > k1[ck.KERNEL_TMA]
    for k in (wk.KERNEL_WRITE_FLOOR, wk.KERNEL_FLOOR_ONLY,
              wk.KERNEL_IFFT_EPILOGUE):
        assert wk.LAUNCHES[k] > k3[k], k


def test_peak_rates_for_the_card(dev):
    from steganosaurus_tpu_torch.utils import cost

    name = torch.cuda.get_device_name(0)
    if "H100 80GB HBM3" not in name:
        with pytest.raises(ValueError):
            cost.peak_rates(dev)
        return
    peaks = cost.peak_rates(dev)
    assert peaks["name"] == name
    assert (peaks["bf16"], peaks["tf32"], peaks["fp32"],
            peaks["hbm_bytes"]) == (989e12, 495e12, 67e12, 3.35e12)


# --- the embed's write, write floor (K3) and u8 epilogue (K4e) ---------------

WRITE_GRIDS = [(8, 512, 512), (4, 1079, 1917)]   # (B, H, W): 512^2, 4b


def _write_inputs(dev, B, H, W, seed):
    """K3's inputs at the corner of an H x W grid, from a seed: a spectrum
    (B, 3, Ky, Kx) whose first image is weak (the floor boosts it), the
    static maps of a tail-padded walk over 30% of the corner's bins
    (corner_statics_core: pos, jitter, amplitude, QIM maps) and frame bits
    (B, bucket) u8."""
    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner

    Ky, Kx = corner.corner_dims(H, W, Params().rmax)
    N = 3 * Ky * Kx
    rng = np.random.default_rng(seed)
    spec = (rng.normal(size=(2, B, 3, Ky, Kx)) * 1e4).astype(np.float32)
    spec[:, 0] *= 1e-3
    cr, ci = (torch.from_numpy(s).to(dev) for s in spec)
    nbits = int(0.3 * N)
    bucket = -(-nbits // 4096) * 4096
    flat = rng.choice(N, bucket, replace=False)
    flat[nbits:] = flat[nbits - 1]
    plane, y, x = (torch.from_numpy(a).to(dev)
                   for a in np.unravel_index(flat, (3, Ky, Kx)))

    def per_slot(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, bucket).astype(
            np.float32)).to(dev)

    maps = pb.corner_statics_core(plane, y, x, Ky, Kx, bucket,
                                  per_slot(-0.3, 0.3),
                                  alphas=per_slot(0.3, 0.7),
                                  dither=per_slot(-3.0, 3.0))
    frame = torch.from_numpy(rng.integers(0, 2, (B, bucket),
                                          dtype=np.uint8)).to(dev)
    return cr, ci, maps, frame


def _check_write(out, ref, ordered):
    """K3 against its plain versions: bit-equal to the ordered twin
    (`ordered`: the floor's sums in the kernel's order), boost included;
    against the eager one (`ref`, torch.sum) b within 1e-5 relative, each
    image whose boost is 1 (every image without a floor) bit-equal, the
    rest within 1e-5 of the plain output's scale."""
    torch.cuda.synchronize()
    for got, want in zip(out, ordered):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(_bits(got), _bits(want))
    (dr, di, b), (pr, pi, pb) = out, ref
    if pb is None:
        assert b is None
        exact = [True] * dr.shape[0]
    else:
        assert ((b - pb).abs() <= REL * pb).all()
        exact = ((b == 1) & (pb == 1)).tolist()
    for k, ex in enumerate(exact):
        if ex:
            assert torch.equal(dr[k], pr[k]) and torch.equal(di[k], pi[k])
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (dr - pr).abs().max().item() <= REL * scale
    assert (di - pi).abs().max().item() <= REL * scale


def _boosting_floor(dr, di, pixels):
    """Twice the largest spatial RMS that the writes (dr, di) reach by
    themselves, sqrt(2/3 * sum |0.5 D / pixels|^2) per image (Parseval, as
    apply_write_floor): a floor that boosts every image."""
    h2 = ((0.5 / pixels) * dr) ** 2 + ((0.5 / pixels) * di) ** 2
    return 2.0 * float(torch.sqrt(h2.flatten(1).sum(1) * (2.0 / 3.0)).max())


@pytest.mark.parametrize("grid", WRITE_GRIDS)
@pytest.mark.parametrize("mode,floor", [
    ("hard", "0"), ("hard", "0.45"), ("soft+jitter", "boost"),
    ("spread", "0.45"), ("spread+jitter+soft", "clip")])
def test_write_floor_kernel_matches_plain(dev, grid, mode, floor):
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    B, H, W = grid
    cr, ci, maps, frame = _write_inputs(dev, B, H, W, sum(grid))
    pos, cjd, sjd, cad, sad, _, _ = maps
    if "jitter" not in mode:
        cjd = sjd = None
    ca, sa = (cad, sad) if "spread" in mode else pb._cos_sin(0.5)
    args = (cr, ci, pos, frame, ca, sa, cjd, sjd)
    kw = dict(img_pixels=float(H * W), soft="soft" in mode)
    fl = {"0": 0.0, "0.45": 0.45, "clip": 1e6}.get(floor)
    if fl is None:
        fl = _boosting_floor(*wk.write_floor_plain(*args, floor=0.0,
                                                   **kw)[:2], H * W)
    n = dict(wk.LAUNCHES)
    out = wk.write_floor(*args, floor=fl, **kw)
    assert wk.LAUNCHES == {**n, wk.KERNEL_WRITE_FLOOR:
                           n[wk.KERNEL_WRITE_FLOOR] + 1}
    _check_write(out, wk.write_floor_plain(*args, floor=fl, **kw),
                 wk.write_floor_plain(*args, floor=fl, ordered=True, **kw))
    if floor == "boost":
        assert (out[2] > 1).all()
    elif floor == "clip":
        assert (out[2] == 32).all()


def _bits(t):
    """A tensor's bit patterns, for bit-for-bit comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("grid", WRITE_GRIDS)
@pytest.mark.parametrize("mode,floor", [("hard", "0.45"),
                                        ("soft+jitter", "boost"),
                                        ("spread", "clip")])
def test_write_floor_operands_and_schedules_agree(dev, grid, mode, floor):
    """write_floor's bf16 operand mode equals its f32 output cast as the
    inverse DFT casts it (bf16(dr), bf16(-di)), bit for bit, with the same
    boost; the resident schedule (taken by itself here) and the forced
    two-pass schedule give the same bits in both modes: the same sums in
    the same order."""
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    B, H, W = grid
    cr, ci, maps, frame = _write_inputs(dev, B, H, W, sum(grid) + 7)
    pos, cjd, sjd, cad, sad, _, _ = maps
    if "jitter" not in mode:
        cjd = sjd = None
    ca, sa = (cad, sad) if "spread" in mode else pb._cos_sin(0.5)
    args = (cr, ci, pos, frame, ca, sa, cjd, sjd)
    kw = dict(img_pixels=float(H * W), soft="soft" in mode)
    fl = {"0.45": 0.45, "clip": 1e6}.get(floor)
    if fl is None:
        fl = _boosting_floor(*wk.write_floor_plain(*args, floor=0.0,
                                                   **kw)[:2], H * W)
    n = dict(wk.LAUNCHES)
    f32 = wk.write_floor(*args, floor=fl, **kw)
    b16 = wk.write_floor(*args, floor=fl, **kw, ifft_operands=True)
    assert wk.LAUNCHES == {**n, wk.KERNEL_WRITE_FLOOR:
                           n[wk.KERNEL_WRITE_FLOOR] + 2}
    want = wk.ifft_operands_of(f32[0], f32[1])
    torch.cuda.synchronize()
    assert b16[0].dtype == torch.bfloat16 and b16[0].shape == cr.shape
    for got, w in zip(b16[:2], want):
        assert torch.equal(_bits(got), _bits(w))
    assert torch.equal(b16[2], f32[2])
    for ops, ref in ((False, f32), (True, b16)):
        two = wk._write_floor(*args, floor=fl, **kw, ifft_operands=ops,
                              schedule="two_pass")
        torch.cuda.synchronize()
        for got, w in zip(two, ref):
            assert torch.equal(_bits(got), _bits(w))
    assert wk.LAUNCHES[wk.KERNEL_WRITE_FLOOR_TWO_PASS] == \
        n[wk.KERNEL_WRITE_FLOOR_TWO_PASS] + 2


def test_write_floor_boost_does_not_depend_on_b(dev):
    """One image alone (B=1) and at other rows of batches of 3 and 8 gets
    the same boost and the same output, bit for bit, on both schedules:
    each sum's order is fixed by the corner and the block size alone."""
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    cr, ci, maps, frame = _write_inputs(dev, 8, 512, 512, 77)
    fl = _boosting_floor(*wk.write_floor_plain(
        cr, ci, maps[0], frame, *pb._cos_sin(0.5), floor=0.0,
        img_pixels=512.0 * 512.0)[:2], 512 * 512)
    outs = []
    for nb, row in ((1, 0), (3, 2), (8, 5)):
        idx = [(k + 3) % 8 for k in range(nb)]
        idx[row] = 0
        sel = torch.tensor(idx, device=dev)
        args = (cr[sel].contiguous(), ci[sel].contiguous(), maps[0],
                frame[sel].contiguous(), *pb._cos_sin(0.5))
        for schedule in wk.SCHEDULES:
            dr, di, b = wk._write_floor(*args, floor=fl,
                                        img_pixels=512.0 * 512.0,
                                        ifft_operands=True,
                                        schedule=schedule)
            outs.append((dr[row], di[row], b[row]))
    torch.cuda.synchronize()
    assert outs[0][2].item() > 1.0
    for o in outs[1:]:
        assert all(torch.equal(_bits(g), _bits(w))
                   for g, w in zip(o, outs[0]))


@pytest.mark.parametrize("grid", WRITE_GRIDS)
@pytest.mark.parametrize("floor", ["0.45", "boost"])
def test_floor_only_kernel_matches_plain(dev, grid, floor):
    """The floor over the eager QIM write, kernel against plain (bit-equal
    to the ordered twin)."""
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    B, H, W = grid
    cr, ci, maps, frame = _write_inputs(dev, B, H, W, sum(grid) + 1)
    pos, cjd, sjd, _, _, dq, qm = maps
    sign, mask = wk.bit_signs(pos, frame)
    ca, sa = pb._cos_sin(0.5)
    dr, di = corner.write_delta_qim(cr, ci, sign, mask, qm, ca, sa, dq, 3,
                                    cjd, sjd)
    fl = 0.45 if floor == "0.45" else _boosting_floor(dr, di, H * W)
    kw = dict(floor=fl, img_pixels=float(H * W))
    n = wk.LAUNCHES[wk.KERNEL_FLOOR_ONLY]
    out = wk.floor_only(dr, di, cr, ci, **kw)
    assert wk.LAUNCHES[wk.KERNEL_FLOOR_ONLY] == n + 1
    _check_write(out, wk.floor_only_plain(dr, di, cr, ci, **kw),
                 wk.floor_only_plain(dr, di, cr, ci, ordered=True, **kw))
    assert (out[2] > 1).all() if floor == "boost" else (out[2] > 1).any()


@pytest.mark.parametrize("grid", WRITE_GRIDS)
@pytest.mark.parametrize("center,layout", [(False, "nchw"), (True, "nchw"),
                                           (False, "nhwc"), (True, "nhwc")])
def test_epilogue_kernel_is_bit_exact(dev, grid, center, layout):
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    B, H, W = grid
    rng = np.random.default_rng(sum(grid) + 2 * center)
    t = torch.from_numpy((rng.normal(size=(B, 3, H, W)) * 3.0 * H * W)
                         .astype(np.float32)).to(dev)
    planes = torch.from_numpy(rng.integers(0, 256, (B, 3, H, W),
                                           dtype=np.uint8)).to(dev)
    n = wk.LAUNCHES[wk.KERNEL_EPILOGUE]
    got = wk.epilogue(t, planes, center, layout)
    want = wk.epilogue_plain(t, planes, center, layout)
    torch.cuda.synchronize()
    assert wk.LAUNCHES[wk.KERNEL_EPILOGUE] == n + 1
    assert got.shape == want.shape and torch.equal(got, want)


# K4: the inverse DFT's x-stage with the u8 epilogue, on (B, H, W): 4K-like
# (one image: 3 planes of 2160 x 3840, Kx = 1024), its 3839 crop, 1080p,
# 512^2, 256^2 B=1, the 4b grid, a phone screenshot's width (W % 16 == 4:
# the NHWC rows' 4-byte stores), and a tiny odd grid whose Kx = 203 rows
# take the wrapper's padded copy
K4_GRIDS = [(1, 2160, 3840), (1, 2160, 3839), (2, 1080, 1920), (2, 512, 512),
            (1, 256, 256), (2, 1079, 1917), (1, 270, 2532), (1, 67, 203)]
# max |v - v_plain| against max |v_plain|: f32 sums of the same exact bf16
# products in another order (K1's bound)
K4_REL = 1e-5


def _k4_inputs(dev, B, H, W, seed):
    """The y-stage's bf16 output for a seeded corner delta over 30% of the
    corner's bins, scaled so that the image-plane write has an RMS of about
    3 (a stego's), the grid's tables and u8 cover planes with both clamp
    ends present."""
    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.spectral import corner

    Ky, Kx = corner.corner_dims(H, W, Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    rng = np.random.default_rng(seed)
    mask = rng.random((3, Ky, Kx)) < 0.3
    amp = 3.0 * H * W / np.sqrt(0.6 * Ky * Kx)
    dr, di = (torch.from_numpy((rng.normal(size=(B, 3, Ky, Kx)) * amp
                                * mask).astype(np.float32)).to(dev)
              for _ in range(2))
    mr16, mi16 = corner.ifft_corner_y(dr, di, tabs)
    planes = rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)
    planes[0, 0, :2] = 0
    planes[0, 1, :2] = 255
    return mr16, mi16, tabs, torch.from_numpy(planes).to(dev)


def _check_k4(mr16, mi16, tabs, planes, center, layout):
    """K4 against its plain version: the f32 check mode within K4_REL of
    the plain values' scale; the u8 stego equal but for bytes one apart,
    each where the plain value lies within that bound of a .5 boundary."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    args = (mr16, mi16, tabs, planes, center, layout)
    n = wk.LAUNCHES[wk.KERNEL_IFFT_EPILOGUE]
    v = wk.ifft_epilogue(*args, values=True)
    got = wk.ifft_epilogue(*args)
    assert wk.LAUNCHES[wk.KERNEL_IFFT_EPILOGUE] == n + 2
    pv = wk.ifft_epilogue_plain(*args, values=True)
    want = wk.ifft_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert v.shape == pv.shape and got.shape == want.shape
    assert got.dtype == torch.uint8 and v.dtype == torch.float32
    tol = K4_REL * pv.abs().max().item()
    assert (v - pv).abs().max().item() <= tol
    diff = got.to(torch.int16) - want.to(torch.int16)
    off = diff != 0
    assert diff.abs().max().item() <= 1
    if layout == "nhwc":
        off = off.permute(0, 3, 1, 2)
    y = pv.double() + planes.double() + 0.5
    assert ((y - y.round()).abs()[off] <= tol).all()


@pytest.mark.parametrize("grid", K4_GRIDS)
@pytest.mark.parametrize("center,layout", [(False, "nchw"), (True, "nchw"),
                                           (False, "nhwc"), (True, "nhwc")])
def test_ifft_epilogue_kernel_matches_plain(dev, grid, center, layout):
    _check_k4(*_k4_inputs(dev, *grid, sum(grid) + center), center, layout)


def test_ifft_epilogue_kernel_on_unaligned_views(dev):
    """Operands and covers that start one element into a larger tensor (2
    and 1 bytes off their alignment): the wrapper's aligned copy of the
    operands and the kernel's byte loads of the covers give the same
    answer."""
    mr16, mi16, tabs, planes = _k4_inputs(dev, 1, 128, 192, 9)

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    views = [shifted(t) for t in (mr16, mi16, planes)]
    assert views[0].data_ptr() % 16 and views[2].data_ptr() % 4
    _check_k4(views[0], views[1], tabs, views[2], True, "nchw")


@pytest.mark.parametrize("grid", K4_GRIDS)
def test_ifft_epilogue_bit_equal_to_its_first_version(dev, grid):
    """The staging, the store warp and the cover by TMA move data only:
    K4's u8 stego (NCHW and NHWC, centering off and on) and its f32 check
    mode equal those of the kernel before them, bit for bit, on the same
    operands (3839 and the phone width take the plain stores, the others
    the TMA path)."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    first = _first_version("corner_ifft_epilogue.cu")
    mr16, mi16, tabs, planes = _k4_inputs(dev, *grid, 3 * sum(grid))
    for center in (False, True):
        for layout, values in (("nchw", False), ("nhwc", False),
                               ("nchw", True)):
            def run():
                return wk.ifft_epilogue(mr16, mi16, tabs, planes, center,
                                        layout, values=values)
            got = run()
            want = _with_kernels(first, run)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (center, layout, values)


def test_ifft_epilogue_wrapper_checks_its_inputs(dev):
    """Wrong types, shapes, layouts and devices raise before any launch."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    mr16, mi16, tabs, planes = _k4_inputs(dev, 1, 64, 64, 3)
    n = dict(wk.LAUNCHES)
    for bad in ((mr16.float(), mi16, tabs, planes),
                (mr16, mi16[:-1], tabs, planes),
                (mr16, mi16, tabs, planes.float()),
                (mr16, mi16.cpu(), tabs, planes),
                (mr16.t(), mi16, tabs, planes)):
        with pytest.raises(ValueError):
            wk.ifft_epilogue(*bad, False, "nchw")
    with pytest.raises(ValueError):
        wk.ifft_epilogue(mr16, mi16, tabs, planes, False, "hwc")
    with pytest.raises(ValueError):
        wk.ifft_epilogue(mr16, mi16, tabs._replace(ifft_x=None), planes,
                         False, "nchw")
    assert wk.LAUNCHES == n
    # the launch's grid: 2-CTA clusters, no more blocks than the card has
    # SMs, one cluster for one pair of row blocks
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = wk.ifft_epilogue_grid(64, 2160, 3840, "nchw")
    assert grid % 2 == 0 and 0 < grid <= sms
    assert wk.ifft_epilogue_grid(1, 64, 64, "nhwc") == 2
    with pytest.raises(ValueError):
        wk.ifft_epilogue_grid(1, 64, 64, "hwc")


# K6: the inverse DFT's y-stage, on (B, H, W): 4K-like (one image: 3 planes,
# Ky = Kx = 1024), 1080p, 512^2, and a tiny grid whose Kx = 50 (not a
# multiple of 8) takes the wrapper's padded staging copy
# odd 2Hp/128 (a 128-row tile across the mr / mi split): 1080, 1170, 64
K6_GRIDS = [(1, 2160, 3840), (2, 1080, 1920), (2, 512, 512), (2, 64, 50),
            (1, 1170, 2532)]
# max |v - v_plain| against max |v_plain|: f32 sums of the same exact bf16
# products in another order (K1's and K4's bound)
K6_REL = 1e-5


def _k6_inputs(dev, B, H, W, seed):
    """K3's bf16 operands (bf16(Re D), bf16(-Im D)) of a seeded corner
    delta over 30% of the corner's bins, and the grid's tables."""
    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    Ky, Kx = corner.corner_dims(H, W, Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, dev)
    rng = np.random.default_rng(seed)
    mask = rng.random((3, Ky, Kx)) < 0.3
    amp = 3.0 * H * W / np.sqrt(0.6 * Ky * Kx)
    dr, di = (torch.from_numpy((rng.normal(size=(B, 3, Ky, Kx)) * amp
                                * mask).astype(np.float32)).to(dev)
              for _ in range(2))
    return (*wk.ifft_operands_of(dr, di), tabs)


def _check_k6(dcr, dci, tabs, padded):
    """K6 against its plain version: the f32 check mode within K6_REL of
    the plain sums' scale; its bf16 outputs the round-to-nearest-even casts
    of those sums; against the plain bf16, each element equal, one bf16 ulp
    apart, or, where an ulp is below that bound, within the bound and one
    ulp (write_kernels.bf16_compare). `padded`: whether the launches take
    the staging copy."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    n = dict(wk.LAUNCHES)
    v = wk.ifft_y(dcr, dci, tabs, values=True)
    got = wk.ifft_y(dcr, dci, tabs)
    assert wk.LAUNCHES[wk.KERNEL_IFFT_Y] == n[wk.KERNEL_IFFT_Y] + 2
    assert (wk.LAUNCHES[wk.KERNEL_IFFT_Y_PADDED]
            == n[wk.KERNEL_IFFT_Y_PADDED] + 2 * padded)
    pv = wk.ifft_y_plain(dcr, dci, tabs, values=True)
    want = wk.ifft_y_plain(dcr, dci, tabs)
    torch.cuda.synchronize()
    tol = K6_REL * max(p.abs().max().item() for p in pv)
    for k, kv, p, pw in zip(got, v, pv, want):
        assert k.shape == p.shape == kv.shape == pw.shape
        assert k.dtype == torch.bfloat16 and kv.dtype == torch.float32
        assert (kv - p).abs().max().item() <= tol
        assert torch.equal(k, kv.to(torch.bfloat16))
        assert wk.bf16_compare(k, pw, p, tol)["other"] == 0


@pytest.mark.parametrize("grid", K6_GRIDS)
def test_ifft_y_kernel_matches_plain(dev, grid):
    _check_k6(*_k6_inputs(dev, *grid, sum(grid)), padded=grid[2] == 50)


@functools.lru_cache(maxsize=None)
def _parent_tool():
    """tools/parent_kernels_torch.py as a module."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "parent_kernels_torch.py")
    spec = importlib.util.spec_from_file_location("parent_kernels_torch",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@functools.lru_cache(maxsize=None)
def _first_version(name, rev=None):
    """Kernels whose entry points of csrc/`name` are those of commit `rev`
    (default: the one tools/parent_kernels_torch.py names BITS_OF, the
    version before the redesigns), the rest the committed build; skips
    where its source cannot be had (no git history and no copy under
    build/parents/)."""
    tool = _parent_tool()
    rev = rev or tool.BITS_OF
    built = tool.parent_kernels(rev, name)
    if built is None:
        pytest.skip(f"no {name} of {rev}: run python3 "
                    f"tools/parent_kernels_torch.py {rev} {name} where "
                    f"the checkout has its history")
    return built[0]


# the parent of the run-time band width: its K2 took one band group
K2_PARENT = "4f717a6"


def _old_k2(kernels, ar16, ai16, idx, tabs, band):
    """K2 of a build from before the run-time band width (one group of 64
    columns and the bulk, always), bound with its own signature
    (parent_kernels_torch.OLD_SIGNATURES): (cr, ci)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    entry = _parent_tool().old_entry(kernels.paths["corner_stage2"],
                                     "corner_stage2")
    P, H, X = ar16.shape
    Ky = tabs.eyr.shape[0]
    t2 = tabs.stage2
    ar16, ai16 = ck._tma_rows(ar16), ck._tma_rows(ai16)
    cr, ci = (torch.empty((P, Ky, X), dtype=torch.float32,
                          device=ar16.device) for _ in range(2))
    rc = entry(t2.data_ptr(), ar16.data_ptr(), ai16.data_ptr(),
               band[0].data_ptr(), band[1].data_ptr(), idx.data_ptr(),
               cr.data_ptr(), ci.data_ptr(), P, H, X, Ky, t2.shape[1] // 2,
               t2.shape[2] // 2, ar16.stride(1), ai16.stride(1),
               torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return cr, ci


def _with_kernels(kernels, fn):
    from steganosaurus_tpu_torch import _build

    base = _build.kernel_library()
    _build._kernels = kernels
    try:
        return fn()
    finally:
        _build._kernels = base


@pytest.mark.parametrize("grid", K6_GRIDS)
def test_ifft_y_bit_equal_to_its_first_version(dev, grid):
    """The staged stores move data only: K6's bf16 outputs and its f32
    check mode equal those of the kernel before them, bit for bit, on the
    same operands (odd 2Hp/128 included)."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    first = _first_version("corner_ifft_y.cu")
    dcr, dci, tabs = _k6_inputs(dev, *grid, 2 * sum(grid))
    for values in (False, True):
        got = wk.ifft_y(dcr, dci, tabs, values=values)
        want = _with_kernels(first, lambda: wk.ifft_y(dcr, dci, tabs,
                                                      values=values))
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ifft_y_refused_launch_raises(dev, monkeypatch):
    """A shape the kernel refuses (here operand rows that are not whole
    16-byte words) comes back from the C entry as its error code and raises
    in the wrapper: nothing else stands in, nothing is counted."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    dcr, dci, tabs = _k6_inputs(dev, 1, 128, 192, 4)
    rows = wk.ifft_y_rows
    monkeypatch.setattr(wk, "ifft_y_rows", lambda a, b: (
        *rows(a, b)[:2], a.shape[-1] + 1, False))
    n = dict(wk.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        wk.ifft_y(dcr, dci, tabs)
    assert wk.LAUNCHES == n


def test_ifft_y_kernel_on_unaligned_views(dev):
    """Operands that start one element into a larger tensor (2 bytes off
    their alignment) go through the staging copy and give the same
    answer."""
    dcr, dci, tabs = _k6_inputs(dev, 1, 128, 192, 9)

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    views = [shifted(t) for t in (dcr, dci)]
    assert views[0].data_ptr() % 16
    _check_k6(*views, tabs, padded=True)


def test_ifft_y_wrapper_checks_its_inputs(dev):
    """Wrong types, shapes, layouts, devices and tables raise before any
    launch."""
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    dcr, dci, tabs = _k6_inputs(dev, 1, 64, 64, 3)
    n = dict(wk.LAUNCHES)
    for bad in ((dcr.float(), dci, tabs), (dcr, dci[..., :-1], tabs),
                (dcr, dci.cpu(), tabs), (dcr.transpose(-1, -2), dci, tabs),
                (dcr, dci, tabs._replace(ifft_y=None)),
                (dcr, dci, tabs._replace(ifft_y=tabs.ifft_y[:-64]))):
        with pytest.raises(ValueError):
            wk.ifft_y(*bad)
    assert wk.LAUNCHES == n


def test_write_wrappers_check_their_inputs(dev):
    """Non-contiguous or wrongly typed inputs raise before any launch."""
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    cr, ci, maps, frame = _write_inputs(dev, 2, 256, 256, 5)
    pos = maps[0]
    ca, sa = pb._cos_sin(0.5)
    kw = dict(floor=0.45, img_pixels=256.0 * 256.0)
    n = dict(wk.LAUNCHES)
    with pytest.raises(ValueError):       # non-contiguous spectrum
        wk.write_floor(cr.transpose(-1, -2), ci, pos, frame, ca, sa, **kw)
    with pytest.raises(ValueError):       # an int64 slot map
        wk.write_floor(cr, ci, pos.long(), frame, ca, sa, **kw)
    with pytest.raises(ValueError):       # frame bits of another type
        wk.write_floor(cr, ci, pos, frame.float(), ca, sa, **kw)
    with pytest.raises(ValueError):       # a map on the CPU
        wk.write_floor(cr, ci, pos, frame, ca, sa, maps[1].cpu(), maps[2],
                       **kw)
    with pytest.raises(ValueError):
        wk.floor_only(cr.double(), ci, cr, ci, **kw)
    t = torch.zeros((2, 3, 64, 64), device=dev)
    p8 = torch.zeros((2, 3, 64, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        wk.epilogue(t.transpose(-1, -2), p8, False, "nchw")
    with pytest.raises(ValueError):
        wk.epilogue(t, p8.float(), False, "nchw")
    assert wk.LAUNCHES == n


def test_embed_cores_on_card_launch_k3_and_k4e(dev, monkeypatch):
    """A default-Params embed makes one write_floor launch, on the resident
    schedule, one K6 launch (the y-stage, no staging copy) and one K4
    launch; QIM and per-image walks take floor_only; under
    STEGANOSAURUS_MM_PRECISION=highest the epilogue is K4e's, after the f32
    inverse DFT (no K6); the stegos read back."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    rng = np.random.default_rng(13)
    imgs = torch.from_numpy(rng.integers(90, 170, (2, 3, 256, 256),
                                         dtype=np.uint8)).to(dev)
    secrets = [b"k3-0" * 8, b"k3-1" * 8]
    two = {wk.KERNEL_WRITE_FLOOR_TWO_PASS: 0, wk.KERNEL_IFFT_Y_PADDED: 0}
    k4 = {wk.KERNEL_EPILOGUE: 0, wk.KERNEL_IFFT_EPILOGUE: 1,
          wk.KERNEL_IFFT_Y: 1}
    for p, want, mode in (
            (stt.Params(pbkdf2_iter=500),
             {wk.KERNEL_WRITE_FLOOR: 1, wk.KERNEL_FLOOR_ONLY: 0, **k4,
              **two}, "mix_adaptive"),
            (stt.Params(qim=3, pbkdf2_iter=500),
             {wk.KERNEL_WRITE_FLOOR: 0, wk.KERNEL_FLOOR_ONLY: 1, **k4,
              **two}, "mix_adaptive"),
            (stt.Params(per_image_walk=True, pbkdf2_iter=500),
             {wk.KERNEL_WRITE_FLOOR: 0, wk.KERNEL_FLOOR_ONLY: 1, **k4,
              **two}, "mix_adaptive"),
            (stt.Params(pbkdf2_iter=500),
             {wk.KERNEL_WRITE_FLOOR: 1, wk.KERNEL_FLOOR_ONLY: 0,
              wk.KERNEL_EPILOGUE: 1, wk.KERNEL_IFFT_EPILOGUE: 0,
              wk.KERNEL_IFFT_Y: 0, **two}, "highest")):
        monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
        n = dict(wk.LAUNCHES)
        res = stt.embed_batch(imgs, secrets, master_key=bytes(32), params=p,
                              device_resident=True, layout="nchw")
        torch.cuda.synchronize()
        assert {k: wk.LAUNCHES[k] - n[k] for k in n} == want
        assert stt.extract_batch(res.stego, master_key=bytes(32), params=p,
                                 layout="nchw") == secrets


# --- forward stage 2: the prep pass and K2 (csrc/corner_stage2.cu) ---------

def _stage1_like(dev, P, h, x, seed, scale=1e5):
    """Stage-1-like f32 operands with a few strong columns (the band)."""
    rng = np.random.default_rng(seed)
    col = np.exp(rng.normal(0.0, 2.0, (P, 1, x)))
    return tuple(torch.from_numpy((rng.normal(size=(P, h, x)) * col * scale)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _stage1_of_images(dev, P, h, x, seed):
    """The stage-1 output (P, h, x) of P seeded gradient + noise image
    planes (the bench covers' recipe) by fwd_stage1_plain: the operands K2
    takes on the main path, with their DC column."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    rng = np.random.default_rng(seed)
    w = max(x, 96)
    base = np.linspace(150, 235, w)
    imgs = np.clip(base[None, None, :] + rng.integers(-18, 19, (P, h, w)),
                   0, 255).astype(np.uint8)
    exr, exi = (torch.from_numpy(t).to(dev).to(torch.bfloat16)
                for t in corner._dft_tables(w, x))
    return ck.fwd_stage1_plain(torch.from_numpy(imgs).to(dev), exr, exi,
                               False)


def _stage2_tabs(h, Ky, dev):
    from steganosaurus_tpu_torch.spectral import corner

    return corner.dft_tables_device(h, Ky, 96, 96, dev)


# (P, H, Kx, Ky): H, Kx, Ky off the 64 / 256 tiles, P off the band tile's 4
# planes, the 4b grid's H, a main-path-like corner
STAGE2_SHAPES = [(3, 70, 200, 100), (5, 64, 256, 64), (1, 130, 96, 40),
                 (12, 1079, 512, 512), (8, 256, 1024, 256), (2, 33, 131, 70),
                 (5, 130, 300, 192)]
# odd Kyp/64 (a cluster's lone row block) at Ky = 64, 40 and 192; odd Hp/64
# at H = 130 and 1079


@pytest.mark.parametrize("P,h,X,Ky", STAGE2_SHAPES)
def test_stage2_prep_matches_plain(dev, P, h, X, Ky):
    """The prep's bf16 copies bit-equal to .to(bf16), its energies within
    one f32 rounding of the exact (f64) sum and 1e-6 of torch.sum's; on
    views one element off their alignment too (the scalar path)."""
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_like(dev, P, h, X, P * h + X)
    for shift in (False, True):
        if shift:
            buf = torch.empty((2, ar.numel() + 1), device=dev)
            buf[0, 1:], buf[1, 1:] = ar.reshape(-1), ai.reshape(-1)
            ar, ai = buf[0, 1:].view(P, h, X), buf[1, 1:].view(P, h, X)
        ar16, ai16, energy = ck.stage2_prep(ar, ai)
        torch.cuda.synchronize()
        assert torch.equal(ar16, ar.to(torch.bfloat16))
        assert torch.equal(ai16, ai.to(torch.bfloat16))
        sq = ar * ar + ai * ai
        exact = torch.sum(sq.double(), dim=-2)
        assert ((energy.double() - exact).abs() / exact).max() <= 2.0 ** -24
        ref = torch.sum(sq, dim=-2)
        assert ((energy - ref).abs() / ref).max() <= 1e-6


@pytest.mark.parametrize("P,h,X,Ky", STAGE2_SHAPES)
def test_stage2_band_kernel_is_bit_exact(dev, P, h, X, Ky):
    """The band kernel's operand and mask equal band_operand's and
    band_mask's bit for bit (the same f32 differences, the same roundings)."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_like(dev, P, h, X, 3 * P + X)
    idx = corner.band_topk(ck.stage2_prep(ar, ai)[2], 64)
    g, mask = ck.stage2_band(ar, ai, idx)
    torch.cuda.synchronize()
    assert torch.equal(g, ck.band_operand(ar, ai, idx))
    assert torch.equal(mask, ck.band_mask(idx, X))


@pytest.mark.parametrize("P,h,X,Ky", STAGE2_SHAPES)
def test_k2_matches_its_split_bf16_twin(dev, P, h, X, Ky):
    """K2 against fwd_stage2_plain(band="bf16x6") on the same band: the same
    exact bf16 products summed in f32 in another order (REL of
    max|twin|, on image planes' stage-1 output as the main path gives it);
    every element written (finite), the band columns too, and those within
    the three-term split's bound on their own scale (band_error), which
    the two-term band exceeds."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_of_images(dev, P, h, X, 7 * P + h)
    tabs = _stage2_tabs(h, Ky, dev)
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, 64)
    cr, ci = ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs,
                           ck.stage2_band(ar, ai, idx))
    tr, ti = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6", (ar16, ai16))
    torch.cuda.synchronize()
    assert cr.shape == (P, Ky, X) and torch.isfinite(cr).all()
    assert torch.isfinite(ci).all()
    scale = max(tr.abs().max().item(), ti.abs().max().item())
    assert (cr - tr).abs().max().item() <= REL * scale
    assert (ci - ti).abs().max().item() <= REL * scale
    two = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x3", (ar16, ai16))
    assert ck.band_error(cr, ci, ar, ai, idx, tabs) <= ck.SPLIT_REL[
        "bf16x6"] < ck.band_error(*two, ar, ai, idx, tabs)


@pytest.mark.parametrize("rev", [None, K2_PARENT])
@pytest.mark.parametrize("P,h,X,Ky", STAGE2_SHAPES)
def test_k2_bit_equal_to_its_first_version(dev, P, h, X, Ky, rev):
    """The cluster and the multicast move data only, and so does the
    run-time band width at one group: K2's outputs equal those of the
    kernel before them (BITS_OF), and those of the parent of the run-time
    width, bit for bit, on the same operands and band (odd Kyp/64 and
    Hp/64 included). Both builds take the old signature."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    first = _first_version("corner_stage2.cu", rev)
    ar, ai = _stage1_of_images(dev, P, h, X, 11 * P + h)
    tabs = _stage2_tabs(h, Ky, dev)
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, 64)
    band = ck.stage2_band(ar, ai, idx)
    got = ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, band)
    want = _old_k2(first, ar16, ai16, idx, tabs, band)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (P, H, Kx, Ky) and the band widths in columns (0, 1, 2 and Kx/64 groups,
# and 100, padded to two groups)
K2_WIDTH_SHAPES = [(5, 130, 300, 192), (8, 256, 1024, 256),
                   (3, 70, 64, 100)]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("width", [0, 64, 128, 100, "all"])
@pytest.mark.parametrize("P,h,X,Ky", K2_WIDTH_SHAPES)
def test_k2_band_widths_match_the_twin(dev, P, h, X, Ky, width, static):
    """K2 with nb = 0, 1, 2 and Kx/64 band groups (every column: no bulk
    tile, no bf16 copies) and at a width padded to 64 nb (the last index
    repeated), on top-energy and static bands, against fwd_stage2_plain
    (bf16x6) on the unpadded band within REL of max|twin|; the band
    columns within the three-term split's bound (band_error); every element
    written; the launch counted under its band width."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    n = X if width == "all" else min(width, X)
    ar, ai = _stage1_of_images(dev, P, h, X, 13 * P + n + static)
    tabs = _stage2_tabs(h, Ky, dev)
    prep = ck.stage2_prep(ar, ai)
    idx = (torch.arange(n, device=dev).expand(P, n).contiguous() if static
           else corner.band_topk(prep[2], n))
    padded = ck.pad_band(idx)
    band = ck.stage2_band(ar, ai, padded) if n else None
    widths = dict(ck.BAND_WIDTHS)
    bulk = n < X
    cr, ci = ck.fwd_stage2(ar, ai, *(prep[:2] if bulk else (None, None)),
                           padded, tabs, band)
    tr, ti = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6", prep)
    torch.cuda.synchronize()
    assert torch.isfinite(cr).all() and torch.isfinite(ci).all()
    scale = max(tr.abs().max().item(), ti.abs().max().item())
    assert (cr - tr).abs().max().item() <= REL * scale
    assert (ci - ti).abs().max().item() <= REL * scale
    if n:
        assert ck.band_error(cr, ci, ar, ai, idx, tabs) <= ck.SPLIT_REL[
            "bf16x6"]
    w = padded.shape[1]
    assert ck.BAND_WIDTHS[w] == widths.get(w, 0) + 1
    assert ck.stage2_grid(P, X, Ky, nb=w // 64, bulk=bulk) > 0


@pytest.mark.parametrize("mode,launches", [
    ("mix_adaptive", (1, 1, 1, 1, 1, 64)), ("mix_split", (1, 1, 0, 1, 1, 64)),
    ("mix", (1, 0, 0, 1, 1, 256)), ("mix2", (1, 0, 0, 1, 1, 256)),
    ("bf16", (1, 1, 0, 0, 1, 0)), ("high", (0, 0, 0, 1, 1, 256)),
    ("highest", (0, 0, 0, 0, 0, None))])
def test_fwd_corner_on_card_under_each_mode(dev, monkeypatch, mode,
                                            launches):
    """fwd_corner's launches on the card under each mode, (K1, K1 with the
    prep, the prep's reduce, band, K2, K2's band width): K1 writes the
    bf16 copies wherever stage 2 has a bulk and the energies' partials
    (then reduced) where they pick the band, so the prep pass never runs;
    the band pass and K2 without the copies where the whole stage is high,
    K2 without the band pass under bf16, f32 products alone under highest;
    the eager stage 2 never; the spectrum
    within REL of the plain composition's scale (stage 1's plain version or
    the f32 product, then the twin on the band or f32 products)."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    def refuse(*a, **k):
        raise AssertionError("the eager stage 2 ran on the card")

    monkeypatch.setattr(corner, "_fwd_y_split", refuse)
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    p = corner.precision()
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, 256, 384),
                                         dtype=np.uint8)).to(dev)
    Ky, Kx = corner.corner_dims(256, 384, 0.45)
    tabs = corner.dft_tables_device(256, Ky, 384, Kx, dev)
    n, widths = dict(ck.LAUNCHES), dict(ck.BAND_WIDTHS)
    cr, ci = corner.fwd_corner(imgs, True, Ky, Kx, tabs, p)
    torch.cuda.synchronize()
    got = {k: ck.LAUNCHES[k] - n[k] for k in n}
    k1, k1_prep, reduce, band, k2, width = launches
    assert got == {ck.KERNEL_TMA: k1, ck.KERNEL_LDG: 0,
                   ck.KERNEL_K1_PREP: k1_prep, ck.KERNEL_PREP: 0,
                   ck.KERNEL_PREP_REDUCE: reduce, ck.KERNEL_BAND: band,
                   ck.KERNEL_STAGE2: k2}
    grew = {w for w in ck.BAND_WIDTHS if ck.BAND_WIDTHS[w] != widths.get(w)}
    assert grew == (set() if width is None else {width})
    x = imgs.reshape(-1, 256, 384)
    if p.stage1 == "bf16":
        ar, ai = ck.fwd_stage1_plain(x, tabs.exr16, tabs.exi16, True)
    else:
        from steganosaurus_tpu_torch import spectral

        planes = spectral.apply_center(x.to(torch.float32), True)
        ar, ai = planes @ tabs.exr.T, planes @ tabs.exi.T
    if p.fwd2 == "highest":
        tr = tabs.eyr @ ar - tabs.eyi @ ai
        ti = tabs.eyr @ ai + tabs.eyi @ ar
    else:
        P = ar.shape[0]
        idx = {"adaptive": lambda: corner.band_topk(
                   ck.stage2_prep_plain(ar, ai)[2], 64),
               "split": lambda: torch.arange(64, device=dev).expand(P, 64),
               "high": lambda: torch.arange(Kx, device=dev).expand(P, Kx),
               "bf16": lambda: torch.empty((P, 0), dtype=torch.int64,
                                           device=dev)}[p.fwd2]()
        tr, ti = ck.fwd_stage2_plain(ar, ai, idx.contiguous(), tabs,
                                     "bf16x6")
    scale = max(tr.abs().max().item(), ti.abs().max().item())
    assert (cr.reshape(tr.shape) - tr).abs().max().item() <= REL * scale
    assert (ci.reshape(ti.shape) - ti).abs().max().item() <= REL * scale


MODES = ("mix_split", "mix_adaptive", "mix", "mix3", "mix2",
         "mix_conservative", "bf16", "high", "highest")


@pytest.mark.parametrize("mode", MODES)
def test_round_trip_512_under_each_mode(dev, monkeypatch, mode):
    """A 512x512 B=4 round trip on the card under each mode: B/B recovered
    (bf16, a measurement mode: the rows the CPU port recovers of its own
    stego), the stego within +-1 of the CPU port's on at most 0.5% of its
    bytes (PERF.md section 2's card-against-CPU bound: the bf16 stages sum
    in other orders on the card)."""
    import steganosaurus_tpu_torch as stt

    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    rng = np.random.default_rng(17)
    base = np.linspace(150, 235, 512)
    covers = np.clip(base[None, None, None, :]
                     + rng.integers(-18, 19, (4, 3, 512, 512)), 0,
                     255).astype(np.uint8)
    secrets = [bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
               for _ in range(4)]
    salts = [bytes([i]) * 16 for i in range(4)]
    mk = bytes(range(32))
    res = stt.embed_batch(torch.from_numpy(covers).to(dev), secrets,
                          master_key=mk, salts=salts, device_resident=True,
                          layout="nchw")
    got = stt.extract_batch(res.stego, master_key=mk, clen_hint=1024,
                            layout="nchw")
    ref = stt.embed_batch(covers, secrets, master_key=mk, salts=salts,
                          layout="nchw", device="cpu").stego
    diff = res.stego.cpu().numpy().astype(np.int16) - ref.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 5e-3 * diff.size
    rows = [g == s for g, s in zip(got, secrets)]
    if mode == "bf16":
        cpu = stt.extract_batch(ref, master_key=mk, clen_hint=1024,
                                layout="nchw", device="cpu")
        assert rows == [g == s for g, s in zip(cpu, secrets)]
    else:
        assert all(rows)


def test_k2_refused_launch_raises(dev, monkeypatch):
    """A shape the kernel refuses (here bf16 rows whose stride is not whole
    16-byte words) comes back from the C entry as its error code and raises
    in the wrapper: nothing else stands in, nothing is counted."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_like(dev, 3, 70, 200, 8)
    tabs = _stage2_tabs(70, 100, dev)
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, 64)
    band = ck.stage2_band(ar, ai, idx)

    def odd_rows(t):
        buf = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                          device=t.device)
        buf[..., :-1] = t
        return buf[..., :-1]

    monkeypatch.setattr(ck, "_tma_rows", odd_rows)
    n = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, band)
    assert ck.LAUNCHES == n
    assert ck.stage2_grid(3, 200, 100) % ck.STAGE2_CLUSTER == 0


def test_k2_plane_does_not_depend_on_the_batch(dev):
    """A plane's stage 2 gives the same bits alone, in a batch of 7 and in
    another slot of a band tile: the sum order depends on the shape alone
    (shards of a batch agree)."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_like(dev, 7, 200, 320, 21)
    tabs = _stage2_tabs(200, 192, dev)

    def stage2(a, b):
        a16, b16, e = ck.stage2_prep(a, b)
        i = corner.band_topk(e, 64)
        return ck.fwd_stage2(a, b, a16, b16, i, tabs, ck.stage2_band(a, b, i))

    cr, ci = stage2(ar, ai)
    for sl in (slice(5, 6), slice(3, 7), slice(1, 6)):
        pr, pi = stage2(ar[sl].contiguous(), ai[sl].contiguous())
        assert torch.equal(pr, cr[sl]) and torch.equal(pi, ci[sl])


def test_stage2_wrappers_count_and_check(dev):
    """One count per launch under each kernel's name; bad inputs raise."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    ar, ai = _stage1_like(dev, 3, 70, 200, 5)
    tabs = _stage2_tabs(70, 100, dev)
    n = dict(ck.LAUNCHES)
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, 64)
    band = ck.stage2_band(ar, ai, idx)
    ck.fwd_stage2(ar, ai, ar16, ai16, idx, tabs, band)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**n, ck.KERNEL_PREP: n[ck.KERNEL_PREP] + 1,
                           ck.KERNEL_BAND: n[ck.KERNEL_BAND] + 1,
                           ck.KERNEL_STAGE2: n[ck.KERNEL_STAGE2] + 1}
    n = dict(ck.LAUNCHES)
    for bad in ((ar.double(), ai), (ar, ai.cpu()), (ar.transpose(1, 2),
                                                    ai.transpose(1, 2))):
        with pytest.raises(ValueError):
            ck.stage2_prep(*bad)
    for k, bad in ((0, ar.cpu()), (2, ar16.float()), (4, idx.to(torch.int32)),
                   (4, idx[:, :32]), (5, _stage2_tabs(71, 100, dev)),
                   (6, (band[0].cpu(), band[1]))):
        args = [ar, ai, ar16, ai16, idx, tabs, band]
        args[k] = bad
        with pytest.raises(ValueError):
            ck.fwd_stage2(*args)
    for bad in ((ar, ai, idx.cpu()), (ar, ai.transpose(1, 2), idx)):
        with pytest.raises(ValueError):
            ck.stage2_band(*bad)
    with pytest.raises(ValueError):    # no bulk: the band must hold Kx
        ck.fwd_stage2(ar, ai, None, None, idx, tabs, band)
    with pytest.raises(ValueError):    # no band: no band operand
        ck.fwd_stage2(ar, ai, ar16, ai16, idx[:, :0].contiguous(), tabs,
                      band)
    assert ck.LAUNCHES == n


def test_fwd_corner_on_card_runs_prep_and_k2(dev, monkeypatch):
    """fwd_corner under mix_adaptive on the card: K1 with the prep in its
    epilogue, the prep's reduce, the band pass and K2 once each, the prep
    pass and the eager stage 2 never; its spectrum within REL of the scale
    of the plain composition's (stage 1's plain version, then the bf16x6
    twin on the kernel's band)."""
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    def refuse(*a, **k):
        raise AssertionError("the eager stage 2 ran on the card")

    monkeypatch.setattr(corner, "_fwd_y_split", refuse)
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, 256, 384),
                                         dtype=np.uint8)).to(dev)
    Ky, Kx = corner.corner_dims(256, 384, 0.45)
    tabs = corner.dft_tables_device(256, Ky, 384, Kx, dev)
    n = dict(ck.LAUNCHES)
    cr, ci = corner.fwd_corner(imgs, True, Ky, Kx, tabs, "mix_adaptive")
    torch.cuda.synchronize()
    got = {k: ck.LAUNCHES[k] - n[k] for k in n}
    assert got == {ck.KERNEL_TMA: 1, ck.KERNEL_LDG: 0, ck.KERNEL_K1_PREP: 1,
                   ck.KERNEL_PREP: 0, ck.KERNEL_PREP_REDUCE: 1,
                   ck.KERNEL_BAND: 1, ck.KERNEL_STAGE2: 1}
    ar, ai = ck.fwd_stage1_plain(imgs.reshape(-1, 256, 384), tabs.exr16,
                                 tabs.exi16, True)
    ar16, ai16, energy = ck.stage2_prep(ar, ai)
    idx = corner.band_topk(energy, 64)
    tr, ti = ck.fwd_stage2_plain(ar, ai, idx, tabs, "bf16x6", (ar16, ai16))
    scale = max(tr.abs().max().item(), ti.abs().max().item())
    assert (cr.reshape(tr.shape) - tr).abs().max().item() <= REL * scale
    assert (ci.reshape(ti.shape) - ti).abs().max().item() <= REL * scale


# --- K5: the extract's read and decode (csrc/corner_read_decode.cu) ---------

# (H, W, secret bytes): the main path's 4K walk, 1080p and 512x512
READ_GRIDS = {"4K": (2160, 3840, 16384), "1080p": (1080, 1920, 4096),
              "512": (512, 512, 200)}
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
# walk slots planted in every image: +0.0, -0.0, +0.0 (a Rep-3 group of
# ties), 3.0, -3.0, -0.0 (a group whose copies sum to +0.0) and a tiny
# negative that rounds to -0.0 in bf16 (payload slot 8)
READ_PLANTED = {0: 0.0, 1: -0.0, 2: 0.0, 12: 3.0, 13: -3.0, 14: -0.0,
                920: -1e-42}


@functools.lru_cache(maxsize=None)
def _read_walk(grid: str):
    """The shared walk of a default-Params frame of the grid's secret:
    plane, y, x (bucket,) int64 on the card, its jitter angles at 0.2,
    and (Ky, Kx)."""
    from steganosaurus_tpu_torch import spectral
    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.pipeline import batch as tbatch
    from steganosaurus_tpu_torch.spectral import corner

    H, W, secret = READ_GRIDS[grid]
    PH, PW = spectral.fft_dims(H, W)
    Ky, Kx = corner.corner_dims(PH, PW, Params().rmax)
    total = 912 + tbatch._payload_stream_bits(secret + 16, False)
    bucket = tbatch._bucket(total)
    dev = torch.device("cuda", 0)
    (pl, yy, xx, _), nprod = tbatch._walk_indices_device(
        None, bytes(range(32)), Params(), PH, PW, total, 0, bucket, dev)
    assert nprod >= total
    (_, _, _, jj), _ = tbatch._walk_indices_device(
        None, bytes(range(32)), Params(jitter=0.2), PH, PW, total, 0,
        bucket, dev)
    return pl, yy, xx, jj, Ky, Kx


def _read_inputs(dev, grid: str, B: int, seed: int):
    pl, yy, xx, jj, Ky, Kx = _read_walk(grid)
    g = torch.Generator(device=dev).manual_seed(seed)
    cr, ci = (torch.randn((B, 3, Ky, Kx), generator=g, device=dev) * 1e3
              for _ in range(2))
    for s, v in READ_PLANTED.items():
        ci[:, pl[s], yy[s], xx[s]] = v
    return cr, ci, pl, yy, xx, jj


@functools.lru_cache(maxsize=None)
def _read_plan(grid: str):
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    pl, yy, xx, _, Ky, Kx = _read_walk(grid)
    return rk.read_plan(pl, yy, xx, Ky, Kx)


def _read_equal(got, want) -> None:
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), (int((g != w).sum()), tuple(g.shape))


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("grid", list(READ_GRIDS))
@pytest.mark.parametrize("flags", list(READ_FLAGS))
def test_read_decode_kernel_is_bit_equal_to_plain(dev, grid, flags, B):
    """K5 against read_decode_plain on the same spectrum and walk, through
    the walk's read plan, on every grid and flag combination, B = 1, 3
    and 9 (a whole chunk of 8 images and a partial one): every word equal,
    K5 launched once and the eager read never."""
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    hdr, rep, hard, soft, jitter, ssa = READ_FLAGS[flags]
    cr, ci, pl, yy, xx, jj = _read_inputs(dev, grid, B, B + len(flags))
    extra = ((cr, torch.cos(jj), torch.sin(jj)) if jitter
             else (None, None, None))
    kw = dict(hdr_stream_bits=hdr, payload_rep=rep, hard=hard, soft=soft)
    n = dict(rk.LAUNCHES)
    got = rk.read_decode(ci, pl, yy, xx, ssa, *extra, plan=_read_plan(grid),
                         **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.KERNEL_READ_DECODE] == n[rk.KERNEL_READ_DECODE] + 1
    assert rk.LAUNCHES[rk.KERNEL_READ_EAGER] == n[rk.KERNEL_READ_EAGER]
    _read_equal(got, rk.read_decode_plain(ci, pl, yy, xx, ssa, *extra, **kw))


@pytest.mark.parametrize("B", [1, 9])
@pytest.mark.parametrize("grid", list(READ_GRIDS))
@pytest.mark.parametrize("flags", ["main", "jitter rs retry", "raw bits"])
def test_read_decode_builds_its_own_plan(dev, grid, flags, B):
    """Called without a plan, K5 builds the walk's plan itself (one build
    counted) and reads through it: every word equal to
    read_decode_plain's."""
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    hdr, rep, hard, soft, jitter, ssa = READ_FLAGS[flags]
    cr, ci, pl, yy, xx, jj = _read_inputs(dev, grid, B, 40 + B)
    extra = ((cr, torch.cos(jj), torch.sin(jj)) if jitter
             else (None, None, None))
    kw = dict(hdr_stream_bits=hdr, payload_rep=rep, hard=hard, soft=soft)
    built = rk.PLANS_BUILT
    got = rk.read_decode(ci, pl, yy, xx, ssa, *extra, **kw)
    torch.cuda.synchronize()
    assert rk.PLANS_BUILT == built + 1
    _read_equal(got, rk.read_decode_plain(ci, pl, yy, xx, ssa, *extra, **kw))


def test_read_decode_refused_launch_raises(dev, monkeypatch):
    """An error code from the C entry raises in the wrapper; nothing else
    stands in and nothing is counted."""
    from steganosaurus_tpu_torch import _build
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    lib = _build.kernel_library()
    cr, ci, pl, yy, xx, _ = _read_inputs(dev, "512", 1, 5)
    monkeypatch.setattr(lib, "corner_read_decode", lambda *a: 1)
    n = dict(rk.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rk.read_decode(ci, pl, yy, xx, 1.0, hdr_stream_bits=912,
                       payload_rep=7, plan=_read_plan("512"))
    assert rk.LAUNCHES == n


def test_read_decode_wrapper_checks_its_inputs(dev):
    """Wrong types, shapes, layouts and devices raise before any launch."""
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    cr, ci, pl, yy, xx, jj = _read_inputs(dev, "512", 2, 6)
    kw = dict(hdr_stream_bits=912, payload_rep=7)
    n = dict(rk.LAUNCHES)
    for args in ((ci.double(), pl, yy, xx), (ci[:, :2], pl, yy, xx),
                 (ci.transpose(-1, -2), pl, yy, xx),
                 (ci, pl.int(), yy, xx), (ci, pl, yy[::2], xx),
                 (ci, pl.cpu(), yy, xx)):
        with pytest.raises(ValueError):
            rk.read_decode(*args, 1.0, **kw)
    with pytest.raises(ValueError):
        rk.read_decode(ci, pl, yy, xx, 1.0, cr[..., :-1], torch.cos(jj),
                       torch.sin(jj), **kw)
    # a plan of another walk or corner
    with pytest.raises(ValueError, match="plan"):
        rk.read_decode(ci, pl, yy, xx, 1.0, plan=_read_plan("1080p"), **kw)
    assert rk.LAUNCHES == n


def test_extract_cores_on_card_read_through_k5(dev, monkeypatch):
    """The fused pass, the soft retry pass and the raw bits of a 512x512
    round trip of 5 images on the card each launch K5 once and never the
    eager read, and a second extract builds no read plan; the rows equal
    the eager chain's on the same stego (the soft rows' sums in another
    order: equal on a clean stego)."""
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.config import Params
    from steganosaurus_tpu_torch.parallel import batch as pb
    from steganosaurus_tpu_torch.spectral import read_kernels as rk

    B = 5
    rng = np.random.default_rng(8)
    covers = np.clip(np.linspace(150, 235, 512)[None, None, :, None]
                     + rng.integers(-18, 19, (B, 512, 512, 3)), 0,
                     255).astype(np.uint8)
    secrets = [bytes(rng.integers(0, 256, 200, dtype=np.uint8))
               for _ in range(B)]
    mk = bytes(range(32))
    st = stt.embed_batch(torch.from_numpy(covers).to(dev), secrets,
                         master_key=mk, device_resident=True).stego
    n = dict(rk.LAUNCHES)
    # with the length hinted, one fused pass reads header and payload
    assert stt.extract_batch(st, master_key=mk, clen_hint=200) == secrets
    assert rk.LAUNCHES[rk.KERNEL_READ_DECODE] == \
        n[rk.KERNEL_READ_DECODE] + 1
    assert rk.LAUNCHES[rk.KERNEL_READ_EAGER] == n[rk.KERNEL_READ_EAGER]
    pl, yy, xx, _, Ky, Kx = _read_walk("512")
    kw = dict(Ky=Ky, Kx=Kx, center=Params().center, layout="nhwc")
    alpha = Params().alpha
    fused = pb.corner_extract_fused_core(st, alpha, pl, yy, xx,
                                         hdr_stream_bits=912,
                                         with_soft=True, **kw)
    retry = pb.corner_soft_extract_core(st, alpha, pl, yy, xx,
                                        hdr_stream_bits=912, **kw)
    raw = pb.corner_raw_bits_core(st, alpha, pl, yy, xx, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.KERNEL_READ_DECODE] == \
        n[rk.KERNEL_READ_DECODE] + 4
    d = pb._walk_decisions(st, alpha, pl, yy, xx, **kw)
    assert torch.equal(fused[0], pb._decode_sections(
        (d >= 0).to(torch.uint8), 912))
    assert torch.equal(fused[1], pb._decode_sections_soft(
        d.to(torch.bfloat16).to(torch.float32), 912))
    assert torch.equal(retry, pb._decode_sections_soft(d, 912))
    assert torch.equal(raw, pb.bit_ops.pack_bits_words(
        (d >= 0).to(torch.uint8)))
    # the walk's read plan is cached with the walk: a second call builds none
    built = rk.PLANS_BUILT
    assert stt.extract_batch(st, master_key=mk, clen_hint=200) == secrets
    assert rk.PLANS_BUILT == built
