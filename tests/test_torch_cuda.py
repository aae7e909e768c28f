"""Card-only tests of the torch port: the hand-written K1 kernel
(csrc/corner_stage1_wgmma.cu, A by TMA for W % 16 == 0 on an aligned base,
by the producer's loads for any other W or base) against its plain
version, at both routes' edge shapes and on views that end at the last
byte of their storage, the wrapper's routing, checks and launch counts,
round trips through the kernel (small, and 1080p B=8), a two-batch stream,
the soft-decision retry pass (Rep-7 and RS), a QIM extract and a
per-image-walk embed; the single-image path: a 1080p embed_array ->
extract_array round trip, the exact median (kthvalue against the bisection
twin) at 4K, a 1080p adaptive_alpha batch through the full-grid cores, and
a complex128 round trip that stays on the card; the serve worker at
512x512 (K1 launched by every op) and the CLI's embed -> extract on the
card.

They skip without CUDA. This file imports neither jax nor the JAX package's
device code, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

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
