"""The port's channel report and quality metrics against the JAX package's
(utils/metrics.py, pipeline/batch.py channel_report), on the same stego
bytes and numpy inputs: post-ECC BER equal, raw BER within 2e-4 absolute
(the bf16 forward stages of the two packages round in other places, so a
bin on the decision boundary can read the other way), PSNR within 1e-3 dB
and SSIM within 1e-5 of the f64 numpy metrics and of JAX's quality_device
(f32 sums in another order)."""

import dataclasses
import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.utils import metrics as jmetrics
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.utils import metrics as tmetrics
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

H, W, B, SECRET = 384, 640, 4, 512
MK = bytes(range(32))
SALTS = [bytes([i + 3]) * 16 for i in range(B)]
RAW_TOL = 2e-4
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


def _inputs(jitter: float):
    """384x640 noisy covers and 444-512 byte secrets (a raw BER of ~0.003
    that the ECC corrects) and the JAX package's stegos of them."""
    rng = np.random.default_rng(33)
    base = np.linspace(140, 235, W)
    covers = np.clip(base[None, None, :, None]
                     + rng.integers(-25, 26, (B, H, W, 3)), 0,
                     255).astype(np.uint8)
    secrets = [bytes(rng.integers(0, 256, SECRET - 17 * i, dtype=np.uint8))
               for i in range(B)]
    p = Params(jitter=jitter)
    stego = np.array(jbatch.embed_batch(covers, secrets, master_key=MK,
                                        params=jp(p), salts=SALTS).stego)
    return p, covers, secrets, stego


_CACHE: dict = {}


def _case(jitter):
    if jitter not in _CACHE:
        _CACHE[jitter] = _inputs(jitter)
    return _CACHE[jitter]


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_channel_report_matches_jax(jitter, layout):
    p, _, secrets, stego = _case(jitter)
    if layout == "nchw":
        stego = np.ascontiguousarray(stego.transpose(0, 3, 1, 2))
    mine = stt.channel_report(stego, secrets, SALTS, master_key=MK, params=p,
                              layout=layout, per_image=True, device="cpu")
    ref = jbatch.channel_report(stego, secrets, SALTS, master_key=MK,
                                params=jp(p), layout=layout, per_image=True)
    assert set(mine) == set(ref)
    for k in ("header_ber_post_ecc", "payload_ber_post_ecc"):
        assert mine[k] == ref[k] == 0.0
    assert ref["payload_ber_raw"] > 0  # the channel has flips to count
    for k in ("header_ber_raw", "payload_ber_raw"):
        assert abs(mine[k] - ref[k]) <= RAW_TOL, (k, mine[k], ref[k])
    for a, b in zip(mine["per_image"], ref["per_image"]):
        assert abs(a["payload_ber_raw"] - b["payload_ber_raw"]) <= RAW_TOL


def test_channel_report_of_the_ports_stego_and_rs_raises():
    """The report of the port's own stego of the same inputs; under
    Params.rs (carried since the wire modes were ported) the same Rep-7
    stego reads as RS frames that do not match it, and per-image walks —
    which the JAX report rejects too — raise StegoError naming the field."""
    p, covers, secrets, _ = _case(0.0)
    st = stt.embed_batch(covers, secrets, master_key=MK, params=p,
                         salts=SALTS, device="cpu").stego
    mine = stt.channel_report(st, secrets, SALTS, master_key=MK, params=p,
                              device="cpu")
    ref = jbatch.channel_report(st, secrets, SALTS, master_key=MK, params=jp(p))
    assert mine["payload_ber_post_ecc"] == ref["payload_ber_post_ecc"] == 0
    assert abs(mine["payload_ber_raw"] - ref["payload_ber_raw"]) <= RAW_TOL
    rs = stt.channel_report(st, secrets, SALTS, master_key=MK,
                            params=Params(rs=True), device="cpu")
    assert rs["payload_ber_raw"] > 0.1
    with pytest.raises(stt.StegoError, match="per_image_walk"):
        stt.channel_report(st, secrets, SALTS, master_key=MK,
                           params=Params(per_image_walk=True), device="cpu")
    with pytest.raises(ValueError):
        stt.channel_report(st, secrets, SALTS[:-1], master_key=MK,
                           device="cpu")


def test_ecc_report_matches_jax():
    """Rep-3 header + Rep-7 payload frames with injected flips, including
    groups the majority loses."""
    rng = np.random.default_rng(8)
    hdr = 912
    sent = rng.integers(0, 2, hdr + 7 * 300).astype(np.uint8)
    recv = sent.copy()
    flips = rng.random(sent.size) < 0.2
    recv[flips] ^= 1
    mine = tmetrics.ecc_report(sent, recv, hdr)
    ref = jmetrics.ecc_report(sent, recv, hdr)
    assert mine == ref
    assert mine["payload_ber_post_ecc"] > 0 and mine["header_ber_raw"] > 0
    assert tmetrics.ecc_report(sent, sent, hdr) == {
        k: 0.0 for k in mine}
    # the host metrics are the port's copies of the JAX module's numpy
    # functions: the same values on the same frames and images
    assert tmetrics.ber(sent, recv) == jmetrics.ber(sent, recv)
    imgs = rng.integers(0, 256, (2, 40, 48, 3)).astype(np.uint8)
    for f in ("psnr", "ssim"):
        assert getattr(tmetrics, f)(imgs[0], imgs[1]) == getattr(
            jmetrics, f)(imgs[0], imgs[1])


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_quality_device_matches_numpy_and_jax(layout):
    """quality_device against the f64 numpy psnr/ssim of the whole batch
    and against JAX's quality_device, with a chunk that does not divide
    the batch."""
    _, covers, _, stego = _case(0.0)
    want_psnr = jmetrics.psnr(covers, stego)
    want_ssim = float(np.mean([jmetrics.ssim(c, s)
                               for c, s in zip(covers, stego)]))
    c, s = covers, stego
    if layout == "nchw":
        c = np.ascontiguousarray(c.transpose(0, 3, 1, 2))
        s = np.ascontiguousarray(s.transpose(0, 3, 1, 2))
    got_psnr, got_ssim = stt.quality_device(torch.from_numpy(c),
                                            torch.from_numpy(s), chunk=3)
    j_psnr, j_ssim = jmetrics.quality_device(c, s, chunk=3)
    assert isinstance(got_psnr, float) and isinstance(got_ssim, float)
    assert abs(got_psnr - want_psnr) <= PSNR_TOL, (got_psnr, want_psnr)
    assert abs(got_ssim - want_ssim) <= SSIM_TOL, (got_ssim, want_ssim)
    assert abs(got_psnr - j_psnr) <= PSNR_TOL
    assert abs(got_ssim - j_ssim) <= SSIM_TOL
    assert 30.0 < got_psnr < 60.0 and 0.5 < got_ssim < 1.0


def test_quality_device_identical_and_mismatched():
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 3, 16, 24), dtype=np.uint8))
    p, s = stt.quality_device(x, x)
    assert p == float("inf") and abs(s - 1.0) <= 1e-6
    with pytest.raises(ValueError):
        stt.quality_device(x, x[:1])
