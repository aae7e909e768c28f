"""Stego quality metrics: PSNR, SSIM, and ECC bit-error rates, in torch.

The port's twin of steganosaurus_tpu/utils/metrics.py. The host versions
psnr, ssim and ber are numpy, copied from that module as they are;
ecc_report runs on the port's Rep-3/Rep-7 decode and its ops/rs.py, for the
Rep-7 and the RS payload; quality_device computes PSNR and block SSIM on the
batch's own device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.ops import rs as rs_mod

__all__ = ["ber", "ecc_report", "psnr", "quality_device", "ssim"]


def psnr(cover: np.ndarray, stego: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB over all channels."""
    err = stego.astype(np.float64) - cover.astype(np.float64)
    mse = float(np.mean(np.square(err)))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(cover: np.ndarray, stego: np.ndarray, peak: float = 255.0,
         win: int = 8) -> float:
    """Mean structural similarity (Wang et al. 2004), non-overlapping
    win x win windows, per channel, standard constants K1=0.01, K2=0.03.
    Block SSIM (not gaussian-windowed); for the >0.995 imperceptibility bar
    the two agree to ~1e-4."""
    a = cover.astype(np.float64)
    b = stego.astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    H, W, C = a.shape
    h = (H // win) * win
    w = (W // win) * win
    # (nby, nbx, win, win, C) blocks
    ab = a[:h, :w].reshape(h // win, win, w // win, win, C).transpose(0, 2, 1, 3, 4)
    bb = b[:h, :w].reshape(h // win, win, w // win, win, C).transpose(0, 2, 1, 3, 4)
    mu_a = ab.mean(axis=(2, 3))
    mu_b = bb.mean(axis=(2, 3))
    var_a = ab.var(axis=(2, 3))
    var_b = bb.var(axis=(2, 3))
    cov = (ab * bb).mean(axis=(2, 3)) - mu_a * mu_b
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())


def ber(sent_bits: np.ndarray, received_bits: np.ndarray) -> float:
    """Raw bit-error rate between two 0/1 arrays (pre-ECC channel quality)."""
    s = np.asarray(sent_bits).ravel()
    r = np.asarray(received_bits).ravel()
    n = min(len(s), len(r))
    if n == 0:
        return 0.0
    return float(np.mean(s[:n] != r[:n]))


def _rep_decode(bits: np.ndarray, n: int) -> np.ndarray:
    return ecc.rep_decode(torch.from_numpy(np.ascontiguousarray(
        bits, np.uint8)), n).numpy()


def _rs_decoded_bits(bits: np.ndarray, m: int) -> np.ndarray:
    """The m-byte message bits of interleaved RS(255,223) coded bits."""
    dec, _, _ = rs_mod.rs_decode_interleaved(
        np.packbits(np.asarray(bits, np.uint8)).tobytes(), m)
    return np.unpackbits(np.frombuffer(dec, np.uint8))


def ecc_report(sent_frame: np.ndarray, received_frame: np.ndarray,
               header_stream_bits: int, rs_payload_bytes: int = 0) -> dict:
    """BER before and after ECC for one embedded frame: sent/received are
    full on-wire bit frames, the Rep-3 header stream followed by the
    payload stream — Rep-7 (reference frame layout, steganosaur.cpp:
    986-995), or the interleaved RS(255,223) coded bits of a
    rs_payload_bytes-byte message (= clen + 16) when that is given."""
    s = np.asarray(sent_frame).ravel()
    r = np.asarray(received_frame).ravel()
    h = header_stream_bits
    if rs_payload_bytes:
        pay_post = ber(_rs_decoded_bits(s[h:], rs_payload_bytes),
                       _rs_decoded_bits(r[h:], rs_payload_bytes))
    else:
        pay_post = ber(_rep_decode(s[h:], 7), _rep_decode(r[h:], 7))
    return {
        "header_ber_raw": ber(s[:h], r[:h]),
        "header_ber_post_ecc": ber(_rep_decode(s[:h], 3),
                                   _rep_decode(r[:h], 3)),
        "payload_ber_raw": ber(s[h:], r[h:]),
        "payload_ber_post_ecc": pay_post,
    }


def _block_stats(a: torch.Tensor, b: torch.Tensor, peak: float, win: int):
    """(sum of squared errors, mean block SSIM) of one NCHW chunk, f32 with
    centered moments: E[(x-mu)(y-nu)], not E[xy]-mu*nu, which cancels
    catastrophically in f32 at pixel scale ~200."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mse_sum = torch.sum(torch.square(a - b))
    H, W = a.shape[-2:]
    a = a[..., :(H // win) * win, :(W // win) * win]
    b = b[..., :(H // win) * win, :(W // win) * win]

    def up(x):  # each block's value over its win x win pixels
        n, c, hb, wb = x.shape
        return x[:, :, :, None, :, None].expand(
            n, c, hb, win, wb, win).reshape(n, c, hb * win, wb * win)

    mu_a = F.avg_pool2d(a, win)
    mu_b = F.avg_pool2d(b, win)
    ca = a - up(mu_a)
    cb = b - up(mu_b)
    var_a = F.avg_pool2d(ca * ca, win)
    var_b = F.avg_pool2d(cb * cb, win)
    cov = F.avg_pool2d(ca * cb, win)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return mse_sum, torch.mean(s)


def quality_device(cover_d: torch.Tensor, stego_d: torch.Tensor,
                   peak: float = 255.0, win: int = 8,
                   chunk: int = 8) -> tuple[float, float]:
    """(PSNR dB, mean SSIM) of a batch, computed on the tensors' device.

    The same block SSIM as ssim() (non-overlapping win x win windows per
    channel, K1 = 0.01, K2 = 0.03) and the same PSNR as psnr() over the
    whole batch. `chunk` images at a time: the f32 moment temporaries are
    ~100 MB per 4K image, so a 4K batch of 64 stays within memory.

    Accepts (B, H, W, C) or (B, C, H, W) u8 (C in {1, 3} decides); NHWC is
    permuted to NCHW a chunk at a time. Returns Python floats."""
    if cover_d.shape != stego_d.shape:
        raise ValueError(f"cover {tuple(cover_d.shape)} and stego "
                         f"{tuple(stego_d.shape)} differ")
    nhwc = cover_d.shape[-1] in (1, 3)
    B = cover_d.shape[0]
    mse_sum = 0.0
    ssim_sum = 0.0
    npix = float(np.prod(cover_d.shape[1:]))
    stats = []
    for i in range(0, B, chunk):
        a, b = cover_d[i:i + chunk], stego_d[i:i + chunk]
        if nhwc:
            a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
        m, s = _block_stats(a, b, peak, win)
        stats.append((m, s, a.shape[0]))
    for m, s, n in stats:  # pulled once every chunk is queued
        mse_sum += float(m)
        ssim_sum += float(s) * n
    mse = mse_sum / (B * npix)
    p = 10.0 * float(np.log10(peak * peak / mse)) if mse > 0 else float("inf")
    return p, ssim_sum / B
