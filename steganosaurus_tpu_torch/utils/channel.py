"""Sender-side channel characterization: the IFFT -> u8 -> FFT
requantization noise at the written bins (the port's copy of
steganosaurus_tpu/utils/channel.py, over the port's own f64 NumpyBackend,
frame, header, QIM and spread modules; robustness_report over the port's
embed_array / extract_array / channel_report on the `device` it is given;
every field equal to the JAX package's, tests/test_torch_steganalysis.py).

Pixel quantization (round + clamp to u8, reference steganosaur.cpp:389) is
the ONLY channel impairment in the lossless-PNG pipeline — it is what the
Rep-3/Rep-7 ECC absorbs and what bounds how small a decode margin (low
alpha, high QIM L) can get before recovery degrades. doc/TODO.md lists its
spectrum as an unmeasured honesty item; this module measures it.

`requantization_noise_report` embeds a payload with the f64 oracle backend
(pipeline/device.NumpyBackend), captures the intended per-bin target values,
re-FFTs the quantized stego, and reports the circular phase error at every
written bin: dispersion, tail quantiles, raw pre-ECC flip rates (header and
payload separately, via the real decode rules), and the error's dependence
on bin magnitude and radius. Host-side numpy, like utils.metrics — this is
a measurement tool, not a serving path.
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_tpu_torch import _build, crypto, keystream, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline import device, header as header_mod
from steganosaurus_tpu_torch.pipeline import qim as qim_mod, spread
from steganosaurus_tpu_torch.pipeline.embed import frame_bits
from steganosaurus_tpu_torch.pipeline.errors import StegoError


def _wrap(a: np.ndarray) -> np.ndarray:
    """Wrap angles to (-pi, pi]."""
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def requantization_noise_report(
    img: np.ndarray,
    secret: bytes,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    salt: bytes = b"\x00" * 16,
    n_mag_bands: int = 5,
    n_rad_bands: int = 4,
) -> dict:
    """Measure the requantization phase-noise channel for one cover.

    Returns a dict with:
      n_bins: written walk slots (header + payload).
      write_rms_rad: RMS circular distance from the cover's phase to the
        written target — the per-bin write energy the mode spends.
      write_rms_payload_rad: same, payload slots only (the header is
        always hard-written, so at small images its ±alpha energy
        dominates the mixed rms; this isolates the payload mode's own
        energy).
      noise_std_rad / mean_abs / p50 / p90 / p99 / max: circular error
        |theta_observed - theta_target| statistics over all written bins.
      margin_header_rad: the header's hard-write decision margin (the
        distance from the written phase to the nearest decode boundary;
        min(alpha, pi - alpha) at jitter=0).
      margin_payload_rad: payload margin — same as header for hard/soft
        writes, pi/(2L) under QIM.
      raw_flip_rate_header / raw_flip_rate_payload: fraction of slots whose
        DECODED bit (real decode rules: half-plane test / nearest QIM coset)
        differs from the intended bit — the pre-ECC BER the Rep-3/Rep-7
        majority votes absorb.
      by_magnitude: list of n_mag_bands dicts {mag_lo, mag_hi, n, std_rad}
        over quantiles of the cover-bin magnitude — phase noise is ~1/mag
        (a fixed-size pixel perturbation moves a bin's complex value by a
        magnitude-independent amount, so the ANGLE moves inversely with
        |bin|).
      by_radius: list of n_rad_bands dicts {r_lo, r_hi, n, std_rad} over
        the walk radius hypot(y, x) — flat if the quantization noise is
        spectrally white.

    Shared-walk modes only (cover_dependent_path and per_image_walk change
    the walk per image; the channel physics they see is identical).
    """
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")
    if params.cover_dependent_path or params.per_image_walk:
        raise StegoError(
            "requantization_noise_report supports shared-walk modes only")

    backend = device.NumpyBackend()  # f64 oracle: targets are exact
    planes = spectral.to_planes(img)
    H, W = img.shape[:2]
    PH, PW = spectral.fft_dims(H, W)
    spec, med, capacity, _ = backend.analyze(planes, params)

    flags = header_mod.flags_with_qim(0, params.qim) if params.qim else 0
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    with crypto.derive_keys_vault(password, master_key, salt=salt,
                                  iters=params.pbkdf2_iter) as km:
        hdr_bytes, ct, tag = header_mod.seal_stream(secret, km, flags,
                                                    params.pad_quantum)
    bits = np.asarray(frame_bits(hdr_bytes, ct, tag, rs=params.rs))
    if len(bits) > capacity:
        raise StegoError(f"Message too large. Need {len(bits)} bits "
                         f"(after ECC), capacity ~{capacity} bits.")

    path_key = crypto.derive_path_key(password, master_key, None)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    _build.ensure_native()  # the pure-Python walk is ~1000x slower
    plane, y, x, jit = keystream.turtle_expand(
        key_walk, (key_r, key_g, key_b), PH, PW,
        params.rmin, params.rmax, params.density, params.jitter, len(bits))

    hdr_n = header_mod.FIXED_LEN * 8 * 3
    alphas = spread.spread_alphas(path_key, params, len(bits))
    dithers = (qim_mod.dither_angles(path_key, params.qim, len(bits))
               if params.qim else None)
    stego, targets = backend.embed_apply(
        spec, med, (plane, y, x), bits, jit,
        params.alpha if alphas is None else alphas, params, H, W,
        qim_dithers=dithers, hdr_bits=hdr_n, return_targets=True)

    # The channel: IFFT -> round/clamp u8 -> FFT. Re-analyze the stego with
    # the same f64 transform the extractor uses.
    spec2, med2, _, _ = backend.analyze(spectral.to_planes(stego), params)
    obs = spec2[plane, y, x]
    err = _wrap(np.angle(obs) - np.angle(targets))
    abs_err = np.abs(err)
    # The write itself: circular distance from the cover's phase to the
    # target — per-bin write energy, the stealth/PSNR lever every mode
    # trades on (doc/ATTACKS.md §1/§1a/§1b).
    werr = _wrap(np.angle(targets) - np.angle(spec[plane, y, x]))

    # Raw pre-ECC flips via the REAL decode rules (what extraction runs).
    idx = (plane, y, x)
    if params.qim:
        dec_h = np.asarray(backend.read_bits(
            spec2, med2, tuple(a[:hdr_n] for a in idx), jit[:hdr_n],
            params.alpha, params))
        dec_p = np.asarray(backend.read_bits_qim(
            spec2, tuple(a[hdr_n:] for a in idx),
            np.asarray(dithers)[hdr_n:], params.qim))
        decoded = np.concatenate([dec_h, dec_p])
    else:
        decoded = np.asarray(backend.read_bits(
            spec2, med2, idx, jit, params.alpha, params))
    flips = decoded.astype(bool) != bits.astype(bool)

    a = params.alpha
    margin_hard = min(a, math.pi - a)
    margin_payload = (math.pi / (2 * params.qim) if params.qim
                      else margin_hard)

    mag = np.abs(targets)
    r = np.hypot(y.astype(np.float64), x.astype(np.float64))

    def _bands(key: np.ndarray, n_bands: int, lo_name: str,
               hi_name: str) -> list[dict]:
        qs = np.quantile(key, np.linspace(0.0, 1.0, n_bands + 1))
        out = []
        for i in range(n_bands):
            m = (key >= qs[i]) & (key <= qs[i + 1] if i == n_bands - 1
                                  else key < qs[i + 1])
            out.append({lo_name: float(qs[i]), hi_name: float(qs[i + 1]),
                        "n": int(m.sum()),
                        "std_rad": float(np.std(err[m])) if m.any()
                        else None})
        return out

    return {
        "n_bins": int(len(bits)),
        "write_rms_rad": float(np.sqrt(np.mean(np.square(werr)))),
        "write_rms_payload_rad": float(
            np.sqrt(np.mean(np.square(werr[hdr_n:])))),
        "noise_std_rad": float(np.std(err)),
        "mean_abs_rad": float(np.mean(abs_err)),
        "p50_rad": float(np.quantile(abs_err, 0.50)),
        "p90_rad": float(np.quantile(abs_err, 0.90)),
        "p99_rad": float(np.quantile(abs_err, 0.99)),
        "max_rad": float(abs_err.max()),
        "margin_header_rad": float(margin_hard),
        "margin_payload_rad": float(margin_payload),
        "raw_flip_rate_header": float(np.mean(flips[:hdr_n])),
        "raw_flip_rate_payload": float(np.mean(flips[hdr_n:])),
        "by_magnitude": _bands(mag, n_mag_bands, "mag_lo", "mag_hi"),
        "by_radius": _bands(r, n_rad_bands, "r_lo", "r_hi"),
    }


def robustness_report(cover: np.ndarray, secret: bytes,
                      params: Params = Params(),
                      master_key: bytes | None = None,
                      password: str | None = None,
                      salt: bytes = bytes([5]) * 16,
                      noise_sigmas=(0.5, 1.0, 2.0, 4.0),
                      jpeg_qualities=(95, 85),
                      seed: int = 0,
                      device=None) -> dict:
    """Post-embed channel robustness: recovery and raw BER under
    pixel-domain AWGN and JPEG recompression (the reference doc/TODO.md
    "BER vs AWGN/JPEG robustness tests" item — proposed there, never
    built).

    AWGN: stego' = clip(round(stego + N(0, sigma))). Phase error at a
    written bin scales ~ sigma*sqrt(HW/2)/mag, so the Rep-7 majority (and
    the soft fallback past it) absorbs small sigma and collapses at a
    cover-dependent knee — this measures WHERE, per cover/params.

    JPEG: encode/decode at each quality (Pillow, already a hard
    dependency of the PNG I/O). Expected and honest: global-FFT phase
    embedding
    does NOT survive JPEG — the 8x8 DCT quantization re-rolls exactly the
    mid-band phases the walk writes. The report exists to state that with
    a number rather than a claim (use lossless PNG end-to-end, as the
    reference requires).

    Returns {"awgn": [{sigma, raw_ber_payload, recovered,
    recovered_soft}...], "jpeg": [{quality, recovered_soft}...]}; raw BER
    comes from pipeline.batch.channel_report's exact frame re-derivation
    (shared-walk corner path only — raw_ber_payload is None for params it
    does not support, e.g. Params.stealth()'s per-image walks; the
    recovery booleans are measured regardless). Every embed, extract and
    channel report runs on `device` (default CUDA); the noise and the JPEG
    codec are host numpy and Pillow.
    """
    from steganosaurus_tpu_torch.pipeline import batch as pbatch_mod
    from steganosaurus_tpu_torch.pipeline.embed import embed_array
    from steganosaurus_tpu_torch.pipeline.extract import extract_array

    def _try(img, p) -> bool:
        try:
            return extract_array(img, master_key=master_key,
                                 password=password, params=p,
                                 device=device) == secret
        except StegoError:
            return False

    res = embed_array(cover, secret, master_key=master_key,
                      password=password, params=params, salt=salt,
                      device=device)
    stego = np.asarray(res.stego)
    rng = np.random.default_rng(seed)
    hard_p = params.replace(soft_decode_fallback=False)
    awgn = []
    for sigma in noise_sigmas:
        noisy = np.clip(np.rint(stego.astype(np.float64)
                                + rng.normal(0.0, sigma, stego.shape)),
                        0, 255).astype(np.uint8)
        try:
            rep = pbatch_mod.channel_report(
                noisy[None], [secret], [salt], master_key=master_key,
                password=password, params=params, device=device)
            raw_ber = float(rep["payload_ber_raw"])
        except StegoError:  # per-image-walk / adaptive / cover-dependent
            raw_ber = None
        awgn.append({
            "sigma": float(sigma),
            "raw_ber_payload": raw_ber,
            "recovered": _try(noisy, hard_p),
            "recovered_soft": _try(noisy, params),
        })
    jpeg = []
    import io as _io

    from PIL import Image  # a hard dependency already (io/image.py)

    for q in jpeg_qualities:
        buf = _io.BytesIO()
        Image.fromarray(stego).save(buf, format="JPEG", quality=int(q))
        back = np.asarray(Image.open(_io.BytesIO(buf.getvalue()))
                          .convert("RGB"))
        jpeg.append({"quality": int(q),
                     "recovered_soft": _try(back, params)})
    return {"awgn": awgn, "jpeg": jpeg}
