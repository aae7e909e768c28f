"""Single-image extract (the port's twin of steganosaurus_tpu/pipeline/
extract.py; reference do_extract, steganosaur.cpp:1112-1312).

Two device reads with a host round trip between (clen is data-dependent):
the 38-byte Rep-3 header first, then the payload. The walk key is
salt-independent — SHA256(pass|master) — which makes the header locatable
before the salt is known (reference rationale :1134-1143). A wrong key
fails fast at the magic check, before any PBKDF2; a right walk with a
corrupted payload fails AEAD authentication.

The image is a numpy array (uploaded to `device`, default CUDA) or a torch
tensor, which is read on its own device (the batch path hands its coherent
rows over without a host copy).
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch import _build, crypto, keystream, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.io import image as image_io
from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.ops import rs as rs_mod
from steganosaurus_tpu_torch.pipeline import header as header_mod
from steganosaurus_tpu_torch.pipeline import qim as qim_mod
from steganosaurus_tpu_torch.pipeline.device import backend_input
from steganosaurus_tpu_torch.pipeline.errors import StegoError
from steganosaurus_tpu_torch.pipeline.frame import HEADER_STREAM_BITS
from steganosaurus_tpu_torch.pipeline.header import Header
from steganosaurus_tpu_torch.utils import debug


def _bytes(bits) -> bytes:
    """0/1 bits -> bytes, MSB first, zero-padded (reference :447-454)."""
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def _rep_decode(bits: np.ndarray, n: int) -> np.ndarray:
    """Host Rep-n majority (ops.ecc.rep_decode) of a bit array."""
    return ecc.rep_decode(torch.from_numpy(np.asarray(bits, np.uint8)),
                          n).numpy()


def _rep_decode_soft(values: np.ndarray, n: int) -> np.ndarray:
    """Host matched-filter Rep-n decode (ops.ecc.rep_decode_soft) of f64
    decision values."""
    return ecc.rep_decode_soft(
        torch.from_numpy(np.asarray(values, np.float64)), n).numpy()


def extract_array(
    img,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    device=None,
) -> bytes:
    """Extract and authenticate the secret from a stego image (H, W, 3)
    uint8. Raises StegoError on a missing header, truncation or failed
    authentication."""
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")

    backend, src, H, W = backend_input(img, params, device)
    PH, PW = spectral.fft_dims(H, W)
    spec, med, _capacity, feat = backend.analyze(spectral.to_planes(src),
                                                 params, lazy=True)

    # cover-dependent mode hashes the STEGO's coarse features (mostly
    # stable under the write; reference :1156-1176)
    cover_hash = None
    if params.cover_dependent_path:
        feat = feat.cpu().numpy() if isinstance(feat, torch.Tensor) else feat
        cover_hash = crypto.sha256(np.asarray(feat, np.uint8).tobytes())
    path_key = crypto.derive_path_key(password, master_key, cover_hash)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    plane_keys = (key_r, key_g, key_b)
    _build.ensure_native()

    # --- pass 1: header (38 bytes under Rep-3), two-rule trial ---
    # Rule 1: the standard shared walk and single-plane read. Rule 2 (on a
    # magic failure): the coherent walk and common-mode read, decoded soft
    # (near-cancelled resultants flip hard bits; their soft weight is ~0).
    # Both run before any KDF, so a wrong key still fails fast.
    def _read_header(coh: bool) -> bytes:
        if coh:
            _hp, hy, hx, hj, _vis = keystream.header_walk_with_visited(
                key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
                params.density, params.jitter, HEADER_STREAM_BITS,
                coherent=True)
            hvals = backend.read_values_coherent(spec, (hy, hx), hj,
                                                 params.alpha)
            return _bytes(_rep_decode_soft(hvals, 3))
        idx_p, idx_y, idx_x, jit = keystream.turtle_expand(
            key_walk, plane_keys, PH, PW,
            params.rmin, params.rmax, params.density, params.jitter,
            HEADER_STREAM_BITS,
        )
        if debug.enabled():  # reference -DDEBUG=1 (steganosaur.cpp:1211-)
            debug.dump_dims("extract", H, W, PH, PW)
            debug.dump_key_prefix("extract path_key", path_key)
            debug.dump_walk("extract", idx_p, idx_y, idx_x)
        stream = backend.read_bits(
            spec, med, (idx_p, idx_y, idx_x), jit, params.alpha, params)
        return _bytes(_rep_decode(stream, 3))

    hdr_coh = False
    hdr_bytes = _read_header(False)
    if hdr_bytes[:4] != header_mod.MAGIC:
        hdr_coh = True
        hdr_bytes = _read_header(True)
        if hdr_bytes[:4] != header_mod.MAGIC:
            raise StegoError("Magic not found.")
    debug.dump_header("extract header", hdr_bytes)
    if hdr_bytes[4] != header_mod.VERSION:
        raise StegoError(f"Unsupported version ({hdr_bytes[4]}).")
    hdr = Header.from_bytes(hdr_bytes)

    # --- pass 2: payload ---
    # Walk-capacity bound: each accepted bit marks a bin and its conjugate,
    # so a corrupted clen degrades to "Payload truncated", never to a huge
    # allocation.
    cap_bits = 3 * PH * PW // 2
    rs_on = bool(hdr.flags & header_mod.FLAG_RS_PAYLOAD)
    want_bits = (rs_mod.coded_len(hdr.clen + 16) * 8 if rs_on
                 else (hdr.clen + 16) * 8 * 7)
    payload_stream_bits = min(want_bits, cap_bits)
    total_bits = HEADER_STREAM_BITS + payload_stream_bits
    L = header_mod.qim_levels(hdr.flags)
    if L == 1:
        raise StegoError("Corrupt header (invalid QIM level).")
    coherent = bool(hdr.flags & header_mod.FLAG_COHERENT)

    def read_payload(idx_pyx, jit_arr, skip):
        """Payload stream under the header-selected rule; `skip` is the
        first payload slot's frame-slot index (dither alignment)."""
        if coherent:
            yx = idx_pyx[1:]
            if L:
                d = qim_mod.dither_angles(path_key, L, skip + len(jit_arr))
                return backend.read_bits_coherent_qim(spec, yx, d[skip:], L)
            return backend.read_bits_coherent(spec, yx, jit_arr,
                                              params.alpha)
        if L:
            d = qim_mod.dither_angles(path_key, L, skip + len(jit_arr))
            return backend.read_bits_qim(spec, idx_pyx, d[skip:], L)
        return backend.read_bits(spec, med, idx_pyx, jit_arr, params.alpha,
                                 params)

    if (hdr.flags & header_mod.FLAG_PER_IMAGE_WALK) or coherent:
        # the salt-keyed payload walk resumes from the visited state of the
        # header rule that matched (hdr_coh); allow_short: a corrupted clen
        # degrades to garbage bits that AEAD rejects
        *_, vis = keystream.header_walk_with_visited(
            key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, HEADER_STREAM_BITS,
            coherent=hdr_coh)
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, hdr.salt))
        pp, py, px, pj, _n = keystream.turtle_expand_chained(
            skeys[0], skeys[1:], PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, payload_stream_bits, vis,
            allow_short=True, coherent=coherent)
        payload_stream = read_payload((pp, py, px), pj, HEADER_STREAM_BITS)
    else:
        idx_p, idx_y, idx_x, jit, _n = keystream.turtle_expand(
            key_walk, plane_keys, PH, PW,
            params.rmin, params.rmax, params.density, params.jitter,
            total_bits, allow_short=True,
        )
        sl = slice(HEADER_STREAM_BITS, total_bits)
        payload_stream = read_payload(
            (idx_p[sl], idx_y[sl], idx_x[sl]), jit[sl], HEADER_STREAM_BITS)
    if rs_on:
        coded = _bytes(payload_stream)
        if len(coded) < rs_mod.coded_len(hdr.clen + 16):
            raise StegoError("Payload truncated after ECC decode.")
        # undecodable blocks return their data uncorrected; AEAD rejects
        rest, _rs_ok, _ = rs_mod.rs_decode_interleaved(coded, hdr.clen + 16)
    else:
        rest = _bytes(_rep_decode(payload_stream, 7))
    if len(rest) < hdr.clen + 16:
        raise StegoError("Payload truncated after ECC decode.")
    ct, tag = rest[: hdr.clen], rest[hdr.clen : hdr.clen + 16]

    with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                  iters=params.pbkdf2_iter) as km:
        pt = header_mod.maybe_unpad(
            km.open(hdr_bytes[: header_mod.FIXED_LEN], ct, tag), hdr.flags)
    if pt is None and params.soft_decode_fallback:
        # soft-decision retry: header AND payload re-decoded by
        # matched-filter combining; only after a hard AEAD failure
        pt = _soft_retry(backend, spec, med, password, master_key, params,
                         path_key, key_walk, plane_keys, PH, PW, hdr,
                         payload_stream_bits, hdr_coh)
    if pt is None:
        raise StegoError("Auth failed (wrong pass or data corrupted).")
    return pt


def _rs_soft_decode(pvals, m: int) -> bytes | None:
    """RS errors-and-erasures decode from per-bit decision values: hard
    bits from sign(v), per-coded-byte confidence = min |v| over the byte's
    8 bits (ops/rs.rs_decode_interleaved_soft)."""
    v = np.asarray(pvals, dtype=np.float64)
    need = rs_mod.coded_len(m) * 8
    if v.shape[0] < need:
        return None
    v = v[:need]
    coded = _bytes((v >= 0).astype(np.uint8))
    conf = np.abs(v).reshape(-1, 8).min(axis=1)
    rest, _ok = rs_mod.rs_decode_interleaved_soft(coded, m, conf)
    return rest


def _soft_retry(backend, spec, med, password, master_key, params, path_key,
                key_walk, plane_keys, PH, PW, hard_hdr,
                payload_stream_bits, hdr_coh: bool = False) -> bytes | None:
    """One soft-decision re-decode of header + payload; None if still bad.
    hdr_coh: which header rule the hard pass matched — the soft re-read
    uses the same walk and read rule."""
    hp, hy, hx, hj, vis = keystream.header_walk_with_visited(
        key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
        params.density, params.jitter, HEADER_STREAM_BITS,
        coherent=hdr_coh)
    if hdr_coh:
        hvals = backend.read_values_coherent(spec, (hy, hx), hj,
                                             params.alpha)
    else:
        hvals = backend.read_values(spec, med, (hp, hy, hx), hj,
                                    params.alpha, params)
    hdr_bytes = _bytes(_rep_decode_soft(hvals, 3))
    if hdr_bytes[:4] != header_mod.MAGIC or hdr_bytes[4] != header_mod.VERSION:
        return None
    hdr = Header.from_bytes(hdr_bytes)
    rs_on = bool(hdr.flags & header_mod.FLAG_RS_PAYLOAD)
    if hdr.clen != hard_hdr.clen or rs_on != bool(
            hard_hdr.flags & header_mod.FLAG_RS_PAYLOAD):
        # soft-corrected clen or FEC flag: resize the read
        want = (rs_mod.coded_len(hdr.clen + 16) * 8 if rs_on
                else (hdr.clen + 16) * 8 * 7)
        payload_stream_bits = min(want, 3 * PH * PW // 2)
    L = header_mod.qim_levels(hdr.flags)
    if L == 1:
        return None
    coherent = bool(hdr.flags & header_mod.FLAG_COHERENT)
    if (hdr.flags & header_mod.FLAG_PER_IMAGE_WALK) or coherent:
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, hdr.salt))
        pp, py, px, pj, _n = keystream.turtle_expand_chained(
            skeys[0], skeys[1:], PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, payload_stream_bits, vis,
            allow_short=True, coherent=coherent)
    else:
        total = HEADER_STREAM_BITS + payload_stream_bits
        pp, py, px, pj, _n = keystream.turtle_expand(
            key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, total, allow_short=True)
        sl = slice(HEADER_STREAM_BITS, total)
        pp, py, px, pj = pp[sl], py[sl], px[sl], pj[sl]
    if L:
        d = qim_mod.dither_angles(path_key, L,
                                  HEADER_STREAM_BITS + len(pj))
        d = d[HEADER_STREAM_BITS:]
    if coherent:
        pvals = (backend.read_values_coherent_qim(spec, (py, px), d, L) if L
                 else backend.read_values_coherent(spec, (py, px), pj,
                                                   params.alpha))
    elif L:
        pvals = backend.read_values_qim(spec, (pp, py, px), d, L)
    else:
        pvals = backend.read_values(spec, med, (pp, py, px), pj,
                                    params.alpha, params)
    if rs_on:
        rest = _rs_soft_decode(pvals, hdr.clen + 16)
        if rest is None:
            return None
    else:
        rest = _bytes(_rep_decode_soft(pvals, 7))
    if len(rest) < hdr.clen + 16:
        return None
    ct, tag = rest[: hdr.clen], rest[hdr.clen: hdr.clen + 16]
    # unpad under THIS (soft-corrected) header's flags
    with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                  iters=params.pbkdf2_iter) as km:
        return header_mod.maybe_unpad(
            km.open(hdr_bytes[: header_mod.FIXED_LEN], ct, tag), hdr.flags)


def extract(
    in_path: str,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    device=None,
) -> bytes:
    """File-level extract."""
    try:
        img = image_io.load_rgb(in_path)
    except Exception as e:
        raise StegoError(f"Failed to load {in_path}") from e
    return extract_array(img, password=password, master_key=master_key,
                         params=params, device=device)
