"""Single-image embed (the port's twin of steganosaurus_tpu/pipeline/embed.py;
reference do_embed, steganosaur.cpp:907-1109).

  dev : analyze = center + pad + FFT + medians + capacity + cover features
  host: [cover hash] -> salt -> KDF split -> AEAD seal -> ECC frame bits
        -> path key -> turtle walk expansion (C++) -> index arrays
  dev : gather -> phase rotate -> conjugate-mirror scatter -> IFFT -> u8
  host: PNG encode (embed only)

A numpy image is uploaded to `device` (default CUDA); a torch tensor runs on
its own device, and the stego comes back in the input's kind: a numpy array,
or a tensor on that device. Params(fft_dtype="complex128") runs in f64 there:
cuFFT's Z2Z on a card, the f64 host backend on the CPU (pipeline/device.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from steganosaurus_tpu_torch import _build, crypto, keystream, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.io import image as image_io
from steganosaurus_tpu_torch.pipeline import frame
from steganosaurus_tpu_torch.pipeline import header as header_mod
from steganosaurus_tpu_torch.pipeline import qim as qim_mod
from steganosaurus_tpu_torch.pipeline import spread
from steganosaurus_tpu_torch.pipeline.device import backend_input
from steganosaurus_tpu_torch.pipeline.errors import StegoError
from steganosaurus_tpu_torch.utils import debug


@dataclass
class EmbedResult:
    stego: np.ndarray | torch.Tensor  # (H, W, 3) uint8, the input's kind
    written_bits: int
    payload_bytes: int
    capacity_bits: int


def frame_bits(header_bytes: bytes, ct: bytes, tag: bytes,
               rs: bool = False) -> np.ndarray:
    """ECC frame: rep3(bits(header)) || payload-FEC(bits(ct || tag)), the
    payload under Rep-7 or, with rs, interleaved RS(255,223)
    (pipeline/frame.py)."""
    return frame.frame_bits(header_bytes + ct + tag, rs)


def _as_input_kind(stego, img):
    """The stego in the kind of the caller's image: a numpy array for a
    numpy image, a tensor on the image's device for a tensor."""
    if isinstance(img, torch.Tensor):
        if not isinstance(stego, torch.Tensor):
            stego = torch.from_numpy(stego)
        return stego.to(img.device)
    return stego.cpu().numpy() if isinstance(stego, torch.Tensor) else stego


def _refine_coherent(backend, stego, plane, y, x, bits, jit, alphas,
                     dithers, params: Params, H: int, W: int):
    """Iterative requantization refinement for the coherent write (JAX
    _refine_coherent): up to 3 passes of re-reading the frame off the
    quantized stego and re-rotating drifted sites back onto the target.
    Untouched pixels re-round identically, so passes converge; what
    survives is the near-cancelled tail the soft decoders discount.
    Refine passes run with write_floor=0: the corrections are sub-floor by
    construction, and the main pass already delivered the floored energy."""
    refine_p = replace(params, write_floor=0.0)
    hdr_n = frame.HEADER_STREAM_BITS
    want = np.asarray(bits, np.uint8)
    for _ in range(3):
        spec2, med2, _c2, _f2 = backend.analyze(spectral.to_planes(stego),
                                                params, lazy=True)
        got_h = backend.read_bits_coherent(
            spec2, (y[:hdr_n], x[:hdr_n]), jit[:hdr_n], params.alpha)
        if params.qim:
            got_p = backend.read_bits_coherent_qim(
                spec2, (y[hdr_n:], x[hdr_n:]), dithers[hdr_n:], params.qim)
        else:
            got_p = backend.read_bits_coherent(
                spec2, (y[hdr_n:], x[hdr_n:]), jit[hdr_n:], params.alpha)
        if np.array_equal(np.concatenate([got_h, got_p]), want):
            break
        stego = backend.embed_apply(
            spec2, med2, (plane, y, x), bits, jit,
            params.alpha if alphas is None else alphas, refine_p, H, W,
            qim_dithers=dithers, hdr_bits=hdr_n)
    return stego


def embed_array(
    img,
    secret: bytes,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    salt: bytes | None = None,
    device=None,
) -> EmbedResult:
    """Embed `secret` into the (H, W, 3) uint8 image `img` (numpy, or a torch
    tensor that runs on its own device). Exactly one of password /
    master_key must be given; `salt` is injectable for deterministic tests
    (default: 16 CSPRNG bytes)."""
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")

    backend, src, H, W = backend_input(img, params, device)
    PH, PW = spectral.fft_dims(H, W)
    spec, med, capacity, feat = backend.analyze(spectral.to_planes(src),
                                                params)

    if salt is None:
        salt = crypto.get_random_bytes(16)
    km = crypto.derive_keys_vault(password, master_key, salt=salt,
                                  iters=params.pbkdf2_iter)
    flags = 0
    if params.per_image_walk:
        if params.cover_dependent_path:
            raise StegoError(
                "per_image_walk and cover_dependent_path are mutually "
                "exclusive (both re-key the walk per image)")
        flags = header_mod.FLAG_PER_IMAGE_WALK
    if params.coherent:
        if params.adaptive_alpha:
            raise StegoError(
                "coherent and adaptive_alpha are mutually exclusive (a "
                "per-plane magnitude rescale has no common-mode analog)")
        if params.cover_dependent_path:
            raise StegoError(
                "coherent and cover_dependent_path are mutually exclusive "
                "(the coherent payload walk is salt-keyed per image)")
        flags |= header_mod.FLAG_COHERENT
    if params.qim:
        qim_mod.validate(params)
        flags = header_mod.flags_with_qim(flags, params.qim)
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    header_bytes, ct, tag = header_mod.seal_stream(secret, km, flags,
                                                   params.pad_quantum)
    km.close()  # wipe the vault slot: the sealed stream is all we need

    bits = frame_bits(header_bytes, ct, tag, rs=params.rs)
    hdr_n = frame.HEADER_STREAM_BITS
    # a coherent bit consumes a whole (y, x) site: charge capacity 3x
    need = 3 * len(bits) if params.coherent else len(bits)
    if need > capacity:
        raise StegoError(
            f"Message too large. Need {need} bits (after ECC), "
            f"capacity ~{capacity} bits."
        )

    cover_hash = None
    if params.cover_dependent_path:
        cover_hash = crypto.sha256(np.asarray(feat).tobytes())
    path_key = crypto.derive_path_key(password, master_key, cover_hash)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)

    # the pure-Python walk is ~1000x slower than the native one
    _build.ensure_native()
    if params.per_image_walk or params.coherent:
        # header on the shared walk prefix (coherent: the coherent prefix);
        # payload on the salt-keyed walk resuming from its visited state
        hp, hy, hx, hj, vis = keystream.header_walk_with_visited(
            key_walk, (key_r, key_g, key_b), PH, PW,
            params.rmin, params.rmax, params.density, params.jitter, hdr_n,
            coherent=params.coherent)
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, salt))
        try:
            pp, py, px, pj = keystream.turtle_expand_chained(
                skeys[0], skeys[1:], PH, PW,
                params.rmin, params.rmax, params.density, params.jitter,
                len(bits) - hdr_n, vis, coherent=params.coherent)
        except RuntimeError as e:
            raise StegoError(
                f"Message too large. Salt-keyed payload walk exhausted: {e}"
            ) from e
        plane = np.concatenate([hp, pp])
        y = np.concatenate([hy, py])
        x = np.concatenate([hx, px])
        jit = np.concatenate([hj, pj])
    else:
        plane, y, x, jit = keystream.turtle_expand(
            key_walk, (key_r, key_g, key_b), PH, PW,
            params.rmin, params.rmax, params.density, params.jitter,
            len(bits),
        )
    if debug.enabled():  # the reference's -DDEBUG=1 dumps (:1082-1094)
        debug.dump_dims("embed", H, W, PH, PW)
        debug.dump_key_prefix("embed path_key", path_key)
        debug.dump_walk("embed", plane, y, x)
        debug.dump_header("embed header", header_bytes)

    alphas = spread.spread_alphas(path_key, params, len(bits))
    dithers = (qim_mod.dither_angles(path_key, params.qim, len(bits))
               if params.qim else None)
    stego = backend.embed_apply(
        spec, med, (plane, y, x), bits, jit,
        params.alpha if alphas is None else alphas, params, H, W,
        qim_dithers=dithers, hdr_bits=hdr_n,
    )
    if params.coherent:
        stego = _refine_coherent(backend, stego, plane, y, x, bits, jit,
                                 alphas, dithers, params, H, W)
    return EmbedResult(
        stego=_as_input_kind(stego, img),
        written_bits=int(len(bits)),
        payload_bytes=len(secret),
        capacity_bits=int(capacity),
    )


def embed(
    in_path: str,
    out_path: str,
    secret: str,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    device=None,
) -> EmbedResult:
    """File-level embed: load the image, embed, write the stego PNG."""
    try:
        img = image_io.load_rgb(in_path)
    except Exception as e:
        raise StegoError(f"Failed to load {in_path}") from e
    res = embed_array(img, secret.encode(), password=password,
                      master_key=master_key, params=params, device=device)
    image_io.save_png(out_path, res.stego)
    return res
