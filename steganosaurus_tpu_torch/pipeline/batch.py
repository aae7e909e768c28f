"""Batched embed/extract under one shared key (the throughput path), in torch.

The port's twin of steganosaurus_tpu/pipeline/batch.py for the shared-walk
corner fast path on one device, in the reference wire format (FLAGS = 0:
hard write, Rep-3 header, Rep-7 payload): secrets of equal or unequal
length, Params.jitter, embed with read-back verification and re-salting,
extract with the inline soft decode and the soft-decision retry pass, the
channel report, and the walk prefetch that pipeline/stream.py runs on a
worker thread.

- host: per-image AEAD and header framing, ONE turtle-walk expansion for
  the batch (the walk key is salt-independent, steganosaur.cpp:1134-1143);
  both come from the JAX package's jax-free modules (crypto, keystream).
- device: the walk indices and the static slot maps live on the device,
  cached per key; covers cross to the device once as u8 and may stay there
  (pass a CUDA tensor, get a CUDA tensor back with device_resident=True).
- no hidden host sync: uploads go through pinned memory without blocking
  (runtime.upload) and each pull waits only for its own work
  (runtime.HostCopy), so embed_batch and extract_dispatch queue their
  device work and return; pipeline/stream.py overlaps batches on that.

Params the port does not carry yet raise StegoError naming the field
(_check_params). The images' device is the input tensor's device, else the
`device` argument, else CUDA (runtime.resolve_device).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from steganosaurus_tpu import crypto, keystream
from steganosaurus_tpu.config import Params
from steganosaurus_tpu_torch import _build, runtime, spectral
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.pipeline import header as header_mod
from steganosaurus_tpu_torch.pipeline.errors import StegoError
from steganosaurus_tpu_torch.pipeline.header import Header
from steganosaurus_tpu_torch.spectral import corner
from steganosaurus_tpu_torch.utils import metrics

_HEADER_STREAM_BITS = header_mod.FIXED_LEN * 8 * 3

# Params fields whose non-default values the port does not implement yet,
# with the default each must hold.
_UNSUPPORTED = (("soft_write", False), ("qim", 0), ("rs", False),
                ("alpha_spread", 0.0), ("per_image_walk", False),
                ("pad_quantum", 0), ("adaptive_alpha", False),
                ("coherent", False), ("cover_dependent_path", False))


def _check_params(params: Params, mesh) -> None:
    for field, default in _UNSUPPORTED:
        if getattr(params, field) != default:
            raise StegoError(f"Params.{field}={getattr(params, field)!r} is "
                             f"not supported by steganosaurus_tpu_torch yet")
    if mesh is not None:
        raise StegoError("mesh is not supported by steganosaurus_tpu_torch "
                         "yet (single device only)")


def _check_key(password, master_key) -> None:
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")


def _dims(imgs, layout: str) -> tuple[int, int, int]:
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    shape = tuple(imgs.shape)
    if len(shape) != 4 or shape[1 if layout == "nchw" else 3] != 3:
        raise ValueError(f"images must be {layout} with 3 channels, got "
                         f"shape {shape}")
    if layout == "nchw":
        B, _, H, W = shape
    else:
        B, H, W, _ = shape
    return B, H, W


def _to_device(imgs, dev: torch.device) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        t = imgs
    else:
        a = np.ascontiguousarray(imgs)
        # torch.from_numpy shares memory and warns on read-only buffers
        # (e.g. a JAX array's numpy view): copy those
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dtype != torch.uint8:
        raise ValueError(f"images must be uint8, got {t.dtype}")
    return t.to(dev)


def _rows(t: torch.Tensor, idx: list[int], dev) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(index tensor on dev, t's rows idx): exactly those rows, with no
    power-of-two padding — eager torch and K1 take any batch size, unlike
    the JAX package's jitted modules (its _bucket_sel)."""
    sel = runtime.upload(np.asarray(idx, np.int64), dev)
    return sel, t.index_select(0, sel)


@dataclass
class BatchEmbedResult:
    stego: np.ndarray | torch.Tensor  # numpy, or a device tensor if
    #                                   device_resident
    written_bits: list[int]
    payload_bytes: list[int]
    salts: list[bytes] | None = None      # final per-image salts (verify
    #                                       may re-salt failed images)
    verified: list[bool] | None = None    # per-image read-back success
    #                                       (None unless verify=True)


def _walk_indices(password, master_key, params, PH, PW, nbits,
                  allow_short=False):
    # the pure-Python walk is ~1000x slower than the native one: build the
    # native library if missing, and raise rather than fall back to it
    _build.ensure_native()
    path_key = crypto.derive_path_key(password, master_key, None)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    return keystream.turtle_expand(
        key_walk, (key_r, key_g, key_b), PH, PW,
        params.rmin, params.rmax, params.density, params.jitter, nbits,
        allow_short=allow_short,
    )


# Device-resident walk indices and static maps, keyed by everything they are
# a pure function of (path key, dims, walk params, slice, device): one
# expansion and one upload serve every later batch under the key. Plain
# OrderedDicts, used from the calling thread only (prefetch_walk never
# touches them).
_DEV_IDX_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_CORNER_STATICS_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_DEV_CACHE_MAX = 16


def _cache_put(cache: OrderedDict, key, ent):
    cache[key] = ent
    cache.move_to_end(key)
    while len(cache) > _DEV_CACHE_MAX:
        cache.popitem(last=False)
    return ent


def _walk_indices_device(password, master_key, params, PH, PW, nbits, skip,
                         bucket, device):
    """((plane, y, x) int64 and jitter f32 device tensors of length `bucket`
    covering walk bits [skip, nbits), tail-padded with the last index,
    nproduced). nproduced < nbits means the walk exhausted (reads past it
    re-read the last bin; embed treats it as capacity exceeded)."""
    path_key = crypto.derive_path_key(password, master_key, None)
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, skip, bucket, nbits, device)
    ent = _DEV_IDX_CACHE.get(key)
    if ent is None:
        plane, y, x, jit, nprod = _walk_indices(password, master_key, params,
                                                PH, PW, nbits,
                                                allow_short=True)
        pad = bucket - (nbits - skip)
        sl = slice(skip, nbits)
        host = [np.concatenate([a[sl], np.repeat(a[nbits - 1], pad)])
                for a in (plane, y, x, jit)]
        arrs = tuple(runtime.upload(a.astype(np.int64), device)
                     for a in host[:3])
        arrs += (runtime.upload(host[3].astype(np.float32), device),)
        ent = (arrs, nprod)
    return _cache_put(_DEV_IDX_CACHE, key, ent)


def _corner_statics_device(password, master_key, params, PH, PW, nbits,
                           bucket, Ky, Kx, device):
    """(maps, nprod): the static corner maps of the walk's first `bucket`
    slots (parallel.batch.corner_statics_core) — the JAX package's maps
    tuple for the Params the port carries: (pos,), or (pos, cjd, sjd) when
    Params.jitter != 0."""
    path_key = crypto.derive_path_key(password, master_key, None)
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, nbits, bucket, Ky, Kx, device)
    ent = _CORNER_STATICS_CACHE.get(key)
    if ent is None:
        (plane, y, x, jit), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nbits, 0, bucket, device)
        maps = pbatch.corner_statics_core(
            plane, y, x, Ky, Kx, bucket,
            jit if params.jitter != 0.0 else None)
        ent = (maps, nprod)
    return _cache_put(_CORNER_STATICS_CACHE, key, ent)


def prefetch_walk(password, master_key, params: Params, H: int, W: int,
                  secret_lens: list[int]) -> None:
    """Warm the HOST walk cache (keystream) for (key, dims, params) ahead
    of use, shared walk only.

    The turtle walk is the pipeline's one strictly sequential host cost
    (~1.2 s for a fresh key at 4K/16 KB); pipeline.stream runs this on a
    worker thread when a stream's key rotates, so the expansion overlaps the
    batches in flight instead of stalling the next embed_batch. It touches
    only keystream's cache, which is locked, never _DEV_IDX_CACHE or
    _CORNER_STATICS_CACHE. Errors are swallowed, as the JAX package's
    prefetch_walk does: the next embed_batch under the key raises them with
    full context, and nothing else depends on this call."""
    try:
        PH, PW = spectral.fft_dims(H, W)
        nmax = max(_HEADER_STREAM_BITS + (n + 16) * 8 * 7
                   for n in secret_lens)
        _walk_indices(password, master_key, params, PH, PW, nmax,
                      allow_short=True)
    except Exception:  # noqa: BLE001 — deliberately quiet (see docstring)
        pass


def _frame_bits(stream: bytes) -> np.ndarray:
    """header||ct||tag -> the on-wire u8 frame bits: Rep-3 over the 304
    header bits, then Rep-7 over the payload bits, MSB first (reference
    frame layout, steganosaur.cpp:986-995)."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    hdr = header_mod.FIXED_LEN * 8
    return np.concatenate([np.repeat(bits[:hdr], 3),
                           np.repeat(bits[hdr:], 7)])


def _host_frames(streams: list[bytes], bucket: int) -> np.ndarray:
    """(B, bucket) u8 frames of unequal-length streams, each padded with its
    own last bit (the JAX embed_batch _host_frames)."""
    bits = np.empty((len(streams), bucket), np.uint8)
    for i, s in enumerate(streams):
        f = _frame_bits(s)
        bits[i, :len(f)] = f
        bits[i, len(f):] = f[-1]
    return bits


def _seal_streams(secrets, salts, password, master_key, params) -> list:
    """header||ct||tag per image, FLAGS = 0 (the reference wire format)."""
    streams = []
    for secret, salt in zip(secrets, salts):
        with crypto.derive_keys_vault(password, master_key, salt=salt,
                                      iters=params.pbkdf2_iter) as km:
            hdr_bytes, ct, tag = header_mod.seal_stream(secret, km, 0, 0)
        streams.append(hdr_bytes + ct + tag)
    return streams


def embed_batch(
    imgs,
    secrets: list[bytes],
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    salts: list[bytes] | None = None,
    mesh=None,
    device_resident: bool = False,
    verify: bool = False,
    max_retries: int = 2,
    layout: str = "nhwc",
    device=None,
) -> BatchEmbedResult:
    """Embed `secrets[i]` into `imgs[i]` under one shared password/master key.

    imgs: u8 (B, H, W, 3) for layout="nhwc" or (B, 3, H, W) for "nchw" — a
    numpy array (uploaded to `device`, default CUDA) or a torch tensor
    (processed on its own device). The stego keeps the input layout; it is
    a tensor on that device when device_resident, else a numpy array.

    Secrets may differ in length: every frame is padded to the longest by
    repeating its own last bit (surplus bins are never read back). Equal
    lengths upload the sealed streams and expand the ECC on the device;
    unequal ones upload host-built frames.

    verify=True reads every image back (extract_batch, clen_hint the longest
    secret) and re-embeds the failures with fresh salts up to max_retries
    times, writing the new rows into the stego in place. Result.verified
    reports each image; result.salts the final salts. Explicit `salts` are
    respected on the first attempt only.
    """
    _check_key(password, master_key)
    _check_params(params, mesh)
    B, H, W = _dims(imgs, layout)
    if len(secrets) != B:
        raise ValueError(f"{len(secrets)} secrets for {B} images")
    dev = runtime.resolve_device(device, like=imgs)
    imgs_d = _to_device(imgs, dev)
    PH, PW = spectral.fft_dims(H, W)

    if salts is None:
        salts = [crypto.get_random_bytes(16) for _ in range(B)]
    if len(salts) != B:
        raise ValueError(f"{len(salts)} salts for {B} images")
    streams = _seal_streams(secrets, salts, password, master_key, params)
    frame_lens = [_HEADER_STREAM_BITS
                  + (len(s) - header_mod.FIXED_LEN) * 8 * 7 for s in streams]
    nmax = max(frame_lens)
    # one walk serves the batch, bucketed to a 4096 multiple; surplus slots
    # repeat the last (bin, bit) pair and are never read back
    bucket = -(-nmax // 4096) * 4096
    Ky, Kx = corner.corner_dims(PH, PW, params.rmax)
    maps, nprod = _corner_statics_device(password, master_key, params, PH, PW,
                                         nmax, bucket, Ky, Kx, dev)
    if nprod < nmax:
        raise StegoError(f"Message too large. Need {nmax} bits (after ECC), "
                         f"walk exhausted after {nprod}.")
    if len(set(frame_lens)) == 1:
        words = runtime.upload(bit_ops.pack_bytes_words_host(streams), dev)
        frame = pbatch._frame_from_words(words, len(streams[0]), bucket)
    else:
        words = runtime.upload(
            bit_ops.pack_bits_words_host(_host_frames(streams, bucket)), dev)
        frame = bit_ops.unpack_bits_words(words, bucket)
    stego = pbatch.corner_embed_core(
        imgs_d, frame, maps, params.alpha, Ky=Ky, Kx=Kx,
        center=params.center, layout=layout, floor=params.write_floor)

    salts = list(salts)
    verified = None
    if verify:
        maxlen = max(len(s) for s in secrets)
        got = extract_batch(stego, password=password, master_key=master_key,
                            params=params, clen_hint=maxlen, layout=layout)
        verified = [g == s for g, s in zip(got, secrets)]
        for _ in range(max_retries):
            failed = [i for i, ok in enumerate(verified) if not ok]
            if not failed:
                break
            sel, sub_imgs = _rows(imgs_d, failed, dev)
            new_salts = [crypto.get_random_bytes(16) for _ in failed]
            sub = embed_batch(sub_imgs, [secrets[i] for i in failed],
                              password=password, master_key=master_key,
                              params=params, salts=new_salts,
                              device_resident=True, layout=layout)
            stego.index_copy_(0, sel, sub.stego)
            got = extract_batch(stego, password=password,
                                master_key=master_key, params=params,
                                clen_hint=maxlen, layout=layout)
            for i, s_new in zip(failed, new_salts):
                salts[i] = s_new
            verified = [g == s for g, s in zip(got, secrets)]
    return BatchEmbedResult(
        stego=stego if device_resident else stego.cpu().numpy(),
        written_bits=frame_lens,
        payload_bytes=[len(s) for s in secrets],
        salts=salts,
        verified=verified,
    )


def channel_report(
    stego,
    secrets: list[bytes],
    salts: list[bytes],
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    layout: str = "nhwc",
    per_image: bool = False,
    device=None,
) -> dict:
    """Channel quality: raw and post-ECC BER of header and payload, averaged
    over the batch (utils.metrics.ecc_report per image). per_image=True
    adds a "per_image" list with each image's report.

    Re-derives each image's on-wire frame from (secret, salt) — the AEAD is
    deterministic given the salt — and reads the raw bits back at the walk
    bins of the stego batch. Post-ECC BER > 0 on an image means its AEAD
    fails and verify would re-salt it. The Rep-7 payload only: Params.rs
    (and every other field the port does not carry) raises StegoError
    naming the field."""
    _check_key(password, master_key)
    _check_params(params, mesh)
    B, H, W = _dims(stego, layout)
    if len(secrets) != B or len(salts) != B:
        raise ValueError(f"{len(secrets)} secrets and {len(salts)} salts for "
                         f"{B} images")
    dev = runtime.resolve_device(device, like=stego)
    stego_d = _to_device(stego, dev)
    PH, PW = spectral.fft_dims(H, W)
    frames = [_frame_bits(s) for s in
              _seal_streams(secrets, salts, password, master_key, params)]
    nmax = max(len(f) for f in frames)
    bucket = -(-nmax // 4096) * 4096
    (pl, yy, xx, jj), nprod = _walk_indices_device(
        password, master_key, params, PH, PW, nmax, 0, bucket, dev)
    if nprod < nmax:
        raise StegoError("stego batch cannot carry the claimed frames")
    Ky, Kx = corner.corner_dims(PH, PW, params.rmax)
    words = pbatch.corner_raw_bits_core(
        stego_d, params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
        center=params.center, layout=layout,
        jit=jj if params.jitter != 0.0 else None)
    got = bit_ops.unpack_words_host(runtime.HostCopy(words).numpy(), bucket)
    reports = [metrics.ecc_report(f, got[i, :len(f)], _HEADER_STREAM_BITS)
               for i, f in enumerate(frames)]
    out = {k: float(np.mean([r[k] for r in reports])) for k in reports[0]}
    if per_image:
        out["per_image"] = [{k: float(v) for k, v in r.items()}
                            for r in reports]
    return out


def _parse_hdr(buf: bytes) -> Header | None:
    """A header this slice can read: right magic and version, and FLAGS == 0
    (any wire-mode bit — per-image walk, RS, padding, coherent, QIM — is not
    ported yet)."""
    hb = buf[:header_mod.FIXED_LEN]
    if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
        return None
    if hb[5] != 0:
        return None
    return Header.from_bytes(hb)


def _to_bufs(words: np.ndarray) -> list[bytes]:
    """(B, k) int32 rows -> per-image byte strings (big-endian words)."""
    return [w.view(np.uint32).astype(">u4").tobytes() for w in words]


class _ExtractJob:
    """An in-flight batch extraction. The fused header + hinted payload pass
    and the copy of its hard rows to the host are queued on the device at
    construction (CUDA work is asynchronous) and waited for only in
    finalize(), so host work between the two overlaps it."""

    def __init__(self, imgs, password, master_key, params, mesh, clen_hint,
                 layout="nhwc", device=None):
        _check_key(password, master_key)
        _check_params(params, mesh)
        self.B, H, W = _dims(imgs, layout)
        self._layout = layout
        dev = runtime.resolve_device(device, like=imgs)
        self._imgs_d = _to_device(imgs, dev)
        self._dev = dev
        PH, PW = spectral.fft_dims(H, W)
        self._key = (password, master_key)
        self._params = params
        self._dims = (PH, PW)
        self._corner_kk = corner.corner_dims(PH, PW, params.rmax)
        # Walk capacity upper bound: each accepted bit marks a bin and its
        # conjugate. Bounds the gather under a corrupt header clen and an
        # oversized hint.
        self._cap_bits = 3 * PH * PW // 2
        self._hint_bits = (min(self._payload_bits(clen_hint), self._cap_bits)
                           if clen_hint else 0)
        self._covered_payload_bits = 0  # set by the with_header pass
        self._result: list[bytes | None] | None = None
        self._pending = self._dispatch_pass(self._hint_bits, True)

    @staticmethod
    def _payload_bits(clen: int) -> int:
        """Rep-7 payload stream bits for a ciphertext length."""
        return (clen + 16) * 8 * 7

    def _walk(self, total: int, skip: int, bucket_total: int):
        """Walk plane/y/x of slots [skip, total), padded to bucket_total -
        skip, and their jitter angles (None when Params.jitter == 0)."""
        password, master_key = self._key
        PH, PW = self._dims
        (pl, yy, xx, jj), _ = _walk_indices_device(
            password, master_key, self._params, PH, PW, total, skip,
            bucket_total - skip, self._dev)
        return pl, yy, xx, (jj if self._params.jitter != 0.0 else None)

    def _dispatch_pass(self, payload_stream_bits: int, with_header: bool):
        """Queue one read + ECC-decode pass; returns (hard, soft, info): the
        HostCopy of the hard rows, and — with soft_decode_fallback on — the
        soft rows left on the device and the pass's section layout
        (hdr_bits, n_slots), else None and None.

        The total frame length is bucketed to a 4096 multiple exactly as
        embed_batch buckets a frame of that length, so an embed -> extract
        round trip shares one cached walk upload. With no payload bits this
        is the header-only probe: 912 slots, no rounding."""
        hdr = _HEADER_STREAM_BITS
        if payload_stream_bits:
            total = hdr + payload_stream_bits
            bucket_total = -(-total // 4096) * 4096
        else:
            total = bucket_total = hdr
        hdr_bits = hdr if with_header else 0
        skip = 0 if with_header else hdr
        if with_header:
            # slots [total, bucket_total) duplicate slot total-1; only the
            # unrounded payload bits are genuinely readable
            self._covered_payload_bits = total - hdr
        pl, yy, xx, jj = self._walk(total, skip, bucket_total)
        with_soft = bool(self._params.soft_decode_fallback)
        Ky, Kx = self._corner_kk
        words = pbatch.corner_extract_fused_core(
            self._imgs_d, self._params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
            center=self._params.center, layout=self._layout,
            hdr_stream_bits=hdr_bits, with_soft=with_soft, jit=jj)
        if not with_soft:
            return runtime.HostCopy(words), None, None
        hard, soft = words
        return runtime.HostCopy(hard), soft, (hdr_bits, bucket_total - skip)

    @staticmethod
    def _soft_sections(soft_d, info) -> list[bytes]:
        """Pull a pass's soft rows and split them per image; the word count
        mirrors the device-side packing exactly (checked)."""
        hdr_bits, n_slots = info
        hw = (hdr_bits // 3 + 31) // 32 if hdr_bits else 0
        pw = ((n_slots - hdr_bits) // 7 + 31) // 32
        words = runtime.HostCopy(soft_d).numpy()
        if words.shape[1] != hw + pw:
            raise RuntimeError(
                f"soft-row word-layout mismatch: device rows have "
                f"{words.shape[1]} words, host expects {hw + pw}")
        return _to_bufs(words)

    def _open_payload(self, hdr: Header, payload: bytes) -> bytes | None:
        """AEAD-open a Rep-7-decoded payload section under `hdr`; None when
        it is short or fails authentication."""
        password, master_key = self._key
        rest = payload[: hdr.clen + 16]
        if len(rest) < hdr.clen + 16:
            return None
        ct, tag = rest[: hdr.clen], rest[hdr.clen:]
        with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                      iters=self._params.pbkdf2_iter) as km:
            return header_mod.maybe_unpad(
                km.open(hdr.to_bytes(), ct, tag), hdr.flags)

    def finalize(self) -> list[bytes | None]:
        """Wait for the fused pass, parse headers, run a payload-only second
        pass if the hint was too small, AEAD-open everything, retry failures
        from the same pass's matched-filter soft sections, then run the
        soft-decision retry pass over what still fails. Idempotent."""
        if self._pending is None:
            if self._result is not None:
                return self._result
            raise StegoError("extract job already failed; re-dispatch it")
        hard0, soft0_d, info0 = self._pending
        self._pending = None
        bufs = _to_bufs(hard0.numpy())
        pulled: dict[int, list[bytes]] = {}

        def _soft_of(soft_d, info):
            key = id(soft_d)
            if key not in pulled:
                pulled[key] = self._soft_sections(soft_d, info)
            return pulled[key]

        headers = [_parse_hdr(b) for b in bufs]
        if soft0_d is not None and any(h is None for h in headers):
            # a header the hard Rep-3 majority corrupted can still parse
            # from the matched-filter sections of the same pass
            soft_bufs0 = _soft_of(soft0_d, info0)
            for i, h in enumerate(headers):
                if h is None:
                    headers[i] = _parse_hdr(soft_bufs0[i])
        idxs = [i for i, h in enumerate(headers) if h is not None]
        if not idxs:
            self._result = [None] * self.B
            return self._result

        payloads: list[bytes | None] = [None] * self.B
        # (soft rows, pass info, payload byte offset) per image, consulted
        # only if that image's hard open fails
        soft_src: list[tuple | None] = [None] * self.B
        clens = {i: headers[i].clen for i in idxs}
        big = [i for i in idxs
               if self._payload_bits(clens[i]) >= self._cap_bits]
        if big and soft0_d is not None:
            # one Rep-3-corrupted clen would size the whole group's pass to
            # full capacity: size by the smaller of the hard and soft claims
            soft_bufs0 = _soft_of(soft0_d, info0)
            for i in big:
                h2 = _parse_hdr(soft_bufs0[i])
                if h2 is not None:
                    clens[i] = min(clens[i], h2.clen)
        need = min(self._payload_bits(max(clens.values())), self._cap_bits)
        if need <= self._covered_payload_bits:
            # the fused pass already decoded the payload: it follows the
            # 40-byte header block (38 bytes + 2 pad)
            for i in idxs:
                payloads[i] = bufs[i][40:]
                if soft0_d is not None:
                    soft_src[i] = (soft0_d, info0, 40)
        else:  # hint too small or absent: payload-only pass
            ghard, gsoft_d, ginfo = self._dispatch_pass(need, False)
            grp = _to_bufs(ghard.numpy())
            for i in idxs:
                payloads[i] = grp[i]
                if gsoft_d is not None:
                    soft_src[i] = (gsoft_d, ginfo, 0)

        out: list[bytes | None] = []
        for i, hdr in enumerate(headers):
            if hdr is None:
                out.append(None)
                continue
            got = self._open_payload(hdr, payloads[i])
            soft_pay = None
            if got is None and soft_src[i] is not None:
                sd, info, off = soft_src[i]
                soft_pay = _soft_of(sd, info)[i][off:]
                got = self._open_payload(hdr, soft_pay)
            if got is None and soft0_d is not None:
                # a parseable hard header can still carry corrupted
                # salt/clen/nonce bits; the soft header usually holds the
                # true bytes
                h2 = _parse_hdr(_soft_of(soft0_d, info0)[i])
                if h2 is not None and h2.to_bytes() != hdr.to_bytes():
                    got = self._open_payload(h2, payloads[i])
                    if got is None and soft_pay is not None:
                        got = self._open_payload(h2, soft_pay)
            out.append(got)
        if self._params.soft_decode_fallback and any(
                h is not None and o is None for h, o in zip(headers, out)):
            self._soft_retry_failed(headers, out)
        self._result = out
        return out

    def _soft_pass(self, grp: list[int], hdrs: dict) -> list[bytes]:
        """One corner_soft_extract_core pass over exactly the rows `grp`,
        sized by the largest clen their headers `hdrs` claim; returns the
        decoded rows ([40-byte header block | payload]) per image of grp."""
        need = min(max(self._payload_bits(hdrs[i].clen) for i in grp),
                   self._cap_bits)
        total = _HEADER_STREAM_BITS + need
        pl, yy, xx, jj = self._walk(total, 0, -(-total // 4096) * 4096)
        imgs = (self._imgs_d if len(grp) == self.B
                else _rows(self._imgs_d, grp, self._dev)[1])
        Ky, Kx = self._corner_kk
        words = pbatch.corner_soft_extract_core(
            imgs, self._params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
            center=self._params.center, layout=self._layout,
            hdr_stream_bits=_HEADER_STREAM_BITS, jit=jj)
        return _to_bufs(runtime.HostCopy(words).numpy())

    def _soft_retry_failed(self, headers, out) -> None:
        """Soft-decision re-decode of the images whose header parsed but
        whose payload failed AEAD (JAX _ExtractJob._soft_retry_failed, the
        shared-walk groups): one pass over exactly those rows re-reads
        header AND payload by matched-filter combining of the Rep-3/Rep-7
        copies in f32. Recovers margin failures the hard majority loses.

        Round 2 re-reads an image whose soft header disagrees with the one
        it was read under in salt or clen (a flip the hard Rep-3 majority
        kept can mis-size or mis-key the pass). A soft header with any FLAGS
        bit reads as None: this slice reads FLAGS = 0 only. Mutates `out`;
        images that still fail stay None."""
        cur = {i: h for i, (h, o) in enumerate(zip(headers, out))
               if h is not None and o is None}
        for round_ in range(2):
            grp = list(cur)
            retry: dict[int, Header] = {}
            for i, buf in zip(grp, self._soft_pass(grp, cur)):
                h2 = _parse_hdr(buf)
                got = (self._open_payload(h2, buf[40:]) if h2 is not None
                       else None)
                if got is not None:
                    out[i] = got
                elif round_ == 0 and h2 is not None and (
                        h2.clen != cur[i].clen or h2.salt != cur[i].salt):
                    retry[i] = h2
            cur = retry
            if not cur:
                break


def extract_dispatch(imgs, password: str | None = None,
                     master_key: bytes | None = None,
                     params: Params = Params(), mesh=None,
                     clen_hint: int | None = None, layout: str = "nhwc",
                     device=None) -> _ExtractJob:
    """Queue a batch extraction; call .finalize() for the results."""
    return _ExtractJob(imgs, password, master_key, params, mesh, clen_hint,
                       layout, device)


def extract_batch(imgs, password: str | None = None,
                  master_key: bytes | None = None,
                  params: Params = Params(), mesh=None,
                  clen_hint: int | None = None, layout: str = "nhwc",
                  device=None) -> list[bytes | None]:
    """Extract secrets from a batch of stego images (shared key).

    Returns one bytes per image, or None where extraction failed: bad magic
    or version, truncation, authentication failure — and, in this port, a
    header whose FLAGS byte is not 0, since the wire modes those bits select
    (per-image walk, RS, padding, coherent, QIM) are not ported yet. One bad
    image never aborts the batch. With Params.soft_decode_fallback (the
    default) an image that fails the hard decode is retried from the fused
    pass's inline matched-filter soft sections, then by the separate
    soft-decision retry pass.

    clen_hint: expected ciphertext length (the secret length). With it the
    header and payload decode in one device pass; a hint that is too small
    costs a second pass, never a wrong result.
    """
    return _ExtractJob(imgs, password, master_key, params, mesh, clen_hint,
                       layout, device).finalize()
