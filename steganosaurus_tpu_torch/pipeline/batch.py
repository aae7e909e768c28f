"""Batched embed/extract under one shared key (the throughput path), in torch.

The port's twin of steganosaurus_tpu/pipeline/batch.py for the corner fast
path on one device or over a mesh of them (mesh=: the batch axis split
over parallel.make_mesh's devices, each shard's rows through the same
single-device cores), in every corner wire mode the JAX batch path writes:
the hard or soft write (Params.soft_write), jitter, per-bin amplitudes
(Params.alpha_spread), dithered phase QIM on the payload (Params.qim), the
Rep-7 or RS(255,223) payload (Params.rs), length padding
(Params.pad_quantum), the shared walk or per-image walks
(Params.per_image_walk), and any composition of them (Params.stealth()).
Secrets may differ in length; embed verifies and re-salts on request;
extract reads every mode from the header's FLAGS (mixed batches too), with
the inline soft decode and the soft-decision retry pass; the channel report
and the walk prefetches that pipeline/stream.py runs on a worker thread
complete the surface.

- host: per-image AEAD and header framing, RS coding (ops/rs.py), ONE
  turtle-walk expansion for a shared-walk batch (the walk key is
  salt-independent, steganosaur.cpp:1134-1143), or the shared header
  prefix plus one salt-keyed payload walk per image on a thread pool; all
  from the JAX package's jax-free modules (crypto, keystream, ops.rs).
- device: shared-walk indices, per-slot keyed values and static maps live
  on the device, cached per key; covers cross to the device once as u8 and
  may stay there (pass a CUDA tensor, get a CUDA tensor back with
  device_resident=True).
- no hidden host sync: uploads go through pinned memory without blocking
  (runtime.upload) and each pull waits only for its own work
  (runtime.HostCopy), so embed_batch and extract_dispatch queue their
  device work and return; pipeline/stream.py overlaps batches on that.

Params.adaptive_alpha batches run the full-grid cores (one FFT per image,
the per-bin write and read of ops/phase.py); extraction hands a row whose
header carries FLAG_COHERENT, or fails both the hard and the soft parse, to
the single-image extract_array (pipeline/extract.py) on its own device, as
the JAX package does. Params the JAX batch path refuses are refused with
its errors: cover_dependent_path and coherent embeds (both per-image: use
embed_array), cover_dependent_path extracts, layout="nchw" with
adaptive_alpha, and channel_report outside the shared-walk corner path.
The images' device is the input tensor's device, else the `device`
argument, else CUDA (runtime.resolve_device).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from steganosaurus_tpu_torch import _build, crypto, keystream, runtime, spectral
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.ops import rs as rs_mod
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.pipeline import header as header_mod
from steganosaurus_tpu_torch.pipeline import qim as qim_mod
from steganosaurus_tpu_torch.pipeline import spread as spread_mod
from steganosaurus_tpu_torch.pipeline.errors import StegoError
from steganosaurus_tpu_torch.pipeline.extract import extract_array
from steganosaurus_tpu_torch.pipeline.frame import (HEADER_STREAM_BITS,
                                                    frame_bits)
from steganosaurus_tpu_torch.pipeline.header import Header
from steganosaurus_tpu_torch.spectral import (corner, read_kernels,
                                              write_kernels)
from steganosaurus_tpu_torch.utils import metrics
from steganosaurus_tpu_torch.utils.spans import span

def _check_params(params: Params, layout: str = "nhwc") -> None:
    if layout == "nchw" and params.adaptive_alpha:
        raise StegoError("layout='nchw' is corner-path only")
    qim_mod.validate(params)


def _place(imgs, mesh, device):
    """(images, mesh) of a call: a Sharded batch over `mesh` (over a
    Sharded input's own mesh when mesh is None), else (one tensor on the
    resolved device, None). A batch the mesh does not divide raises
    ValueError (shard_batch)."""
    if mesh is None and isinstance(imgs, pbatch.Sharded):
        mesh = imgs.mesh
    if mesh is None:
        return runtime.to_device(imgs, runtime.resolve_device(
            device, like=imgs)), None
    if not isinstance(mesh, pbatch.Mesh):
        raise TypeError("mesh must be a steganosaurus_tpu_torch.parallel "
                        f"Mesh (make_mesh), got {type(mesh).__name__}")
    for d in dict.fromkeys(mesh.devices):
        runtime.resolve_device(d)
    s = pbatch.shard_batch(imgs, mesh)
    if s.dtype != torch.uint8:
        raise ValueError(f"images must be uint8, got {s.dtype}")
    return s, mesh


def _shard_rows(s):
    """(images, their rows of the batch) for each shard of a Sharded batch,
    or the one tensor with every row, yielded with the shard's card current
    (parallel.batch.card): the caller queues that shard's work before it
    asks for the next."""
    if not isinstance(s, pbatch.Sharded):
        yield s, slice(None)
        return
    for p, o in zip(s.parts, s.offsets):
        with pbatch.card(p.device):
            yield p, slice(o, o + p.shape[0])


def _take_rows(t, idxs: list[int]) -> torch.Tensor:
    """Rows idxs of a batch tensor, or of a Sharded gathered onto its
    mesh's first device, as one tensor."""
    if not isinstance(t, pbatch.Sharded):
        return _rows(t, idxs, t.device)[1]
    dev = t.mesh.devices[0]
    return torch.stack([t.parts[k][r].to(dev, non_blocking=True)
                        for k, r in map(t.locate, idxs)])


def _put_rows(t, idxs: list[int], rows) -> None:
    """Write rows (a tensor or a Sharded, one row per index) into rows
    idxs of the batch t (a tensor or a Sharded), in place."""
    if isinstance(rows, pbatch.Sharded):
        rows = rows.gather(rows.mesh.devices[0])
    if not isinstance(t, pbatch.Sharded):
        sel = runtime.upload(np.asarray(idxs, np.int64), t.device)
        t.index_copy_(0, sel, rows.to(t.device))
        return
    for j, i in enumerate(idxs):
        k, r = t.locate(i)
        t.parts[k][r].copy_(rows[j], non_blocking=True)


def _host(stego) -> np.ndarray:
    """The stego batch (a tensor or a Sharded) as a numpy array."""
    if isinstance(stego, pbatch.Sharded):
        return np.asarray(stego)
    return stego.cpu().numpy()


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


def _rows(t: torch.Tensor, idx: list[int], dev) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(index tensor on dev, t's rows idx): exactly those rows, with no
    power-of-two padding — eager torch and K1 take any batch size, unlike
    the JAX package's jitted modules (its _bucket_sel)."""
    sel = runtime.upload(np.asarray(idx, np.int64), dev)
    return sel, t.index_select(0, sel)


def _bucket(nbits: int) -> int:
    return -(-nbits // 4096) * 4096


def _payload_stream_bits(nbytes: int, rs: bool) -> int:
    """Payload stream bits of `nbytes` of ct||tag under the payload FEC:
    interleaved RS(255,223) coded bytes, or Rep-7."""
    return rs_mod.coded_len(nbytes) * 8 if rs else nbytes * 8 * 7


def _wire_clen(secret_len: int, params: Params) -> int:
    """The header clen of a secret: its length, padded under pad_quantum."""
    if params.pad_quantum:
        return header_mod.padded_len(secret_len, params.pad_quantum)
    return secret_len


def _flags(params: Params) -> int:
    """Header FLAGS of the wire mode Params select (FLAG_PADDED is added by
    seal_stream)."""
    flags = header_mod.FLAG_PER_IMAGE_WALK if params.per_image_walk else 0
    if params.qim:
        flags = header_mod.flags_with_qim(flags, params.qim)
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    return flags


@dataclass
class BatchEmbedResult:
    stego: np.ndarray | torch.Tensor | pbatch.Sharded  # numpy, or on the
    #                                   device(s) if device_resident
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
    path_key = crypto.derive_path_key(password, master_key)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    return keystream.turtle_expand(
        key_walk, (key_r, key_g, key_b), PH, PW,
        params.rmin, params.rmax, params.density, params.jitter, nbits,
        allow_short=allow_short,
    )


# Device-resident walk indices (with their read plans), per-slot keyed
# values and static maps, keyed by everything they are a pure function of
# (path key, dims, walk params, slice, device): one expansion and one upload
# serve every later batch under the key. Plain OrderedDicts, used from the
# calling thread only (the prefetches never touch them).
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
    return _walk_entry(password, master_key, params, PH, PW, nbits, skip,
                       bucket, device)[:2]


def _walk_entry(password, master_key, params, PH, PW, nbits, skip, bucket,
                device) -> tuple:
    """_DEV_IDX_CACHE's entry of _walk_indices_device's walk: its two
    values and the walk's read plans by (Ky, Kx) (_read_plan_device)."""
    path_key = crypto.derive_path_key(password, master_key)
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, skip, bucket, nbits, device)
    ent = _DEV_IDX_CACHE.get(key)
    if ent is None:
        with span("stt.walk.expand"):
            plane, y, x, jit, nprod = _walk_indices(
                password, master_key, params, PH, PW, nbits,
                allow_short=True)
        pad = bucket - (nbits - skip)
        sl = slice(skip, nbits)
        host = [np.concatenate([a[sl], np.repeat(a[nbits - 1], pad)])
                for a in (plane, y, x, jit)]
        arrs = tuple(runtime.upload(a.astype(np.int64), device)
                     for a in host[:3])
        arrs += (runtime.upload(host[3].astype(np.float32), device),)
        ent = (arrs, nprod, {})
    return _cache_put(_DEV_IDX_CACHE, key, ent)


def _read_plan_device(password, master_key, params, PH, PW, nbits, skip,
                      bucket, Ky, Kx, device):
    """K5's read plan (read_kernels.read_plan) of _walk_indices_device's
    walk over (3, Ky, Kx) corners where read_decode reads through one
    (read_kernels.uses_plan: on CUDA), else None. Built once and kept in
    the walk's own cache entry: the warm extract builds none."""
    if not read_kernels.uses_plan(torch.device(device)):
        return None
    (pl, yy, xx, _), _, plans = _walk_entry(password, master_key, params, PH,
                                            PW, nbits, skip, bucket, device)
    if (Ky, Kx) not in plans:
        plans[Ky, Kx] = read_kernels.read_plan(pl, yy, xx, Ky, Kx)
    return plans[Ky, Kx]


def _slot_values_device(kind: str, path_key: bytes, params: Params, L: int,
                        nbits: int, bucket: int, device) -> torch.Tensor:
    """(bucket,) f32 device tensor of the keyed per-slot values of frame
    slots [0, nbits), tail-padded by repeating slot nbits - 1 (the JAX
    statics' padding): kind "alpha" is Params.alpha_spread's amplitudes
    (pipeline/spread.py), kind "dither" the level-L QIM dithers
    (pipeline/qim.py). nbits == bucket gives the unpadded draws."""
    key = (kind, path_key, params.alpha, params.alpha_spread, L, nbits,
           bucket, device)
    ent = _DEV_IDX_CACHE.get(key)
    if ent is None:
        a = (spread_mod.spread_alphas(path_key, params, nbits)
             if kind == "alpha" else qim_mod.dither_angles(path_key, L, nbits))
        ent = runtime.upload(np.concatenate(
            [a, np.repeat(a[nbits - 1], bucket - nbits)]).astype(np.float32),
            device)
    return _cache_put(_DEV_IDX_CACHE, key, ent)


def _corner_statics_device(password, master_key, params, PH, PW, nbits,
                           bucket, Ky, Kx, device):
    """(maps, nprod): the static corner maps of the walk's first `bucket`
    slots (parallel.batch.corner_statics_core) — the JAX package's maps
    tuple (pos, [cjd, sjd], [cad, sad], [dq, qm]): the jitter pair when
    Params.jitter != 0, the amplitude pair when Params.alpha_spread != 0,
    the QIM pair when Params.qim is nonzero. Only the embed builds them
    (the reads take each walk slot's own values), so the level is always
    Params.qim. Keyed as the JAX cache is: alpha joins the key only under
    spread (the amplitude maps bake cos/sin(alpha_i)), and the QIM level
    always."""
    path_key = crypto.derive_path_key(password, master_key)
    has_spread = params.alpha_spread != 0.0
    L = params.qim
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, nbits, bucket, Ky, Kx, device,
           (params.alpha, params.alpha_spread) if has_spread else None, L)
    ent = _CORNER_STATICS_CACHE.get(key)
    if ent is None:
        (plane, y, x, jit), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nbits, 0, bucket, device)

        def slots(kind):
            return _slot_values_device(kind, path_key, params, L, nbits,
                                       bucket, device)

        maps = pbatch.corner_statics_core(
            plane, y, x, Ky, Kx, bucket,
            jit if params.jitter != 0.0 else None,
            alphas=slots("alpha") if has_spread else None,
            dither=slots("dither") if L else None)
        ent = (maps, nprod)
    return _cache_put(_CORNER_STATICS_CACHE, key, ent)


# Prefetched per-image payload walks (per-image-walk streams), keyed by
# (path_key, salt, dims, walk params, need). Entries are single-use —
# salts rotate per batch — so consumers POP them; prefetch_piw_walks fills
# them on a worker thread while earlier batches hold the device.
_PIW_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_PIW_CACHE_MAX = 256
_PIW_CACHE_LOCK = threading.Lock()


def _piw_key(path_key, salt, params, PH, PW, need):
    return (path_key, salt, PH, PW, params.rmin, params.rmax, params.density,
            params.jitter, need)


def _piw_header_walk(path_key, params, PH, PW):
    """(plane, y, x, jitter, visited) of the shared 912-slot header prefix
    (keystream caches it, under its own lock)."""
    _build.ensure_native()
    kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
    return keystream.header_walk_with_visited(
        kw, (kr, kg, kb), PH, PW, params.rmin, params.rmax, params.density,
        params.jitter, HEADER_STREAM_BITS)


def _piw_expand(path_key, salt, params, PH, PW, need, vis):
    """One salt-keyed payload expansion of `need` bits resuming from the
    header's visited bitmap, tail-padded past exhaustion (allow_short)."""
    sk = crypto.derive_turtle_keys(crypto.derive_salt_path_key(path_key,
                                                               salt))
    return keystream.turtle_expand_chained(
        sk[0], sk[1:], PH, PW, params.rmin, params.rmax, params.density,
        params.jitter, need, vis, allow_short=True)


def _piw_expand_one(path_key, salt, params, PH, PW, need, vis):
    """_piw_expand, consuming a prefetched entry when there is one."""
    key = _piw_key(path_key, salt, params, PH, PW, need)
    with _PIW_CACHE_LOCK:
        ent = _PIW_CACHE.pop(key, None)
    if ent is not None:
        return ent
    return _piw_expand(path_key, salt, params, PH, PW, need, vis)


def _piw_map(fn, n: int, name: str = "piw-walk") -> list:
    """[fn(0), ..., fn(n-1)] on up to 8 threads named `name`: the native
    walker releases the GIL, so a batch pays the longest expansion, not
    their sum."""
    with ThreadPoolExecutor(max_workers=max(1, min(8, n)),
                            thread_name_prefix=name) as ex:
        return list(ex.map(fn, range(n)))


def prefetch_piw_walks(password, master_key, params: Params, H: int, W: int,
                       salts: list[bytes], secret_lens: list[int]) -> None:
    """Warm the per-image payload-walk cache for an upcoming batch: the B
    salt-keyed expansions are the per-image-walk mode's dominant host cost,
    and pipeline.stream runs this on a worker thread (with salts drawn up
    front) while the batches in flight hold the device. The needs are the
    embed's own (padded clen, FEC mode), so embed_batch finds the entries.
    Errors are swallowed: the embed that follows raises them with full
    context."""
    try:
        PH, PW = spectral.fft_dims(H, W)
        path_key = crypto.derive_path_key(password, master_key)
        *_, vis = _piw_header_walk(path_key, params, PH, PW)
        needs = [_payload_stream_bits(_wire_clen(n, params) + 16, params.rs)
                 for n in secret_lens]

        def one(i):
            key = _piw_key(path_key, salts[i], params, PH, PW, needs[i])
            with _PIW_CACHE_LOCK:
                if key in _PIW_CACHE:
                    return
            ent = _piw_expand(path_key, salts[i], params, PH, PW, needs[i],
                              vis)
            with _PIW_CACHE_LOCK:
                _PIW_CACHE[key] = ent
                while len(_PIW_CACHE) > _PIW_CACHE_MAX:
                    _PIW_CACHE.popitem(last=False)

        _piw_map(one, len(salts), "piw-prefetch")
    except Exception:  # noqa: BLE001 — deliberately quiet (see docstring)
        pass


def _piw_walk_arrays(password, master_key, params, PH, PW, salts,
                     need_lens, bucket, strict=True):
    """Per-image-walk (B, bucket) plane/y/x int32 and jitter f32 host
    arrays (JAX _piw_walk_arrays).

    Row i is the shared header prefix (912 slots) followed by the
    salt-keyed payload walk of salts[i] resuming from the prefix's visited
    state, expanded to need_lens[i] - 912 bits and tail-padded to `bucket`
    by repeating the last real bin. strict=True (embed) raises StegoError
    when an image's walk exhausts before its frame fits; strict=False
    (extraction, where need_lens come from decoded and possibly corrupt
    clens) lets the walk's own padding stand, so the image reads garbage
    that the AEAD rejects and the batch goes on."""
    path_key = crypto.derive_path_key(password, master_key)
    hdr_n = HEADER_STREAM_BITS
    hp, hy, hx, hj, vis = _piw_header_walk(path_key, params, PH, PW)
    outs = _piw_map(lambda i: _piw_expand_one(
        path_key, salts[i], params, PH, PW, need_lens[i] - hdr_n, vis),
        len(salts))
    B = len(salts)
    plane = np.empty((B, bucket), np.int32)
    yarr = np.empty((B, bucket), np.int32)
    xarr = np.empty((B, bucket), np.int32)
    jarr = np.empty((B, bucket), np.float32)
    for i, (pp, py, px, pj, n) in enumerate(outs):
        need = need_lens[i] - hdr_n
        if n < need and strict:
            raise StegoError(
                f"Message too large. Image {i}: salt-keyed payload walk "
                f"exhausted after {n}/{need} bits.")
        for dst, pre, pay in ((plane, hp, pp), (yarr, hy, py),
                              (xarr, hx, px), (jarr, hj, pj)):
            row = dst[i]
            row[:hdr_n] = pre
            row[hdr_n:hdr_n + need] = pay[:need]
            row[hdr_n + need:] = row[hdr_n + need - 1]
    return plane, yarr, xarr, jarr


def _upload_walks(arrays, dev) -> tuple[torch.Tensor, ...]:
    return tuple(runtime.upload(a, dev) for a in arrays)


def _take(arrays, pos: list[int], n: int) -> tuple:
    """Rows `pos` of each of n-row host arrays (all of them, uncopied, when
    pos is every row)."""
    if len(pos) == n:
        return tuple(arrays)
    return tuple(a[pos] for a in arrays)


def prefetch_walk(password, master_key, params: Params, H: int, W: int,
                  secret_lens: list[int]) -> None:
    """Warm the HOST walk cache (keystream) for (key, dims, params) ahead
    of use.

    The turtle walk is the pipeline's one strictly sequential host cost
    (~1.2 s for a fresh key at 4K/16 KB); pipeline.stream runs this on a
    worker thread when a stream's key rotates, so the expansion overlaps the
    batches in flight instead of stalling the next embed_batch. Under
    per-image walks only the shared header prefix is salt-independent, so
    only it is expanded. It touches only keystream's caches, which are
    locked, never _DEV_IDX_CACHE or _CORNER_STATICS_CACHE. Errors are
    swallowed, as the JAX package's prefetch_walk does: the next
    embed_batch under the key raises them with full context, and nothing
    else depends on this call."""
    try:
        PH, PW = spectral.fft_dims(H, W)
        if params.per_image_walk:
            _piw_header_walk(crypto.derive_path_key(password, master_key),
                             params, PH, PW)
            return
        nmax = max(HEADER_STREAM_BITS + _payload_stream_bits(
            _wire_clen(n, params) + 16, params.rs) for n in secret_lens)
        _walk_indices(password, master_key, params, PH, PW, nmax,
                      allow_short=True)
    except Exception:  # noqa: BLE001 — deliberately quiet (see docstring)
        pass


def _host_frames(streams: list[bytes], bucket: int,
                 rs: bool = False) -> np.ndarray:
    """(B, bucket) u8 frames, each padded with its own last bit (the JAX
    embed_batch _host_frames)."""
    bits = np.empty((len(streams), bucket), np.uint8)
    for i, s in enumerate(streams):
        f = frame_bits(s, rs)
        bits[i, :len(f)] = f
        bits[i, len(f):] = f[-1]
    return bits


def _seal_streams(secrets, salts, password, master_key, params) -> list:
    """header||ct||tag per image, FLAGS from the Params' wire mode."""
    streams = []
    flags = _flags(params)
    for secret, salt in zip(secrets, salts):
        with crypto.derive_keys_vault(password, master_key, salt=salt,
                                      iters=params.pbkdf2_iter) as km:
            hdr_bytes, ct, tag = header_mod.seal_stream(
                secret, km, flags, params.pad_quantum)
        streams.append(hdr_bytes + ct + tag)
    return streams


def _embed_full_grid(imgs_d, words, walks, frame_lens, nmax, bucket,
                     password, master_key, params, PH, PW, layout):
    """The Params.adaptive_alpha embed (JAX embed_batch's legacy branches)
    of one device's rows: their host-built frames as packed words into
    batched_embed_core, on each image's salt-keyed walk (`walks`, their
    host arrays) under per_image_walk (alpha the scalar, as JAX's branch
    takes it), else on the shared walk with the spread amplitudes as
    per-slot alphas. The write floor counts each image's own frame
    (per-image walks) or the batch's longest frame, nmax (shared walk)."""
    dev = imgs_d.device
    words = runtime.upload(words, dev)
    if params.per_image_walk:
        plane, y, x, jit = _upload_walks(walks, dev)
        alpha = params.alpha
        n_valid = runtime.upload(np.asarray(frame_lens, np.int64), dev)
    else:
        (plane, y, x, jit), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nmax, 0, bucket, dev)
        if nprod < nmax:
            raise StegoError(f"Message too large. Need {nmax} bits (after "
                             f"ECC), walk exhausted after {nprod}.")
        alpha = (_slot_values_device(
            "alpha", crypto.derive_path_key(password, master_key), params,
            0, nmax, bucket, dev) if params.alpha_spread != 0.0
            else params.alpha)
        n_valid = nmax
    return pbatch.batched_embed_core(
        imgs_d, plane, y, x, words, jit, alpha,
        n_valid if params.write_floor else None, center=params.center,
        soft=params.soft_write, floor=params.write_floor, layout=layout)


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

    Every corner wire mode of the JAX package is written as it writes it
    (module docstring); Params.per_image_walk embeds the payload on each
    image's salt-keyed walk (corner_piw_embed_core), else one shared walk
    serves the batch (corner_embed_core). Params.adaptive_alpha takes the
    full-grid batched_embed_core on either walk (nhwc only);
    cover_dependent_path and coherent are per-image modes and raise (use
    embed_array). Secrets may differ in length:
    every frame is padded to the longest by repeating its own last bit
    (surplus bins are never read back). Equal-length Rep-7 shared-walk
    batches upload the sealed streams and expand the ECC on the device;
    the rest upload host-built frames.

    verify=True reads every image back (extract_batch, clen_hint the
    longest secret's wire clen) and re-embeds the failures with fresh salts
    up to max_retries times, writing the new rows into the stego in place.
    Result.verified reports each image; result.salts the final salts.
    Explicit `salts` are respected on the first attempt only.

    mesh (parallel.make_mesh; a Sharded imgs brings its own): the batch is
    split along the mesh's devices (B must divide evenly, else ValueError)
    and each shard's rows run the single-device cores on their device; the
    host work (sealing, frames, walks) is done once for the batch and every
    shard's device work is queued before anything waits. The stego is then
    a Sharded when device_resident (np.asarray gathers it), and bytes equal
    to the unsharded call's. A verify retry re-embeds the failed rows on
    the mesh when the mesh size divides their count, else unsharded on the
    mesh's first device.
    """
    _check_key(password, master_key)
    if params.cover_dependent_path:
        raise StegoError("cover_dependent_path is per-image; use embed_array")
    if params.coherent:
        raise StegoError(
            "coherent batch embedding is not wired into the fused batch "
            "cores; use embed_array (extract_batch auto-detects and "
            "resolves coherent stegos per image)")
    _check_params(params, layout)
    spread_mod.validate(params)
    B, H, W = _dims(imgs, layout)
    if len(secrets) != B:
        raise ValueError(f"{len(secrets)} secrets for {B} images")
    imgs_d, mesh = _place(imgs, mesh, device)
    PH, PW = spectral.fft_dims(H, W)

    if salts is None:
        salts = [crypto.get_random_bytes(16) for _ in range(B)]
    if len(salts) != B:
        raise ValueError(f"{len(salts)} salts for {B} images")
    with span("stt.embed.seal"):
        streams = _seal_streams(secrets, salts, password, master_key, params)
    frame_lens = [HEADER_STREAM_BITS + _payload_stream_bits(
        len(s) - header_mod.FIXED_LEN, params.rs) for s in streams]
    nmax = max(frame_lens)
    # frames are bucketed to a 4096 multiple; surplus slots repeat the last
    # (bin, bit) pair and are never read back
    bucket = _bucket(nmax)
    Ky, Kx = corner.corner_dims(PH, PW, params.rmax)
    path_key = crypto.derive_path_key(password, master_key)
    has_spread = params.alpha_spread != 0.0
    common = dict(Ky=Ky, Kx=Kx, center=params.center, layout=layout,
                  floor=params.write_floor, soft=params.soft_write,
                  qim_levels=params.qim)
    # host work, once for the whole batch; each device takes its own rows.
    # Equal-length Rep-7 shared-walk frames go up as the sealed streams and
    # are expanded on the device, the rest as host-built frame bits.
    streams_up = (len(set(frame_lens)) == 1 and not params.rs
                  and not params.adaptive_alpha and not params.per_image_walk)
    with span("stt.embed.frame"):
        words = (bit_ops.pack_bytes_words_host(streams) if streams_up
                 else bit_ops.pack_bits_words_host(
                     _host_frames(streams, bucket, params.rs)))
    walks = None
    if params.per_image_walk:
        with span("stt.embed.walk"):
            walks = _piw_walk_arrays(password, master_key, params, PH, PW,
                                     salts, frame_lens, bucket)

    def embed_rows(imgs_p: torch.Tensor, rows: slice) -> torch.Tensor:
        """Queue the device work of the batch rows `rows` (imgs_p, on its
        own device)."""
        dev = imgs_p.device
        rows_walks = (tuple(a[rows] for a in walks) if walks is not None
                      else None)
        if params.adaptive_alpha:
            return _embed_full_grid(imgs_p, words[rows], rows_walks,
                                    frame_lens[rows], nmax, bucket, password,
                                    master_key, params, PH, PW, layout)
        w = runtime.upload(words[rows], dev)
        if params.per_image_walk:
            def full_draws(kind):  # slot-aligned, clamped per image on device
                return _slot_values_device(kind, path_key, params,
                                           params.qim, bucket, bucket, dev)

            return pbatch.corner_piw_embed_core(
                imgs_p, bit_ops.unpack_bits_words(w, bucket),
                *_upload_walks(rows_walks, dev), params.alpha,
                alphas=full_draws("alpha") if has_spread else None,
                dither=full_draws("dither") if params.qim else None,
                nbits=runtime.upload(np.asarray(frame_lens[rows], np.int64),
                                     dev),
                **common)
        with span("stt.embed.walk"):
            maps, nprod = _corner_statics_device(password, master_key,
                                                 params, PH, PW, nmax,
                                                 bucket, Ky, Kx, dev)
        if nprod < nmax:
            raise StegoError(f"Message too large. Need {nmax} bits (after "
                             f"ECC), walk exhausted after {nprod}.")
        # an equal-length Rep frame stays its stream words: K3 reads each
        # slot's bit from them
        frame = (write_kernels.RepFrame(w, len(streams[0]), bucket)
                 if streams_up else bit_ops.unpack_bits_words(w, bucket))
        return pbatch.corner_embed_core(
            imgs_p, frame, maps, params.alpha,
            has_jitter=params.jitter != 0.0, has_spread=has_spread, **common)

    # every shard's work is queued before anything waits for a device
    with span("stt.embed.queue"):
        parts = [embed_rows(p, rows) for p, rows in _shard_rows(imgs_d)]
    stego = pbatch.Sharded(parts, mesh) if mesh is not None else parts[0]

    salts = list(salts)
    verified = None
    if verify:
        # the on-wire clen is the padded plaintext length: an unpadded hint
        # would undersize the fused pass and cost a second one
        maxlen = _wire_clen(max(len(s) for s in secrets), params)
        got = extract_batch(stego, password=password, master_key=master_key,
                            params=params, mesh=mesh, clen_hint=maxlen,
                            layout=layout)
        verified = [g == s for g, s in zip(got, secrets)]
        for _ in range(max_retries):
            failed = [i for i, ok in enumerate(verified) if not ok]
            if not failed:
                break
            new_salts = [crypto.get_random_bytes(16) for _ in failed]
            # a failed subset the mesh does not divide is re-embedded
            # unsharded, on the mesh's first device (as JAX does)
            sub_mesh = (mesh if mesh is not None
                        and len(failed) % mesh.size == 0 else None)
            sub = embed_batch(_take_rows(imgs_d, failed),
                              [secrets[i] for i in failed],
                              password=password, master_key=master_key,
                              params=params, salts=new_salts, mesh=sub_mesh,
                              device_resident=True, layout=layout)
            _put_rows(stego, failed, sub.stego)
            got = extract_batch(stego, password=password,
                                master_key=master_key, params=params,
                                mesh=mesh, clen_hint=maxlen, layout=layout)
            for i, s_new in zip(failed, new_salts):
                salts[i] = s_new
            verified = [g == s for g, s in zip(got, secrets)]
    return BatchEmbedResult(
        stego=stego if device_resident else _host(stego),
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
    bins of the stego batch: payload slots by the QIM rule under
    Params.qim, the post-ECC payload BER through the RS decode under
    Params.rs. Post-ECC BER > 0 on an image means its AEAD fails and verify
    would re-salt it. The shared-walk corner path only, as in the JAX
    package: Params.adaptive_alpha, cover_dependent_path and
    per_image_walk raise StegoError."""
    _check_key(password, master_key)
    _check_params(params)
    for field in ("adaptive_alpha", "cover_dependent_path",
                  "per_image_walk"):
        if getattr(params, field):
            raise StegoError("channel_report supports the shared-walk corner "
                             f"path only (Params.{field} is not)")
    B, H, W = _dims(stego, layout)
    if len(secrets) != B or len(salts) != B:
        raise ValueError(f"{len(secrets)} secrets and {len(salts)} salts for "
                         f"{B} images")
    stego_d, _ = _place(stego, mesh, device)
    PH, PW = spectral.fft_dims(H, W)
    streams = _seal_streams(secrets, salts, password, master_key, params)
    frames = [frame_bits(s, params.rs) for s in streams]
    nmax = max(len(f) for f in frames)
    bucket = _bucket(nmax)
    Ky, Kx = corner.corner_dims(PH, PW, params.rmax)
    copies = []
    for part, _ in _shard_rows(stego_d):  # queued on every shard first
        dev = part.device
        (pl, yy, xx, jj), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nmax, 0, bucket, dev)
        if nprod < nmax:
            raise StegoError("stego batch cannot carry the claimed frames")
        dither = (_slot_values_device(
            "dither", crypto.derive_path_key(password, master_key), params,
            params.qim, nmax, bucket, dev) if params.qim else None)
        plan = (None if params.qim else _read_plan_device(
            password, master_key, params, PH, PW, nmax, 0, bucket, Ky, Kx,
            dev))
        copies.append(runtime.HostCopy(pbatch.corner_raw_bits_core(
            part, params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
            center=params.center, layout=layout,
            jit=jj if params.jitter != 0.0 else None, dither=dither,
            qim_levels=params.qim, plan=plan)))
    got = bit_ops.unpack_words_host(
        np.concatenate([c.numpy() for c in copies]), bucket)
    reports = [metrics.ecc_report(
        f, got[i, :len(f)], HEADER_STREAM_BITS,
        rs_payload_bytes=(len(s) - header_mod.FIXED_LEN) if params.rs else 0)
        for i, (f, s) in enumerate(zip(frames, streams))]
    out = {k: float(np.mean([r[k] for r in reports])) for k in reports[0]}
    if per_image:
        out["per_image"] = [{k: float(v) for k, v in r.items()}
                            for r in reports]
    return out


def _parse_hdr(buf: bytes) -> Header | None:
    """A parseable header: right magic and version, and a valid QIM level
    (1 is not one: a corrupt header)."""
    hb = buf[:header_mod.FIXED_LEN]
    if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
        return None
    if header_mod.qim_levels(hb[5]) == 1:
        return None
    return Header.from_bytes(hb)


def _is_coherent(h: Header | None) -> bool:
    """A row the single-image extract_array resolves: its header failed
    both parses (a coherent header rides the common-mode write the batch
    readers cannot read), or it carries FLAG_COHERENT (a standard header
    over a coherent payload)."""
    return h is None or bool(h.flags & header_mod.FLAG_COHERENT)


def _mode(h: Header) -> tuple[int, bool]:
    """(QIM level, RS flag) a header carries."""
    return (header_mod.qim_levels(h.flags),
            bool(h.flags & header_mod.FLAG_RS_PAYLOAD))


def _is_piw(h: Header) -> bool:
    return bool(h.flags & header_mod.FLAG_PER_IMAGE_WALK)


def _to_bufs(words: np.ndarray) -> list[bytes]:
    """(B, k) int32 rows -> per-image byte strings (big-endian words)."""
    return [w.view(np.uint32).astype(">u4").tobytes() for w in words]


class _ShardRows:
    """One pass's device rows, queued shard by shard: [(positions, rows)],
    each shard's rows going to those positions of the pass's n rows. pull()
    queues their copies to the host (runtime.HostCopy); numpy() waits for
    them and returns the n rows in order."""

    def __init__(self, outs: list[tuple[list[int], torch.Tensor]], n: int):
        self._outs = outs
        self._n = n
        self._copies = None

    def pull(self) -> "_ShardRows":
        if self._copies is None:
            self._copies = [(pos, runtime.HostCopy(t))
                            for pos, t in self._outs]
        return self

    def numpy(self) -> np.ndarray:
        self.pull()
        arrs = [(pos, c.numpy()) for pos, c in self._copies]
        if len(arrs) == 1:  # one shard holds every row, in order
            return arrs[0][1]
        a0 = arrs[0][1]
        out = np.empty((self._n, *a0.shape[1:]), a0.dtype)
        for pos, a in arrs:
            out[pos] = a
        return out


class _ExtractJob:
    """An in-flight batch extraction. The fused header + hinted payload pass
    and the copy of its hard rows to the host are queued on the device at
    construction (CUDA work is asynchronous) and waited for only in
    finalize(), so host work between the two overlaps it.

    The fused pass assumes the wire mode Params name (QIM level, RS or
    Rep-7) for its payload section; headers always decode (they are never
    QIM-written), and images whose header carries another mode get a
    corrected payload-only pass in finalize, so a wrong assumption never
    misdecodes.

    Under a mesh every pass runs on each shard holding rows of it, on that
    shard's device, all shards queued before any result is pulled; the
    rows come back in batch order. Without one, the batch is one shard."""

    def __init__(self, imgs, password, master_key, params, mesh, clen_hint,
                 layout="nhwc", device=None):
        _check_key(password, master_key)
        if params.cover_dependent_path:
            raise StegoError(
                "cover_dependent_path is per-image; use extract_array")
        _check_params(params, layout)
        self.B, H, W = _dims(imgs, layout)
        self._layout = layout
        imgs_d, _ = _place(imgs, mesh, device)
        # (images, first batch row) per shard
        self._parts = [(t, rows.start or 0) for t, rows in _shard_rows(imgs_d)]
        PH, PW = spectral.fft_dims(H, W)
        self._key = (password, master_key)
        self._path_key = crypto.derive_path_key(password, master_key)
        self._params = params
        self._qim, self._rs = params.qim, params.rs
        self._dims = (PH, PW)
        self._corner_kk = corner.corner_dims(PH, PW, params.rmax)
        # adaptive alpha needs the full-spectrum median: one full-grid FFT
        # per image, kept for every read pass of the job
        self._use_corner = not params.adaptive_alpha
        if not self._use_corner:
            spectra = [pbatch.batched_analyze_core(t, center=params.center,
                                                   layout=layout)
                       for _, t, _, _ in self._shards(range(self.B))]
            self._spec = [sp for sp, _ in spectra]
            self._med = [md for _, md in spectra]
        # Walk capacity upper bound: each accepted bit marks a bin and its
        # conjugate. Bounds the gather under a corrupt header clen and an
        # oversized hint.
        self._cap_bits = 3 * PH * PW // 2
        self._hint_bits = (min(self._payload_bits(clen_hint, params.rs),
                               self._cap_bits) if clen_hint else 0)
        self._covered_payload_bits = 0  # set by the with_header pass
        self._result: list[bytes | None] | None = None
        self._pending = self._dispatch_pass(self._hint_bits, True)

    @staticmethod
    def _payload_bits(clen: int, rs: bool = False) -> int:
        """Payload stream bits for a ciphertext length, by FEC mode."""
        return _payload_stream_bits(clen + 16, rs)

    def _walk(self, total: int, skip: int, bucket_total: int, dev):
        """Walk plane/y/x of slots [skip, total) on dev, padded to
        bucket_total - skip, and their jitter angles (None when
        Params.jitter == 0 and the corner path reads them: its rule then
        needs no angles; the full-grid read always takes them)."""
        password, master_key = self._key
        PH, PW = self._dims
        (pl, yy, xx, jj), _ = _walk_indices_device(
            password, master_key, self._params, PH, PW, total, skip,
            bucket_total - skip, dev)
        if self._use_corner and self._params.jitter == 0.0:
            jj = None
        return pl, yy, xx, jj

    def _plan(self, total: int, skip: int, bucket_total: int, dev):
        """The read plan of _walk's walk (pipeline cache), for K5."""
        password, master_key = self._key
        return _read_plan_device(password, master_key, self._params,
                                 *self._dims, total, skip,
                                 bucket_total - skip, *self._corner_kk, dev)

    def _dither(self, L: int, nbits: int, bucket: int, dev) -> torch.Tensor:
        """Level-L QIM dithers of frame slots [0, nbits) on dev, padded to
        `bucket` by repeating slot nbits - 1."""
        return _slot_values_device("dither", self._path_key, self._params,
                                   L, nbits, bucket, dev)

    def _shards(self, idxs):
        """(shard k, its images at rows of idxs, those rows within the
        shard, their positions in idxs) for each shard holding rows of
        idxs, yielded with the shard's card current (parallel.batch.card);
        a shard all of whose rows are asked for gives its images as they
        are."""
        for k, (imgs, first) in enumerate(self._parts):
            n = imgs.shape[0]
            pos = [j for j, i in enumerate(idxs) if first <= i < first + n]
            if not pos:
                continue
            with pbatch.card(imgs.device):
                local = [idxs[j] - first for j in pos]
                if local != list(range(n)):
                    imgs = _rows(imgs, local, imgs.device)[1]
                yield k, imgs, local, pos

    def _row(self, i: int) -> torch.Tensor:
        """Batch row i, on its shard's device."""
        for imgs, first in self._parts:
            if first <= i < first + imgs.shape[0]:
                return imgs[i - first]
        raise IndexError(i)

    def _dispatch_pass(self, payload_stream_bits: int, with_header: bool,
                       qim: int | None = None, rs: bool | None = None):
        """Queue one read + decode pass over the shared walk; returns (hard,
        soft, info): the HostCopy of the hard rows, and — with
        soft_decode_fallback on — the soft rows left on the device and the
        pass's section layout (hdr_bits, n_slots, rep), else None and None.
        `qim`/`rs` are the payload section's mode (default: the assumed
        one); the header section always reads by the hard rule.

        The total frame length is bucketed to a 4096 multiple exactly as
        embed_batch buckets a frame of that length, so an embed -> extract
        round trip shares one cached walk upload. With no payload bits this
        is the header-only probe: 912 slots, no rounding."""
        L = self._qim if qim is None else qim
        rep = 1 if (self._rs if rs is None else rs) else 7
        hdr = HEADER_STREAM_BITS
        if payload_stream_bits:
            total = hdr + payload_stream_bits
            bucket_total = _bucket(total)
        else:
            total = bucket_total = hdr
            L = 0  # the header never reads by the QIM rule
        hdr_bits = hdr if with_header else 0
        skip = 0 if with_header else hdr
        if with_header:
            # slots [total, bucket_total) duplicate slot total-1; only the
            # unrounded payload bits are genuinely readable
            self._covered_payload_bits = total - hdr
        with_soft = bool(self._params.soft_decode_fallback)
        Ky, Kx = self._corner_kk
        hard, soft = [], []
        with span("stt.extract.queue"):
            for k, imgs, _, pos in self._shards(range(self.B)):
                dev = imgs.device
                with span("stt.extract.walk"):
                    pl, yy, xx, jj = self._walk(total, skip, bucket_total,
                                                dev)
                    plan = (self._plan(total, skip, bucket_total, dev)
                            if self._use_corner and not L else None)
                if not self._use_corner:
                    # the full-grid read (JAX's legacy branch: no QIM rule
                    # there; QIM and adaptive_alpha are mutually exclusive
                    # at embed)
                    words = pbatch.batched_gather_decode_core(
                        self._spec[k], self._med[k], pl, yy, xx, jj,
                        self._params.alpha, hdr_stream_bits=hdr_bits,
                        payload_rep=rep, with_soft=with_soft)
                else:
                    words = pbatch.corner_extract_fused_core(
                        imgs, self._params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
                        center=self._params.center, layout=self._layout,
                        hdr_stream_bits=hdr_bits, with_soft=with_soft,
                        jit=jj,
                        dither=(self._dither(L, total, bucket_total,
                                             dev)[skip:] if L else None),
                        qim_levels=L, qim_from=hdr_bits, payload_rep=rep,
                        plan=plan)
                h, sw = words if with_soft else (words, None)
                hard.append((pos, h))
                soft.append((pos, sw))
            hard = _ShardRows(hard, self.B).pull()
        if not with_soft:
            return hard, None, None
        return (hard, _ShardRows(soft, self.B),
                (hdr_bits, bucket_total - skip, rep))

    @staticmethod
    def _soft_sections(soft_d: _ShardRows, info):
        """Pull a pass's soft rows and split them per image into (soft
        bufs, RS confidences (B, n_bytes) f32 or None); the word counts
        mirror the device-side packing exactly (checked)."""
        hdr_bits, n_slots, rep = info
        hw = (hdr_bits // 3 + 31) // 32 if hdr_bits else 0
        wh = hw + ((n_slots - hdr_bits) // rep + 31) // 32
        c = (n_slots - hdr_bits) // 8 if rep == 1 else 0
        words = soft_d.numpy()
        if words.shape[1] != wh + c:
            raise RuntimeError(
                f"soft-row word-layout mismatch: device rows have "
                f"{words.shape[1]} words, host expects {wh}+{c}")
        return (_to_bufs(words[:, :wh]),
                words[:, wh:].view(np.float32) if c else None)

    def _open_payload(self, hdr: Header, payload: bytes,
                      conf=None) -> bytes | None:
        """FEC-decode a payload byte section under `hdr` and AEAD-open it;
        None when it is short or fails authentication. For an RS header the
        section holds the coded bytes: the hard RS decode, or with `conf`
        (per-coded-byte confidences of a soft pass) the errors-and-erasures
        decode (ops/rs.py)."""
        password, master_key = self._key
        m = hdr.clen + 16
        if hdr.flags & header_mod.FLAG_RS_PAYLOAD:
            ncoded = rs_mod.coded_len(m)
            if len(payload) < ncoded:
                return None
            if conf is not None:
                rest, _ = rs_mod.rs_decode_interleaved_soft(
                    payload[:ncoded], m, conf[:ncoded])
            else:
                rest, _, _ = rs_mod.rs_decode_interleaved(payload[:ncoded], m)
        else:
            rest = payload[:m]
        if len(rest) < m:
            return None
        ct, tag = rest[:hdr.clen], rest[hdr.clen:m]
        with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                      iters=self._params.pbkdf2_iter) as km:
            return header_mod.maybe_unpad(
                km.open(hdr.to_bytes(), ct, tag), hdr.flags)

    def _piw_arrays(self, idxs: list[int], hdrs, needs: list[int], n: int):
        """(plane, y, x, jitter) (len(idxs), n) host arrays of the per-image
        walks of rows `idxs`, keyed by their headers' salts, expanded to
        `needs` frame slots, header prefix included, tolerant of
        exhaustion; host work, once for every shard."""
        password, master_key = self._key
        PH, PW = self._dims
        return _piw_walk_arrays(password, master_key, self._params, PH, PW,
                                [hdrs[i].salt for i in idxs], needs, n,
                                strict=False)

    def _dispatch_piw_pass(self, idxs: list[int], headers: list,
                           qim: int = 0, rs: bool = False) -> list[bytes]:
        """Per-image-walk payload pass for the header-flagged rows `idxs`
        (JAX _ExtractJob._dispatch_piw_pass): each row's salt-keyed payload
        walk is expanded (on 8 threads) from its decoded header's salt and
        clen, then one forward DFT + per-image gather + decode over exactly
        those rows, under the group's header-carried QIM level and FEC.
        Returns payload byte buffers aligned with `idxs`."""
        hdr = HEADER_STREAM_BITS
        needs = [min(self._payload_bits(headers[i].clen, rs), self._cap_bits)
                 for i in idxs]
        n = _bucket(max(needs))
        arrays = self._piw_arrays(idxs, headers, [hdr + m for m in needs],
                                  hdr + n)
        Ky, Kx = self._corner_kk
        outs = []
        for k, imgs, local, pos in self._shards(idxs):
            dev = imgs.device
            pl, yy, xx, jj = (t[:, hdr:] for t in _upload_walks(
                _take(arrays, pos, len(idxs)), dev))
            if not self._use_corner:
                spec, med = self._spec[k], self._med[k]
                if local != list(range(spec.shape[0])):
                    sel = runtime.upload(np.asarray(local, np.int64), dev)
                    spec, med = (spec.index_select(0, sel),
                                 med.index_select(0, sel))
                words = pbatch.batched_gather_decode_core(
                    spec, med, pl, yy, xx, jj, self._params.alpha,
                    hdr_stream_bits=0, payload_rep=1 if rs else 7)
            else:
                words = pbatch.corner_extract_fused_core(
                    imgs, self._params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
                    center=self._params.center, layout=self._layout,
                    hdr_stream_bits=0, with_soft=False, jit=jj,
                    # payload-only slots: payload bit k sits at frame slot
                    # 912 + k
                    dither=(self._dither(qim, hdr + n, hdr + n, dev)[hdr:]
                            if qim else None),
                    qim_levels=qim, qim_from=0, payload_rep=1 if rs else 7)
            outs.append((pos, words))
        return _to_bufs(_ShardRows(outs, len(idxs)).numpy())

    def finalize(self) -> list[bytes | None]:
        """Wait for the fused pass, parse headers, group the rows by the
        wire mode their headers carry, run each group's payload pass where
        the fused pass did not already decode it (payload-only shared-walk
        passes by (QIM level, FEC); per-image-walk passes), AEAD-open
        everything, retry failures from the same pass's matched-filter soft
        sections, then run the soft-decision retry pass over what still
        fails. Idempotent."""
        if self._pending is None:
            if self._result is not None:
                return self._result
            raise StegoError("extract job already failed; re-dispatch it")
        hard0, soft0_d, info0 = self._pending
        self._pending = None
        pulled: dict[int, tuple] = {}

        def _soft_of(soft_d, info):
            key = id(soft_d)
            if key not in pulled:
                pulled[key] = self._soft_sections(soft_d, info)
            return pulled[key]

        with span("stt.extract.parse"):
            bufs = _to_bufs(hard0.numpy())
            headers = [_parse_hdr(b) for b in bufs]
            if soft0_d is not None and any(h is None for h in headers):
                # a header the hard Rep-3 majority corrupted can still
                # parse from the matched-filter sections of the same pass
                soft_bufs0, _ = _soft_of(soft0_d, info0)
                for i, h in enumerate(headers):
                    if h is None:
                        headers[i] = _parse_hdr(soft_bufs0[i])
        # rows the batch readers cannot read go to the single-image
        # extract_array (its two-rule header trial reads the coherent rule;
        # a genuinely corrupt row pays one FFT and two header reads there)
        coh_idx = [i for i, h in enumerate(headers) if _is_coherent(h)]
        shared_by_mode: dict[tuple[int, bool], list[int]] = {}
        piw_by_mode: dict[tuple[int, bool], list[int]] = {}
        for i, h in enumerate(headers):
            if not _is_coherent(h):
                (piw_by_mode if _is_piw(h) else shared_by_mode).setdefault(
                    _mode(h), []).append(i)

        payloads: list[bytes | None] = [None] * self.B
        # (soft rows, pass info, payload byte offset) per image, consulted
        # only if that image's hard open fails
        soft_src: list[tuple | None] = [None] * self.B
        for (L, R), idxs in shared_by_mode.items():
            clens = {i: headers[i].clen for i in idxs}
            big = [i for i in idxs
                   if self._payload_bits(clens[i], R) >= self._cap_bits]
            if big and soft0_d is not None:
                # one Rep-3-corrupted clen would size the whole group's
                # pass to full capacity: size by the smaller of the hard
                # and soft claims
                soft_bufs0, _ = _soft_of(soft0_d, info0)
                for i in big:
                    h2 = _parse_hdr(soft_bufs0[i])
                    if h2 is not None:
                        clens[i] = min(clens[i], h2.clen)
            need = min(self._payload_bits(max(clens.values()), R),
                       self._cap_bits)
            if (L == self._qim and R == self._rs
                    and need <= self._covered_payload_bits):
                # the fused pass already decoded this group's payload rule:
                # it follows the 40-byte header block (38 bytes + 2 pad)
                for i in idxs:
                    payloads[i] = bufs[i][40:]
                    if soft0_d is not None:
                        soft_src[i] = (soft0_d, info0, 40)
            else:  # hint too small or absent, or another mode: a
                #    payload-only pass under the group's own mode
                with span("stt.extract.payload_pass"):
                    ghard, gsoft_d, ginfo = self._dispatch_pass(
                        need, False, qim=L, rs=R)
                    grp = _to_bufs(ghard.numpy())
                for i in idxs:
                    payloads[i] = grp[i]
                    if gsoft_d is not None:
                        soft_src[i] = (gsoft_d, ginfo, 0)
        for (L, R), idxs in piw_by_mode.items():
            with span("stt.extract.payload_pass"):
                bufs_piw = self._dispatch_piw_pass(idxs, headers, L, R)
            for i, buf in zip(idxs, bufs_piw):
                payloads[i] = buf
        resolved = {i: self._extract_row(i) for i in coh_idx}

        out: list[bytes | None] = []
        with span("stt.extract.open"):
            for i, hdr in enumerate(headers):
                if i in resolved:
                    out.append(resolved[i])
                    continue
                got = self._open_payload(hdr, payloads[i])
                soft_pay = None
                if got is None and soft_src[i] is not None:
                    sd, info, off = soft_src[i]
                    soft_bufs, confs = _soft_of(sd, info)
                    soft_pay = (soft_bufs[i][off:],
                                confs[i] if confs is not None else None)
                    got = self._open_payload(hdr, *soft_pay)
                if got is None and soft0_d is not None:
                    # a parseable hard header can still carry corrupted
                    # salt/clen/nonce/flag bits; the soft header usually holds
                    # the true bytes (same decode mode assumed: a mode mismatch
                    # fails again and goes to the retry pass)
                    h2 = _parse_hdr(_soft_of(soft0_d, info0)[0][i])
                    if h2 is not None and h2.to_bytes() != hdr.to_bytes():
                        got = self._open_payload(h2, payloads[i])
                        if got is None and soft_pay is not None:
                            got = self._open_payload(h2, *soft_pay)
                out.append(got)
        # the retry's corner readers carry neither the coherent rule (those
        # rows ran extract_array's own retry) nor the full-grid read (as in
        # the JAX package, whose retry is corner-only)
        if self._params.soft_decode_fallback and self._use_corner and any(
                not _is_coherent(h) and o is None
                for h, o in zip(headers, out)):
            with span("stt.extract.soft_retry"):
                self._soft_retry_failed(headers, out)
        self._result = out
        return out

    def _extract_row(self, i: int) -> bytes | None:
        """Row i through the single-image extract_array, on the device the
        row lives on (no host copy); None on its StegoError, as the JAX
        package's batch extract does."""
        img = self._row(i)
        if self._layout == "nchw":
            img = img.permute(1, 2, 0)
        password, master_key = self._key
        try:
            with pbatch.card(img.device), span("stt.extract.row_fallback"):
                return extract_array(img, password=password,
                                     master_key=master_key,
                                     params=self._params)
        except StegoError:
            return None

    def _open_from(self, buf: bytes, conf=None) -> bytes | None:
        """AEAD-open a soft retry row [40-byte header block | payload]
        under the header it carries; with `conf` (RS) the payload holds
        coded bytes for the errors-and-erasures decode."""
        hb = buf[:header_mod.FIXED_LEN]
        if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
            return None
        return self._open_payload(Header.from_bytes(hb), buf[40:], conf)

    def _soft_pass(self, grp: list[int], hdrs: dict, L: int, R: bool):
        """One corner_soft_extract_core pass over exactly the rows `grp`,
        sized by the largest clen their headers `hdrs` claim, in the wire
        mode (L, R) and on the walk those headers select; returns (rows
        [40-byte header block | payload] per image of grp, RS confidences
        or None)."""
        hdr = HEADER_STREAM_BITS
        need = min(max(self._payload_bits(hdrs[i].clen, R) for i in grp),
                   self._cap_bits)
        total = hdr + need
        bucket_total = _bucket(total)
        piw = _is_piw(hdrs[grp[0]])
        if piw:
            needs = [hdr + min(self._payload_bits(hdrs[i].clen, R),
                               self._cap_bits) for i in grp]
            arrays = self._piw_arrays(grp, hdrs, needs, bucket_total)
        Ky, Kx = self._corner_kk
        words, confs = [], []
        for _, imgs, _, pos in self._shards(grp):
            dev = imgs.device
            if piw:
                pl, yy, xx, jj = _upload_walks(
                    _take(arrays, pos, len(grp)), dev)
                dither = (self._dither(L, bucket_total, bucket_total, dev)
                          if L else None)
            else:
                pl, yy, xx, jj = self._walk(total, 0, bucket_total, dev)
                dither = (self._dither(L, total, bucket_total, dev) if L
                          else None)
            plan = (None if piw or L else
                    self._plan(total, 0, bucket_total, dev))
            out = pbatch.corner_soft_extract_core(
                imgs, self._params.alpha, pl, yy, xx, Ky=Ky, Kx=Kx,
                center=self._params.center, layout=self._layout,
                hdr_stream_bits=hdr, jit=jj, dither=dither, qim_levels=L,
                payload_rep=1 if R else 7, plan=plan)
            w, c = out if R else (out, None)
            words.append((pos, w))
            confs.append((pos, c))
        words = _ShardRows(words, len(grp)).pull()
        conf = _ShardRows(confs, len(grp)).pull() if R else None
        return (_to_bufs(words.numpy()),
                conf.numpy() if conf is not None else None)

    def _soft_retry_failed(self, headers, out) -> None:
        """Soft-decision re-decode of the images whose header parsed but
        whose payload failed AEAD (JAX _ExtractJob._soft_retry_failed): one
        pass per (walk, QIM level, FEC) group over exactly those rows
        re-reads header AND payload by matched-filter combining of the
        Rep-3/Rep-7 copies in f32, or with RS confidences for the
        errors-and-erasures decode. Recovers margin failures the hard
        majority loses.

        Round 2 re-reads an image whose soft header disagrees with the one
        it was read under in flags, salt or clen: a flip the hard Rep-3
        majority kept can misroute, mis-size or mis-key the pass, and the
        header bins always read by the half-plane rule, so the soft header
        is reliable whatever the mode. Mutates `out`; images that still
        fail stay None."""
        cur = {i: h for i, (h, o) in enumerate(zip(headers, out))
               if not _is_coherent(h) and o is None}
        for round_ in range(2):
            groups: dict[tuple, list[int]] = {}
            for i, h in cur.items():
                groups.setdefault((_is_piw(h), *_mode(h)), []).append(i)
            retry: dict[int, Header] = {}
            for (_, L, R), grp in groups.items():
                bufs, conf = self._soft_pass(grp, cur, L, R)
                for k, i in enumerate(grp):
                    got = self._open_from(
                        bufs[k], conf[k] if conf is not None else None)
                    if got is not None:
                        out[i] = got
                        continue
                    h2 = _parse_hdr(bufs[k])
                    if round_ == 0 and h2 is not None and (
                            h2.flags != cur[i].flags
                            or h2.clen != cur[i].clen
                            or h2.salt != cur[i].salt):
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
    or version, truncation, authentication failure. One bad image never
    aborts the batch. The wire mode of each image (per-image walk, QIM
    level, RS, padding) is read from its header, so a batch may mix modes;
    a row whose header carries FLAG_COHERENT or fails both the hard and the
    soft parse is resolved by the single-image extract_array (coherent
    stegos written by either package's embed_array read back that way);
    Params.adaptive_alpha reads through one full-grid FFT per image;
    Params must give the walk (jitter, rmin, rmax, density) as embed used
    it. With Params.soft_decode_fallback (the default) an image that fails
    the hard decode is retried from the fused pass's inline matched-filter
    soft sections, then by the separate soft-decision retry pass.

    clen_hint: expected on-wire ciphertext length — the secret length, or
    header.padded_len(secret_len, q) under Params.pad_quantum=q. With it
    the header and payload of the Params' own mode decode in one device
    pass; a hint that is too small costs a second pass, never a wrong
    result.
    """
    return _ExtractJob(imgs, password, master_key, params, mesh, clen_hint,
                       layout, device).finalize()
