"""Keyed turtle-walk keystream expansion (host side) — the port's copy of
steganosaurus_tpu/keystream/, with the entry points the port calls
(array-equal walks, tests/test_torch_host.py).

The reference's only strictly sequential component (steganosaur.cpp:665-810) —
each accepted bin mutates the visited set, gating the next step — cannot be
vmapped. We run it on the host (C++ when built, pure Python otherwise) and feed
the resulting index arrays to one vectorized device pass.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from steganosaurus_tpu_torch import _native_loader
from steganosaurus_tpu_torch.keystream import _pure
from steganosaurus_tpu_torch.keystream import diskcache as _disk

# Expansion cache: the walk is a pure function of (keys, dims, walk params)
# and every request is a PREFIX of the same infinite sequence, so one long
# expansion serves all shorter requests. In bulk serving (shared key across
# batches) this amortizes the strictly sequential ~1.5 s/M-bit host walk to
# zero — it otherwise dominates 4K batch latency (device graphs are ~12 ms).
_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_CACHE_MAX_ENTRIES = 8
_CACHE_LOCK = threading.Lock()


def _step_budget(target: int, H: int, W: int) -> int:
    return max(10_000_000, 64 * target * 8 + 4 * H * W)


def ks_stream_bytes(key: bytes, n: int) -> bytes:
    """First `n` bytes of the KS counter-mode SHA-256 PRG (the reference's
    struct KS block layout, steganosaur.cpp:665-683: block i =
    SHA256(key || 0xAA || LE32(i))), produced without the per-byte state
    machine — used by consumers that only need a flat byte stream (e.g. the
    alpha-spread draw), not opcode/density/jitter sequencing."""
    import hashlib
    import struct

    assert len(key) == 32
    out = bytearray()
    for ctr in range(-(-n // 32)):
        out += hashlib.sha256(key + b"\xaa" + struct.pack("<I", ctr)).digest()
    return bytes(out[:n])


def _expand_v_raw(walk_key, plane_keys, H, W, rmin, rmax, density,
                  jitter_max, nbits, max_steps, allow_short,
                  init_visited, want_visited, coherent=False):
    """Visited-chaining expansion: native turtle_expand_v (coherent:
    turtle_expand_vc) when the library is loaded, pure twin otherwise
    (identical streams — tested)."""
    lib = _native_loader.get()
    if lib is not None:
        return lib.turtle_expand_v(walk_key, plane_keys, H, W, rmin, rmax,
                                   density, jitter_max, nbits, max_steps,
                                   allow_short=allow_short,
                                   init_visited=init_visited,
                                   want_visited=want_visited,
                                   coherent=coherent)
    return _pure.turtle_expand(walk_key, plane_keys, H, W, rmin, rmax,
                               density, jitter_max, nbits, max_steps,
                               allow_short=allow_short,
                               init_visited=init_visited,
                               want_visited=want_visited,
                               coherent=coherent)


# Header-prefix cache for the per-image-walk mode: the shared walk's first
# `nbits` (the 912 header stream bits) and its FINAL VISITED BITMAP are a
# pure function of (keys, dims, walk params) — one sequential run serves
# every batch under the key. Payload walks are salt-keyed (unique per image)
# and deliberately uncached.
_HDR_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_HDR_CACHE_LOCK = threading.Lock()


def header_walk_with_visited(walk_key, plane_keys, H: int, W: int,
                             rmin: float, rmax: float, density: float,
                             jitter_max: float, nbits: int,
                             coherent: bool = False) -> tuple:
    """(plane, y, x, jitter, visited_bitmap) for the shared walk's first
    `nbits` bits — the header prefix of the per-image-walk and coherent
    modes (pipeline/batch.py, pipeline/embed.py). visited_bitmap (uint64
    words, native layout) captures accepted bins, their conjugates AND
    density-skipped marks, so a chained payload expansion never collides
    with the header's bins. coherent=True (Params.coherent): the header
    rides the coherent site semantics too — a different walk from the
    standard prefix (sites are consumed whole), which is what makes the
    two-rule header trial on extraction well-defined (pipeline/extract.py).
    The key layout is the JAX package's, so both share the disk cache."""
    key = (walk_key, plane_keys, H, W, rmin, rmax, density, jitter_max,
           nbits, coherent)
    with _HDR_CACHE_LOCK:
        ent = _HDR_CACHE.get(key)
        if ent is None:
            hit = _disk.load("hdr", key)
            if hit is not None:
                arrs = hit[0]
                ent = (arrs["plane"], arrs["y"], arrs["x"], arrs["jitter"],
                       arrs["visited"])
            else:
                p, y, x, j, n, vis = _expand_v_raw(
                    walk_key, plane_keys, H, W, rmin, rmax, density,
                    jitter_max, nbits, _step_budget(nbits, H, W), False,
                    None, True, coherent=coherent)
                ent = (p, y, x, j, vis)
                _disk.store("hdr", key,
                            {"plane": p, "y": y, "x": x, "jitter": j,
                             "visited": vis}, {})
            for a in ent:
                a.setflags(write=False)
            _HDR_CACHE[key] = ent
        _HDR_CACHE.move_to_end(key)
        while len(_HDR_CACHE) > _CACHE_MAX_ENTRIES:
            _HDR_CACHE.popitem(last=False)
    return ent


def turtle_expand_chained(walk_key, plane_keys, H: int, W: int, rmin: float,
                          rmax: float, density: float, jitter_max: float,
                          nbits: int, init_visited,
                          allow_short: bool = False,
                          coherent: bool = False) -> tuple:
    """Payload expansion resuming from `init_visited` (per-image-walk mode:
    fresh salt-keyed PRGs and seed position, header bins pre-marked).
    Returns (plane, y, x, jitter, nproduced) under allow_short, else the
    4-tuple. Uncached — every (key, salt) pair is unique. coherent=True:
    coherent site semantics (Params.coherent; _pure.turtle_expand)."""
    out = _expand_v_raw(walk_key, plane_keys, H, W, rmin, rmax, density,
                        jitter_max, nbits, _step_budget(nbits, H, W),
                        allow_short, init_visited, False, coherent=coherent)
    # normalize backend return arity (native always appends nproduced)
    return out[:5] if allow_short else out[:4]


def signed_unit_offsets(key: bytes, n: int) -> np.ndarray:
    """(n,) f32 keyed draws u_i in [-1, 1): consecutive byte pairs of the KS
    stream as big-endian int16 / 32768 — the same two-byte mapping KS.jitter
    uses (keystream/_pure.py KS.jitter; reference steganosaur.cpp:690-694),
    fed from an independent key. Used for Params.alpha_spread."""
    raw = np.frombuffer(ks_stream_bytes(key, 2 * n), dtype=np.uint8)
    r = (raw[0::2].astype(np.int32) << 8) | raw[1::2].astype(np.int32)
    r = np.where(r >= 0x8000, r - 0x10000, r)
    return (r / 32768.0).astype(np.float32)


def _expand_raw(walk_key, plane_keys, H, W, rmin, rmax, density, jitter_max,
                nbits, max_steps):
    """Uncached expansion, always allow_short (5-tuple)."""
    lib = _native_loader.get()
    if lib is not None:
        return lib.turtle_expand(walk_key, plane_keys, H, W, rmin, rmax,
                                 density, jitter_max, nbits, max_steps,
                                 allow_short=True)
    return _pure.turtle_expand(walk_key, plane_keys, H, W, rmin, rmax,
                               density, jitter_max, nbits, max_steps,
                               allow_short=True)


def turtle_expand(
    walk_key: bytes,
    plane_keys: tuple[bytes, bytes, bytes],
    H: int,
    W: int,
    rmin: float,
    rmax: float,
    density: float,
    jitter_max: float,
    nbits: int,
    allow_short: bool = False,
) -> tuple:
    """Per-bit (plane, y, x, jitter) arrays for `nbits` embedded bits.

    See `_pure.turtle_expand` for exact semantics and reference citations.

    allow_short=False (default): raises RuntimeError if the walk exhausts its
    step budget (image too small for nbits); returns a 4-tuple.
    allow_short=True: on exhaustion the tail is padded with the last valid bin
    and a 5-tuple (plane, y, x, jitter, nproduced) is returned — extraction
    uses this so an oversized gather (hinted or corrupt-clen) degrades to
    garbage trailing bits instead of aborting the batch.

    Results are cached per (keys, dims, walk params) and served as read-only
    prefix views.
    """
    key = (walk_key, plane_keys, H, W, rmin, rmax, density, jitter_max)
    with _CACHE_LOCK:
        ent = _CACHE.get(key)
        if ent is None:
            # cold process: adopt a persisted expansion when it covers the
            # request (or proved exhaustion under an adequate budget)
            hit = _disk.load("walk", key)
            if hit is not None:
                arrs, meta = hit
                dn, dnavail = int(meta["nprod"]), int(meta["navail"])
                dbudget = int(meta["budget"])
                enough = dnavail >= nbits or (
                    dn < dnavail
                    and _step_budget(max(nbits, 2 * dnavail), H, W)
                    <= dbudget)
                if enough:
                    ent = (arrs["plane"], arrs["y"], arrs["x"],
                           arrs["jitter"], dn, dnavail, dbudget)
                    for a in ent[:4]:
                        a.setflags(write=False)
                    _CACHE[key] = ent
        if ent is None:
            grow = True
            target = nbits
        else:
            # Grow geometrically so repeated slightly-longer requests do not
            # re-run the sequential walk from scratch each time. A cached
            # exhaustion (nprod < navail) is only final for budgets the prior
            # expansion already covered: the step budget scales with the
            # target, so a larger request must retry with its larger budget
            # rather than inherit a smaller run's give-up point.
            target = max(nbits, 2 * ent[5])
            exhausted = ent[4] < ent[5]
            grow = ent[5] < nbits and (
                not exhausted or _step_budget(target, H, W) > ent[6])
        if grow:
            # The +4*H*W term covers the initial diffusion to the annulus:
            # the +-1 random walk needs ~distance^2 steps to reach it from a
            # random seed, which dominates small-nbits requests on big grids.
            budget = _step_budget(target, H, W)
            p, y, x, j, n = _expand_raw(walk_key, plane_keys, H, W, rmin,
                                        rmax, density, jitter_max, target,
                                        budget)
            for a in (p, y, x, j):
                a.setflags(write=False)
            ent = (p, y, x, j, n, target, budget)
            _CACHE[key] = ent
            _disk.store("walk", key, {"plane": p, "y": y, "x": x,
                                      "jitter": j},
                        {"nprod": int(n), "navail": int(target),
                         "budget": int(budget)})
        _CACHE.move_to_end(key)
        while len(_CACHE) > _CACHE_MAX_ENTRIES:
            _CACHE.popitem(last=False)

    p, y, x, j, nprod, navail = ent[:6]
    if nbits <= navail:
        p, y, x, j = p[:nbits], y[:nbits], x[:nbits], j[:nbits]
    else:  # cached walk exhausted below request: extend with last-bin padding
        pad = nbits - navail
        p = np.concatenate([p, np.repeat(p[-1], pad)])
        y = np.concatenate([y, np.repeat(y[-1], pad)])
        x = np.concatenate([x, np.repeat(x[-1], pad)])
        j = np.concatenate([j, np.zeros(pad, j.dtype)])
    n = min(nprod, nbits)
    if allow_short:
        return p, y, x, j, n
    if n < nbits:
        raise RuntimeError(
            f"turtle walk exhausted at bit {n}/{nbits} — image too small for "
            f"the requested bit count"
        )
    return p, y, x, j
