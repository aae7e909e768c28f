"""The keyed turtle walk, written out plainly for the benchmark's reference.

A frozen restatement of the walk the steganography uses (the upstream
TurtleFFT `KS` and `Turtle` structs): a counter-mode SHA-256 byte stream
drives a turtle over the (plane, y, x) spectrum grid, three bits an opcode;
a step lands on a candidate bin when the bin is off the axes and the
Nyquist lines, unvisited, inside the annulus rmin..rmax * min(H, W), and its
Hermitian conjugate is unvisited; a candidate is taken when the next stream
byte is under floor(density * 256), and taken or skipped it is marked
visited together with its conjugate. Only the shared walk with no jitter is
restated: the jitter streams are independent of the walk and the
benchmark's configurations write no jitter.

It imports nothing of the program. It is plain Python, one loop iteration a
step, so a 4K walk of ~1M bits takes a minute or two; `cached_walk` keeps
each walk it computes in the benchmark's cache directory, keyed by every
input, so a checkout computes each walk once.
"""

from __future__ import annotations

import hashlib
import hmac
import math
import pathlib
import struct

import numpy as np


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    """HKDF-Expand with HMAC-SHA256 (RFC 5869 section 2.3)."""
    out = bytearray()
    t = b""
    ctr = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([ctr]), hashlib.sha256).digest()
        out += t
        ctr += 1
    return bytes(out[:length])


def walk_key(master_key: bytes) -> bytes:
    """The walk's stream key of a raw master key: the path key is
    SHA-256(master key), salt-independent so that the header can be found
    before its salt is read; HKDF-Expand(path key, "turtle_keys", 128) gives
    the walk key and three jitter keys, of which the walk key comes first."""
    path_key = hashlib.sha256(master_key).digest()
    return hkdf_expand(path_key, b"turtle_keys", 128)[:32]


def _start(key: bytes, H: int, W: int) -> tuple[int, int, int]:
    """The turtle's first (y, x, plane)."""
    h = hashlib.sha256(b"seed:" + f"{H}x{W}".encode() + b"|key:" + key)
    s = int.from_bytes(h.digest()[:8], "big")
    return s % H, (s >> 16) % W, (s >> 32) % 3


def expand(key: bytes, H: int, W: int, rmin: float, rmax: float,
           density: float, nbits: int) -> tuple[np.ndarray, ...]:
    """(plane, y, x) int32 arrays of the first `nbits` walk bins. Raises
    when the walk runs out of steps (max(1e7, 512 nbits + 4 H W)) first."""
    stream = bytearray()
    ctr = 0

    def more():
        nonlocal ctr
        chunk = bytearray()
        for c in range(ctr, ctr + 4096):
            chunk += hashlib.sha256(key + b"\xaa" + struct.pack("<I", c)).digest()
        ctr += 4096
        return chunk

    y, x, plane = _start(key, H, W)
    HW = H * W
    H2 = H // 2 if H % 2 == 0 else -1
    W2 = W // 2 if W % 2 == 0 else -1
    rlo = rmin * min(H, W)
    rhi = rmax * min(H, W)
    thresh = int(math.floor(density * 256.0)) & 0xFF
    max_steps = max(10_000_000, 64 * nbits * 8 + 4 * HW)
    visited = bytearray(3 * HW)
    out = np.empty((3, nbits), np.int32)
    hypot = math.hypot
    pool = 0
    bits = 0
    pos = 0
    steps = 0
    i = 0
    while i < nbits:
        while True:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"walk ran out of steps at bit {i}/{nbits}")
            if bits < 3:
                if pos == len(stream):
                    stream = stream[pos:] + more()
                    pos = 0
                pool = ((pool << 8) | stream[pos]) & 0xFFFFFFFF
                pos += 1
                bits += 8
            bits -= 3
            op = (pool >> bits) & 7
            if op == 0:
                plane = (plane + 1) % 3
            elif op == 1:
                x = (x + 1) % W
            elif op == 2:
                y = (y + 1) % H
            elif op == 3:
                x = (x - 1) % W
            elif op == 4:
                y = (y - 1) % H
            elif op == 5:
                x = (x + 1) % W
                y = (y + 1) % H
            elif op == 6:
                x = (x - 1) % W
                y = (y + 1) % H
            if y == 0 or x == 0 or y == H2 or x == W2:
                continue
            f = plane * HW + y * W + x
            if visited[f]:
                continue
            r = hypot(y, x)
            if r < rlo or r > rhi:
                continue
            g = plane * HW + (H - y) * W + (W - x)
            if visited[g]:
                continue
            break
        if pos == len(stream):
            stream = stream[pos:] + more()
            pos = 0
        take = stream[pos] < thresh
        pos += 1
        visited[f] = 1
        visited[g] = 1
        if take:
            out[0, i] = plane
            out[1, i] = y
            out[2, i] = x
            i += 1
    return out[0], out[1], out[2]


def cached_walk(cache_dir: pathlib.Path | None, key: bytes, H: int, W: int,
                rmin: float, rmax: float, density: float,
                nbits: int) -> tuple[np.ndarray, ...]:
    """expand(), kept in `cache_dir` (None: not kept) under a digest of
    every input. A file that does not load is computed again."""
    if cache_dir is None:
        return expand(key, H, W, rmin, rmax, density, nbits)
    tag = hashlib.sha256(repr((key.hex(), H, W, rmin, rmax, density,
                               nbits)).encode()).hexdigest()[:32]
    path = pathlib.Path(cache_dir) / f"walk_{tag}.npy"
    try:
        arr = np.load(path)
        if arr.shape == (3, nbits):
            return arr[0], arr[1], arr[2]
    except (OSError, ValueError):
        pass
    walk = expand(key, H, W, rmin, rmax, density, nbits)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, np.stack(walk))
    tmp.replace(path)
    return walk
