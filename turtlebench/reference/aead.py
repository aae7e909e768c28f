"""ChaCha20-Poly1305 and the key split, written out plainly for the
benchmark's reference (RFC 8439, with the upstream TurtleFFT tag quirk).

ChaCha20 runs every block of a message at once in numpy. Poly1305 uses
Python integers. The upstream tag serialisation adds the high bits of each
26-bit limb twice (an unmasked carry); embed and extract share it, so the
tag is reproduced as upstream writes it. Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

import numpy as np

from turtlebench.reference.walk import hkdf_expand

_SIGMA = np.frombuffer(b"expand 32-byte k", "<u4")
_P1305 = (1 << 130) - 5
_M32 = 0xFFFFFFFF


def derive_keys(master_key: bytes, salt: bytes) -> tuple[bytes, bytes]:
    """(AEAD key, nonce) of a raw master key and a salt:
    HKDF-Extract(salt, master key), then HKDF-Expand(prk,
    "fft_turtle:keys", 76) = an unused 32-byte path key || key || nonce."""
    prk = hmac.new(salt, master_key, hashlib.sha256).digest()
    okm = hkdf_expand(prk, b"fft_turtle:keys", 76)
    return okm[32:64], okm[64:76]


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def chacha20_blocks(key: bytes, nonce: bytes, first: int, n: int) -> bytes:
    """n consecutive 64-byte ChaCha20 blocks from counter `first`."""
    init = np.empty((16, n), np.uint32)
    init[0:4] = _SIGMA[:, None]
    init[4:12] = np.frombuffer(key, "<u4")[:, None]
    init[12] = (np.arange(first, first + n, dtype=np.uint64) & _M32).astype(
        np.uint32)
    init[13:16] = np.frombuffer(nonce, "<u4")[:, None]
    s = [init[i].copy() for i in range(16)]

    def quarter(a, b, c, d):
        s[a] += s[b]
        s[d] = _rotl(s[d] ^ s[a], 16)
        s[c] += s[d]
        s[b] = _rotl(s[b] ^ s[c], 12)
        s[a] += s[b]
        s[d] = _rotl(s[d] ^ s[a], 8)
        s[c] += s[d]
        s[b] = _rotl(s[b] ^ s[c], 7)

    for _ in range(10):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)
    out = np.stack(s) + init                     # (16, n), wraps mod 2^32
    return out.T.astype("<u4").tobytes()


def _xor(key: bytes, nonce: bytes, data: bytes) -> bytes:
    n = -(-len(data) // 64)
    ks = np.frombuffer(chacha20_blocks(key, nonce, 1, n), np.uint8)
    return (np.frombuffer(data, np.uint8) ^ ks[:len(data)]).tobytes()


def poly1305(msg: bytes, otk: bytes) -> bytes:
    """The Poly1305 tag of msg under the one-time key, serialised as
    upstream does (26-bit limbs, the carry of each word left unmasked)."""
    r = int.from_bytes(otk[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    acc = 0
    for off in range(0, len(msg), 16):
        block = msg[off:off + 16]
        acc = ((acc + int.from_bytes(block, "little")
                + (1 << (8 * len(block)))) * r) % _P1305
    h = [(acc >> (26 * i)) & 0x3FFFFFF for i in range(5)]
    sp = struct.unpack("<4I", otk[16:32])
    f0 = (h[0] | (h[1] << 26)) + sp[0]
    f1 = ((h[1] >> 6) | (h[2] << 20)) + sp[1] + (f0 >> 32)
    f2 = ((h[2] >> 12) | (h[3] << 14)) + sp[2] + (f1 >> 32)
    f3 = ((h[3] >> 18) | (h[4] << 8)) + sp[3] + (f2 >> 32)
    return struct.pack("<4I", f0 & _M32, f1 & _M32, f2 & _M32, f3 & _M32)


def _mac_input(aad: bytes, ct: bytes) -> bytes:
    def pad(n):
        return b"\x00" * ((16 - n % 16) % 16)
    return (aad + pad(len(aad)) + ct + pad(len(ct))
            + struct.pack("<QQ", len(aad), len(ct)))


def seal(key: bytes, nonce: bytes, aad: bytes, pt: bytes) -> tuple[bytes,
                                                                  bytes]:
    """(ciphertext, tag): the one-time key is block 0, the text from 1."""
    otk = chacha20_blocks(key, nonce, 0, 1)[:32]
    ct = _xor(key, nonce, pt)
    return ct, poly1305(_mac_input(aad, ct), otk)


def open_(key: bytes, nonce: bytes, aad: bytes, ct: bytes,
          tag: bytes) -> bytes | None:
    """The plaintext, or None when the tag does not match."""
    otk = chacha20_blocks(key, nonce, 0, 1)[:32]
    if not hmac.compare_digest(poly1305(_mac_input(aad, ct), otk), tag):
        return None
    return _xor(key, nonce, ct)
