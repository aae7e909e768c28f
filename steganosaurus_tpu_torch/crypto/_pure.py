"""Pure-Python ChaCha20-Poly1305 AEAD (RFC 8439), clean-room from the RFC —
the port's copy of steganosaurus_tpu/crypto/_pure.py.

This is the fallback backend; the C++ native backend (native/aead.cc) is used
when built. Behavior matches the reference's two duplicated implementations
(steganosaur.cpp:150-323 and src/crypto/chacha20poly1305.cpp) — the rebuild has
exactly one crypto component per SURVEY.md §1.

Poly1305 here uses Python big ints (clean and correct); the reference uses
26-bit limbs — same math, different radix.
"""

from __future__ import annotations

import hmac as _hmac
import struct

_SIGMA = b"expand 32-byte k"
_MASK32 = 0xFFFFFFFF
_P1305 = (1 << 130) - 5


def _rotl32(v: int, n: int) -> int:
    return ((v << n) & _MASK32) | (v >> (32 - n))


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 7)


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    """One 64-byte ChaCha20 block (RFC 8439 §2.3)."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("chacha20: key must be 32B, nonce 12B")
    init = list(struct.unpack("<4I", _SIGMA))
    init += list(struct.unpack("<8I", key))
    init.append(counter & _MASK32)
    init += list(struct.unpack("<3I", nonce))
    st = init[:]
    for _ in range(10):
        _quarter(st, 0, 4, 8, 12)
        _quarter(st, 1, 5, 9, 13)
        _quarter(st, 2, 6, 10, 14)
        _quarter(st, 3, 7, 11, 15)
        _quarter(st, 0, 5, 10, 15)
        _quarter(st, 1, 6, 11, 12)
        _quarter(st, 2, 7, 8, 13)
        _quarter(st, 3, 4, 9, 14)
    out = [(s + i) & _MASK32 for s, i in zip(st, init)]
    return struct.pack("<16I", *out)


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 1) -> bytes:
    """XOR `data` with the ChaCha20 keystream starting at block `counter`."""
    out = bytearray(len(data))
    for off in range(0, len(data), 64):
        ks = chacha20_block(key, counter, nonce)
        counter += 1
        chunk = data[off : off + 64]
        for i, byte in enumerate(chunk):
            out[off + i] = byte ^ ks[i]
    return bytes(out)


def poly1305_mac(msg: bytes, key: bytes, ref_compat: bool = True) -> bytes:
    """Poly1305 one-time MAC (RFC 8439 §2.5) with a reference-compat mode.

    REFERENCE QUIRK (must-reproduce for interop): the reference's final tag
    serialization (steganosaur.cpp:261-264, chacha20poly1305.cpp:180-188)
    converts the 26-bit limbs of h to 32-bit words with an UNMASKED carry —
    `f1 = ((h1>>6)|(h2<<20)) + s1 + (f0>>32)` where f0 still holds ALL of
    h1<<26 — so the high bits of each limb are added TWICE (once explicitly,
    once via the carry). The tag therefore differs from RFC 8439 whenever
    h1 >= 64 (essentially always), but embed and extract share the bug, so the
    reference is self-consistent. `ref_compat=True` (default) reproduces it;
    `ref_compat=False` is the RFC-correct tag. Verified empirically: the
    reference binary's stego images authenticate only under compat mode.
    """
    if len(key) != 32:
        raise ValueError("poly1305: key must be 32B")
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    acc = 0
    for off in range(0, len(msg), 16):
        block = msg[off : off + 16]
        n = int.from_bytes(block, "little") + (1 << (8 * len(block)))
        acc = ((acc + n) * r) % _P1305
    if not ref_compat:
        s = int.from_bytes(key[16:], "little")
        return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")
    # Reference-compat serialization: 26-bit limbs of (acc mod p), then the
    # buggy f-chain with double-counted carries.
    h = [(acc >> (26 * i)) & 0x3FFFFFF for i in range(5)]
    sp = [int.from_bytes(key[16 + 4 * i : 20 + 4 * i], "little") for i in range(4)]
    f0 = (h[0] | (h[1] << 26)) + sp[0]
    f1 = ((h[1] >> 6) | (h[2] << 20)) + sp[1] + (f0 >> 32)
    f2 = ((h[2] >> 12) | (h[3] << 14)) + sp[2] + (f1 >> 32)
    f3 = ((h[3] >> 18) | (h[4] << 8)) + sp[3] + (f2 >> 32)
    return struct.pack(
        "<4I", f0 & _MASK32, f1 & _MASK32, f2 & _MASK32, f3 & _MASK32
    )


def _pad16(n: int) -> bytes:
    return b"\x00" * ((16 - n % 16) % 16)


def _aead_mac_input(aad: bytes, ct: bytes) -> bytes:
    # MAC over aad || pad16 || ct || pad16 || le64(len(aad)) || le64(len(ct))
    # (RFC 8439 §2.8; reference steganosaur.cpp:281-289)
    return (
        aad
        + _pad16(len(aad))
        + ct
        + _pad16(len(ct))
        + struct.pack("<QQ", len(aad), len(ct))
    )


def aead_seal(
    key: bytes, nonce: bytes, aad: bytes, plaintext: bytes, ref_compat: bool = True
) -> tuple[bytes, bytes]:
    """AEAD_CHACHA20_POLY1305 encrypt. Returns (ciphertext, tag).

    One-time Poly key = first 32B of ChaCha20 block at counter 0; encryption
    starts at counter 1 (reference steganosaur.cpp:273-293). Default tags are
    reference-compatible (see poly1305_mac docstring).
    """
    otk = chacha20_block(key, 0, nonce)[:32]
    ct = chacha20_xor(key, nonce, plaintext, counter=1)
    tag = poly1305_mac(_aead_mac_input(aad, ct), otk, ref_compat)
    return ct, tag


def aead_open(
    key: bytes, nonce: bytes, aad: bytes, ciphertext: bytes, tag: bytes,
    ref_compat: bool = True,
) -> bytes | None:
    """AEAD_CHACHA20_POLY1305 decrypt. Returns plaintext or None on auth failure.

    Constant-time tag compare (reference steganosaur.cpp:309-315 uses a
    volatile XOR-accumulate; hmac.compare_digest is the Python equivalent).
    """
    otk = chacha20_block(key, 0, nonce)[:32]
    expect = poly1305_mac(_aead_mac_input(aad, ciphertext), otk, ref_compat)
    if not _hmac.compare_digest(expect, tag):
        return None
    return chacha20_xor(key, nonce, ciphertext, counter=1)
