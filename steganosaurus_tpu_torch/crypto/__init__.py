"""Host-side crypto — the port's copy of steganosaurus_tpu/crypto/, with
the functions the port calls (byte-equal outputs, tests/test_torch_host.py
and tests/test_torch_keys.py); the two wrapped-key formats are in
keywrap.py.

The reference carries two copies of SHA-256/HMAC/PBKDF2/HKDF/ChaCha20-Poly1305
(inline in steganosaur.cpp:45-323 and again in src/crypto/); both packages
carry one.

Backends:
- SHA-256 / HMAC / PBKDF2: Python stdlib (`hashlib`, `hmac`) — OpenSSL-backed,
  RFC-identical output.
- ChaCha20-Poly1305 AEAD and the key vault: the C++ native library
  (native/, built and loaded by the port's _build / _native_loader) when
  loaded, else the pure-Python RFC 8439 implementation in `_pure.py`.
"""

from __future__ import annotations

import base64 as _b64
import hashlib
import hmac as _hmac
import os
from dataclasses import dataclass

from steganosaurus_tpu_torch import _native_loader
from steganosaurus_tpu_torch.crypto import _pure

# ---------------------------------------------------------------------------
# Hashes / MACs / KDFs (stdlib-backed)
# ---------------------------------------------------------------------------


def sha256(data: bytes) -> bytes:
    """SHA-256 (reference sha256::hash, steganosaur.cpp:64-94)."""
    return hashlib.sha256(data).digest()


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    """HMAC-SHA256 (reference sha256::hmac_sha256, steganosaur.cpp:96-110)."""
    return _hmac.new(key, msg, hashlib.sha256).digest()


def pbkdf2_hmac_sha256(password: bytes, salt: bytes, iters: int, dklen: int) -> bytes:
    """PBKDF2-HMAC-SHA256 (reference steganosaur.cpp:112-130, RFC 8018)."""
    return hashlib.pbkdf2_hmac("sha256", password, salt, iters, dklen)


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    """HKDF-extract (RFC 5869 §2.2; reference steganosaur.cpp:132-134).

    The reference calls hmac with a NULL/0-length salt for the passphrase
    path; HMAC zero-pads the key, so b"" is equivalent to 32 zero bytes.
    """
    return hmac_sha256(salt, ikm)


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    """HKDF-expand (RFC 5869 §2.3; reference steganosaur.cpp:135-147)."""
    out = bytearray()
    t = b""
    ctr = 1
    while len(out) < length:
        t = hmac_sha256(prk, t + info + bytes([ctr]))
        out += t
        ctr += 1
    return bytes(out[:length])


# ---------------------------------------------------------------------------
# AEAD (native backend if loaded, pure-Python otherwise)
# ---------------------------------------------------------------------------


def aead_seal(
    key: bytes, nonce: bytes, aad: bytes, plaintext: bytes, ref_compat: bool = True
) -> tuple[bytes, bytes]:
    """ChaCha20-Poly1305 seal -> (ciphertext, tag).

    ``ref_compat=True`` (default) emits the reference's self-consistent but
    non-RFC Poly1305 tag serialization — REQUIRED for interop with
    reference-produced stego images. ``False`` = RFC 8439. See
    crypto._pure.poly1305_mac for the full quirk analysis.
    """
    lib = _native_loader.get()
    if lib is not None:
        return lib.aead_seal(key, nonce, aad, plaintext, ref_compat)
    return _pure.aead_seal(key, nonce, aad, plaintext, ref_compat)


def aead_open(
    key: bytes, nonce: bytes, aad: bytes, ciphertext: bytes, tag: bytes,
    ref_compat: bool = True,
) -> bytes | None:
    """ChaCha20-Poly1305 open -> plaintext, or None on auth failure."""
    lib = _native_loader.get()
    if lib is not None:
        return lib.aead_open(key, nonce, aad, ciphertext, tag, ref_compat)
    return _pure.aead_open(key, nonce, aad, ciphertext, tag, ref_compat)


# ---------------------------------------------------------------------------
# Key material split (reference steganosaur.cpp:549-591)
# ---------------------------------------------------------------------------

_KEYS_INFO = b"fft_turtle:keys"
_TURTLE_INFO = b"turtle_keys"


@dataclass(frozen=True)
class KeyMaterial:
    """AEAD key + nonce + salt (reference KeyMaterial, steganosaur.cpp:550-555;
    its dead `path_key` field is dropped)."""

    aead_key: bytes  # 32
    nonce: bytes     # 12
    salt: bytes      # 16


def derive_keys(password: str, salt: bytes, iters: int) -> KeyMaterial:
    """Passphrase path (reference derive_keys, steganosaur.cpp:556-573).

    PBKDF2(pass, salt, iters) -> 32B dk; HKDF-extract(empty, dk) -> prk;
    HKDF-expand(prk, "fft_turtle:keys", 76) -> path(32,dead) || aead(32) || nonce(12).
    """
    dk = pbkdf2_hmac_sha256(password.encode(), salt, iters, 32)
    prk = hkdf_extract(b"", dk)
    okm = hkdf_expand(prk, _KEYS_INFO, 76)
    return KeyMaterial(aead_key=okm[32:64], nonce=okm[64:76], salt=salt)


def derive_keys_from_raw(master_key: bytes, salt: bytes) -> KeyMaterial:
    """Raw-key path (reference derive_keys_from_raw, steganosaur.cpp:576-591).

    HKDF-extract(salt, master) -> prk; expand as in `derive_keys` (no PBKDF2).
    """
    prk = hkdf_extract(salt, master_key)
    okm = hkdf_expand(prk, _KEYS_INFO, 76)
    return KeyMaterial(aead_key=okm[32:64], nonce=okm[64:76], salt=salt)


class VaultedKeys:
    """Derived AEAD keys living in the native mlock'd vault (native/
    keyvault.cc): derivation, seal, open, and wipe all happen inside the
    C++ library; the 32-byte AEAD key NEVER materializes as a Python
    object. Only the nonce is exported — it is public (serialized into the
    plaintext stego header, pipeline/header.py).

    Use as a context manager or call close(); __del__ is the safety net.
    """

    __slots__ = ("_lib", "_h", "nonce", "salt")

    def __init__(self, lib, handle: int, nonce: bytes, salt: bytes):
        self._lib = lib
        self._h = handle
        self.nonce = nonce
        self.salt = salt

    def seal(self, aad: bytes, plaintext: bytes,
             ref_compat: bool = True) -> tuple[bytes, bytes]:
        return self._lib.kv_seal(self._h, aad, plaintext, ref_compat)

    def open(self, aad: bytes, ciphertext: bytes, tag: bytes,
             ref_compat: bool = True) -> bytes | None:
        return self._lib.kv_open(self._h, aad, ciphertext, tag, ref_compat)

    def hkdf_expand(self, info: bytes, n: int) -> bytes:
        """HKDF-expand(aead_key, info, n) — one-way export (pad stream)."""
        return self._lib.kv_hkdf(self._h, info, n)

    def close(self) -> None:
        if self._h >= 0:
            self._lib.kv_destroy(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _FallbackKeys:
    """Same interface as VaultedKeys with the keys as Python bytes — used
    when the native library is absent (or its vault is full). Carries the
    documented weaker guarantee: immutable bytes cannot be wiped."""

    __slots__ = ("_km",)

    def __init__(self, km: KeyMaterial):
        self._km = km

    @property
    def nonce(self) -> bytes:
        return self._km.nonce

    @property
    def salt(self) -> bytes:
        return self._km.salt

    def seal(self, aad, plaintext, ref_compat=True):
        return aead_seal(self._km.aead_key, self._km.nonce, aad, plaintext,
                         ref_compat)

    def open(self, aad, ciphertext, tag, ref_compat=True):
        return aead_open(self._km.aead_key, self._km.nonce, aad, ciphertext,
                         tag, ref_compat)

    def hkdf_expand(self, info: bytes, n: int) -> bytes:
        return hkdf_expand(self._km.aead_key, info, n)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def derive_keys_vault(password: str | None, master_key: bytes | None, *,
                      salt: bytes, iters: int):
    """Hot-path key derivation: native mlock'd vault when loaded, Python
    KeyMaterial fallback otherwise. Exactly one of password/master_key must
    be set (master_key wins)."""
    lib = _native_loader.get()
    if lib is not None:
        if master_key is not None:
            h, nonce = lib.kv_derive_raw(master_key, salt)
        else:
            h, nonce = lib.kv_derive_pass(password.encode(), salt, iters)
        if h >= 0:
            return VaultedKeys(lib, h, nonce, salt)
        # vault full: degrade rather than fail (the fallback is correct,
        # just not wipe-guaranteed)
    if master_key is not None:
        return _FallbackKeys(derive_keys_from_raw(master_key, salt))
    return _FallbackKeys(derive_keys(password, salt, iters))


def derive_path_key(
    password: str | None,
    master_key: bytes | None,
    cover_hash: bytes | None = None,
) -> bytes:
    """Turtle-walk path key (reference steganosaur.cpp:1017-1040, :1154-1176).

    Deliberately salt-independent so the header can be located before the salt
    is known: SHA256(pass | master [+ cover_hash]) — the cover hash under
    Params.cover_dependent_path.
    """
    ikm = master_key if master_key is not None else password.encode()
    if cover_hash is not None:
        return sha256(ikm + cover_hash)
    return sha256(ikm)


def derive_turtle_keys(path_key: bytes) -> tuple[bytes, bytes, bytes, bytes]:
    """HKDF-expand(path_key, "turtle_keys", 128) -> (walk, R, G, B) 32B keys
    (reference steganosaur.cpp:1053-1061)."""
    sub = hkdf_expand(path_key, _TURTLE_INFO, 128)
    return sub[0:32], sub[32:64], sub[64:96], sub[96:128]


def derive_salt_path_key(path_key: bytes, salt: bytes) -> bytes:
    """Per-image payload-walk path key (Params.per_image_walk):
    SHA256(path_key || "per_image_walk" || salt). The header stays on the
    shared salt-independent walk (it must be locatable before the salt is
    known); the payload walk re-keys per image from the header's salt."""
    return sha256(path_key + b"per_image_walk" + salt)


def derive_alpha_spread_key(path_key: bytes) -> bytes:
    """32B key for the randomized-alpha keystream (Params.alpha_spread). An
    independent HKDF info label keeps the draw stream decoupled from the
    walk/plane keystreams."""
    return hkdf_expand(path_key, b"alpha_spread", 32)


def derive_qim_key(path_key: bytes) -> bytes:
    """32B key for the QIM dither keystream (Params.qim), with its own HKDF
    info label for the same reason as derive_alpha_spread_key."""
    return hkdf_expand(path_key, b"qim_dither", 32)


def get_random_bytes(n: int) -> bytes:
    """OS CSPRNG (reference crypto_utils::get_random_bytes, crypto_utils.h:87-155)."""
    return os.urandom(n)


# ---------------------------------------------------------------------------
# Encoding helpers / fingerprint (the CLI's gen-key and --key, the key tool)
# ---------------------------------------------------------------------------


def base64_encode(data: bytes) -> str:
    return _b64.b64encode(data).decode("ascii")


def base64_decode(text: str) -> bytes:
    """Base64 decode skipping whitespace (reference crypto_utils.h:456-537).

    Returns b"" on malformed input (the reference returns an empty vector).
    """
    compact = "".join(text.split())
    try:
        return _b64.b64decode(compact, validate=True)
    except Exception:
        return b""


def key_fingerprint(key: bytes) -> str:
    """First 8 bytes of SHA256(key) as lowercase hex
    (reference crypto_utils::key_fingerprint, crypto_utils.h:554-558)."""
    return sha256(key)[:8].hex()


def constant_time_compare(a: bytes, b: bytes) -> bool:
    """Timing-safe equality (reference steganosaur.cpp:327-333)."""
    return _hmac.compare_digest(a, b)


def secure_zero(buf) -> None:
    """Best-effort in-place wipe of key material (reference secure_zero,
    steganosaur.cpp:27-30 / crypto_utils.h:37-40).

    Works on mutable buffers (bytearray, numpy arrays, memoryview). Python's
    immutable `bytes` cannot be wiped in place — key material that must be
    wipeable should be held in bytearray; the C++ side wipes its own
    temporaries natively (native/aead.cc).
    """
    import numpy as _np

    if isinstance(buf, bytearray):
        for i in range(len(buf)):
            buf[i] = 0
    elif isinstance(buf, memoryview):
        buf[:] = b"\x00" * len(buf)
    elif isinstance(buf, _np.ndarray):
        buf.fill(0)
    else:
        raise TypeError(f"cannot wipe immutable/unknown buffer {type(buf)}")
