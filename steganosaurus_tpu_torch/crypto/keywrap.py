"""Passphrase-wrapped master-key formats (the port's host copy of
steganosaurus_tpu/crypto/keywrap.py, byte-equal blobs under the same
randomness: tests/test_torch_keys.py).

The reference has TWO incompatible wrapped formats (SURVEY.md §3.4):

- **Main-binary format** (steganosaur.cpp:593-662, do_gen_key :1334-1410):
  80 bytes = "TFKW"(4) || SALT(16) || NONCE(12) || CT(32) || TAG(16), base64
  text in the key file. PBKDF2(wrap-pass, salt, `pbkdf2_iter`) -> 44B =
  wrapkey(32) || derived_nonce(12); encrypt uses the derived nonce (which is
  then stored), decrypt uses the STORED nonce; **no AAD**.

- **turtlefft-key tool format** (tools/turtlefft-key.cpp:27-110): 81 bytes =
  "TFKW"(4) || VER=1(1) || SALT(16) || NONCE(12) || CT(32) || TAG(16), raw
  binary in the file. PBKDF2 fixed 200,000 iters, random nonce, AAD = the
  19-byte header MAGIC||VER||SALT||NONCE.

We implement both bit-compatibly. Readers accept both; each writer mirrors its
reference counterpart so the reference binaries and this framework interoperate
in both directions.
"""

from __future__ import annotations

from steganosaurus_tpu_torch import crypto

MAGIC = b"TFKW"
MAIN_WRAPPED_LEN = 4 + 16 + 12 + 32 + 16          # 80
TOOL_WRAPPED_LEN = 4 + 1 + 16 + 12 + 32 + 16      # 81
TOOL_VERSION = 1
TOOL_PBKDF2_ITERS = 200_000


# ---------------------------------------------------------------------------
# Main-binary format (80B, no version, no AAD)
# ---------------------------------------------------------------------------


def wrap_key_main(master_key: bytes, wrap_pass: str, pbkdf2_iter: int) -> bytes:
    """Wrap per do_gen_key (steganosaur.cpp:1337-1382). Returns the 80B blob."""
    salt = crypto.get_random_bytes(16)
    derived = crypto.pbkdf2_hmac_sha256(wrap_pass.encode(), salt, pbkdf2_iter, 44)
    wrap_key, nonce = derived[:32], derived[32:44]
    ct, tag = crypto.aead_seal(wrap_key, nonce, b"", master_key)
    return MAGIC + salt + nonce + ct + tag


def unwrap_key_main(blob: bytes, wrap_pass: str, pbkdf2_iter: int) -> bytes | None:
    """Unwrap per decode_or_unwrap_key (steganosaur.cpp:607-653).

    PBKDF2-derives 44B but decrypts with the *stored* nonce; no AAD.
    """
    if len(blob) != MAIN_WRAPPED_LEN or blob[:4] != MAGIC:
        return None
    salt = blob[4:20]
    nonce = blob[20:32]
    ct = blob[32:64]
    tag = blob[64:80]
    derived = crypto.pbkdf2_hmac_sha256(wrap_pass.encode(), salt, pbkdf2_iter, 44)
    wrap_key = derived[:32]
    return crypto.aead_open(wrap_key, nonce, b"", ct, tag)


# ---------------------------------------------------------------------------
# Tool format (81B, versioned, header-as-AAD)
# ---------------------------------------------------------------------------


def wrap_key_tool(master_key: bytes, wrap_pass: str) -> bytes:
    """Wrap per turtlefft-key.cpp:70-110. Returns the 81B blob."""
    salt = crypto.get_random_bytes(16)
    nonce = crypto.get_random_bytes(12)
    wrap_key = crypto.pbkdf2_hmac_sha256(wrap_pass.encode(), salt, TOOL_PBKDF2_ITERS, 32)
    header = MAGIC + bytes([TOOL_VERSION]) + salt + nonce
    ct, tag = crypto.aead_seal(wrap_key, nonce, header, master_key)
    return header + ct + tag


def unwrap_key_tool(blob: bytes, wrap_pass: str) -> bytes | None:
    """Unwrap per turtlefft-key.cpp:112-158."""
    if len(blob) != TOOL_WRAPPED_LEN or blob[:4] != MAGIC or blob[4] != TOOL_VERSION:
        return None
    salt = blob[5:21]
    nonce = blob[21:33]
    ct = blob[33:65]
    tag = blob[65:81]
    wrap_key = crypto.pbkdf2_hmac_sha256(wrap_pass.encode(), salt, TOOL_PBKDF2_ITERS, 32)
    header = blob[:33]
    return crypto.aead_open(wrap_key, nonce, header, ct, tag)


# ---------------------------------------------------------------------------
# `--key` argument decode (base64 raw | base64 main-wrapped)
# ---------------------------------------------------------------------------


def decode_or_unwrap_key(key_b64: str, wrap_pass: str, pbkdf2_iter: int) -> bytes | None:
    """Decode a `--key` value (reference decode_or_unwrap_key, :599-662).

    80B main TFKW blob -> unwrap (requires wrap_pass); 32B -> raw key.
    ALSO accepts the key tool's 81B versioned TFKW-v1 format — the reference
    has an interop bug where `turtlefft --key` rejects keys wrapped by its
    own `turtlefft-key` tool (SURVEY.md §3.4); reading both fixes it without
    changing what either writer emits.
    """
    decoded = crypto.base64_decode(key_b64)
    if not decoded and key_b64:
        return None
    if len(decoded) == MAIN_WRAPPED_LEN and decoded[:4] == MAGIC:
        if not wrap_pass:
            return None
        return unwrap_key_main(decoded, wrap_pass, pbkdf2_iter)
    if (len(decoded) == TOOL_WRAPPED_LEN and decoded[:4] == MAGIC
            and decoded[4] == TOOL_VERSION):
        if not wrap_pass:
            return None
        return unwrap_key_tool(decoded, wrap_pass)
    if len(decoded) == 32:
        return decoded
    return None
