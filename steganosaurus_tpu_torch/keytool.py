"""`turtlefft-key` CLI — the port's copy of steganosaurus_tpu/keytool.py,
with the same messages and exit codes (tests/test_torch_keys.py), and
compatible with the reference key tool (tools/turtlefft-key.cpp):
gen/wrap/unwrap/export of 256-bit master keys using the 81-byte versioned
TFKW format (PBKDF2 fixed 200k iters, header-as-AAD). Host only: it touches
no device.

    python -m steganosaurus_tpu_torch.keytool --gen-key   (bin/turtlefft-key-torch)

NOTE the reference interop bug (SURVEY.md §3.4): this tool's 81B format is
incompatible with `turtlefft --key`'s 80B format. Reproduced as-is; both
formats are readable via crypto.keywrap.
"""

from __future__ import annotations

import sys

from steganosaurus_tpu_torch import crypto
from steganosaurus_tpu_torch.crypto import keywrap

USAGE = """turtlefft-key: Secure key generation and management for TurtleFFT

Usage:
  turtlefft-key --gen-key [OPTIONS]
    Generate a new 256-bit key
    Options:
      --key-out FILE    Write key to FILE (default: stdout as base64)
      --wrap PASSPHRASE Wrap key with passphrase before output
      --hex             Output raw key as hex (only without --wrap)

  turtlefft-key --unwrap FILE --pass PASSPHRASE [OPTIONS]
    Unwrap a passphrase-protected key
    Options:
      --key-out FILE    Write unwrapped key to FILE (default: stdout as base64)
      --hex             Output as hex instead of base64

  turtlefft-key --export-hex FILE [--pass PASSPHRASE]
    Export key from FILE as hex
    Use --pass if the key is wrapped

Wrapped key format uses:
  - PBKDF2-HMAC-SHA256 with 16-byte salt and 200000 iterations
  - ChaCha20-Poly1305 AEAD with 12-byte nonce
"""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    mode = key_out = wrap_pw = unwrap_file = export_file = passphrase = ""
    out_hex = False
    i = 1
    while i < len(argv):
        arg = argv[i]

        def need():
            nonlocal i
            i += 1
            return argv[i] if i < len(argv) else ""

        if arg == "--gen-key":
            mode = "gen-key"
        elif arg == "--unwrap":
            mode, unwrap_file = "unwrap", need()
        elif arg == "--export-hex":
            mode, export_file = "export-hex", need()
        elif arg == "--key-out":
            key_out = need()
        elif arg == "--wrap":
            wrap_pw = need()
        elif arg == "--pass":
            passphrase = need()
        elif arg == "--hex":
            out_hex = True
        elif arg in ("--help", "-h"):
            print(USAGE, file=sys.stderr)
            return 0
        else:
            print(f"Error: Unknown option: {arg}", file=sys.stderr)
            print(USAGE, file=sys.stderr)
            return 1
        i += 1

    def emit_key(key: bytes) -> None:
        if key_out:
            with open(key_out, "wb") as f:
                f.write(key)
        else:
            print(key.hex() if out_hex else crypto.base64_encode(key))

    if mode == "gen-key":
        key = crypto.get_random_bytes(32)
        if wrap_pw:
            wrapped = keywrap.wrap_key_tool(key, wrap_pw)
            if key_out:
                with open(key_out, "wb") as f:
                    f.write(wrapped)
                print(f"Wrapped key written to: {key_out}")
            else:
                print(crypto.base64_encode(wrapped))
        else:
            if key_out:
                with open(key_out, "wb") as f:
                    f.write(key)
                print(f"Key written to: {key_out}")
            else:
                print(key.hex() if out_hex else crypto.base64_encode(key))
        return 0

    if mode == "unwrap":
        if not unwrap_file:
            print("Error: --unwrap requires a file path", file=sys.stderr)
            return 1
        if not passphrase:
            print("Error: --unwrap requires --pass PASSPHRASE", file=sys.stderr)
            return 1
        with open(unwrap_file, "rb") as f:
            wrapped = f.read()
        key = keywrap.unwrap_key_tool(wrapped, passphrase)
        if key is None:
            print(
                "Error: Authentication failed (wrong passphrase or corrupted key)",
                file=sys.stderr,
            )
            return 1
        if key_out:
            with open(key_out, "wb") as f:
                f.write(key)
            print(f"Unwrapped key written to: {key_out}")
        else:
            print(key.hex() if out_hex else crypto.base64_encode(key))
        return 0

    if mode == "export-hex":
        if not export_file:
            print("Error: --export-hex requires a file path", file=sys.stderr)
            return 1
        with open(export_file, "rb") as f:
            data = f.read()
        if len(data) == keywrap.TOOL_WRAPPED_LEN:
            if not passphrase:
                print("Error: Wrapped key requires --pass PASSPHRASE", file=sys.stderr)
                return 1
            key = keywrap.unwrap_key_tool(data, passphrase)
            if key is None:
                print(
                    "Error: Authentication failed (wrong passphrase or corrupted key)",
                    file=sys.stderr,
                )
                return 1
        elif len(data) == 32:
            key = data
        else:
            print(
                f"Error: Invalid key file size (expected 32 or "
                f"{keywrap.TOOL_WRAPPED_LEN} bytes)",
                file=sys.stderr,
            )
            return 1
        print(key.hex())
        return 0

    print("Error: No valid mode specified", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
