"""Structured debug tracing (the reference's -DDEBUG=1 stderr prints) — the
port's copy of steganosaurus_tpu/utils/debug.py.

The reference gates per-bit coordinate dumps behind a compile-time DEBUG
macro (steganosaur.cpp:9-11; prints at :918-919, :949-961, :1082-1094,
:1125-1130, :1211-1218). Here the same dumps are runtime-gated by
STEGANOSAURUS_DEBUG=1, which is how cross-implementation bin-coordinate
diffs against the reference debug build are captured (SURVEY.md §5
"keep a debug mode that dumps the first-N bin coordinates").
"""

from __future__ import annotations

import os
import sys

N_BITS_TO_DUMP = 10  # the reference dumps bits 0..9 (steganosaur.cpp:1082)


def enabled() -> bool:
    return os.environ.get("STEGANOSAURUS_DEBUG", "") not in ("", "0")


def log(msg: str) -> None:
    if enabled():
        print(f"[DEBUG] {msg}", file=sys.stderr, flush=True)


def dump_dims(tag: str, H: int, W: int, PH: int, PW: int) -> None:
    # reference :918-919 prints image and padded FFT dims
    log(f"{tag}: image {W}x{H}, spectral grid {PW}x{PH}")


def dump_key_prefix(tag: str, key: bytes) -> None:
    # reference :949-961 prints first 8 bytes of derived keys
    log(f"{tag}: {key[:8].hex()}")


def dump_walk(tag: str, plane, y, x, n: int = N_BITS_TO_DUMP) -> None:
    # reference :1082-1094 / :1211-1218 print per-bit plane/y/x for bits 0..9
    if not enabled():
        return
    for i in range(min(n, len(plane))):
        log(f"{tag} bit {i}: plane={int(plane[i])} y={int(y[i])} x={int(x[i])}")


def dump_header(tag: str, header_bytes: bytes) -> None:
    # reference :1232-1235 prints decoded header bytes
    log(f"{tag}: {header_bytes.hex()}")
