"""MSB-first big-endian i32 word packing between bytes and bits.

Host side (numpy): byte strings -> words, the layout the embed core takes,
and bit frames -> words -> bits (the twins of steganosaurus_tpu/parallel/
batch.py pack_bytes_words_host, pack_bits_words_host, unpack_words_host).
Device side (torch): words -> bits and bits -> words, the pair that
steganosaurus_tpu.parallel.batch._unpack_bits_words / _pack_bits_words run
inside the jitted cores. A word's bytes are big-endian and its bits
MSB-first, so words.view(uint32).astype('>u4').tobytes() is the byte
stream.
"""

from __future__ import annotations

import numpy as np
import torch


def _be_words(byts: np.ndarray) -> np.ndarray:
    """(B, 4k) u8 -> (B, k) int32, big-endian within each word."""
    a = byts.reshape(byts.shape[0], -1, 4).astype(np.uint32)
    words = (a[:, :, 0] << 24) | (a[:, :, 1] << 16) | (a[:, :, 2] << 8) \
        | a[:, :, 3]
    return words.view(np.int32)


def pack_bytes_words_host(rows: list[bytes]) -> np.ndarray:
    """(B,) equal-length byte strings -> (B, ceil(len/4)) int32 big-endian
    words, zero-padded (the layout unpack_bits_words inverts MSB-first)."""
    n = len(rows[0])
    arr = np.zeros((len(rows), -(-n // 4) * 4), np.uint8)
    for i, r in enumerate(rows):
        arr[i, :n] = np.frombuffer(r, np.uint8)
    return _be_words(arr)


def pack_bits_words_host(bits: np.ndarray) -> np.ndarray:
    """(B, n) 0/1 u8 -> (B, ceil(n/32)) int32 words, MSB first, the last
    word zero-padded (the twin of steganosaurus_tpu/parallel/batch.py
    pack_bits_words_host; unpack_bits_words inverts it)."""
    byts = np.packbits(np.asarray(bits, np.uint8), axis=1)
    pad = (-byts.shape[1]) % 4
    if pad:
        byts = np.pad(byts, ((0, 0), (0, pad)))
    return _be_words(byts)


def unpack_words_host(words: np.ndarray, n: int) -> np.ndarray:
    """(B, k) int32 words -> (B, n) u8 bits, MSB first (the host twin of
    unpack_bits_words; steganosaurus_tpu/parallel/batch.py
    unpack_words_host)."""
    byts = np.asarray(words).view(np.uint32).astype(">u4").view(np.uint8)
    return np.unpackbits(byts.reshape(words.shape[0], -1), axis=1)[:, :n]


def unpack_bits_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n/32) int32 words -> (..., n) u8 bits, MSB first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(31, -1, -1, device=words.device)
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].to(torch.uint8)


def pack_bits_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) 0/1 -> (..., ceil(m/32)) int32 words, MSB first, the last
    word zero-padded."""
    m = bits.shape[-1]
    pad = (-m) % 32
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    weights = torch.ones((), dtype=torch.int64, device=b.device) << \
        torch.arange(31, -1, -1, device=b.device)
    v = (b.reshape(*b.shape[:-1], -1, 32) * weights).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
