"""The embed and the extract of the shared-walk corner path, written out
plainly in float64 PyTorch for the benchmark's reference.

Wire format (upstream TurtleFFT, version 2): a 38-byte header MAGIC "FTTG"
|| VER 2 || FLAGS || SALT(16) || NONCE(12) || CLEN(4, big-endian) is the
AEAD's associated data; the stream header || ciphertext || tag is framed
as Rep-3 over the header's bits and Rep-7 over the rest, MSB first, and
bit j of the frame is written at bin j of the key's walk.

Spectrum: C[y, x] = sum_{h, w} planes[h, w] e^{+2 pi i (yh/H + xw/W)}, the
conjugate of torch.fft.fft2. Write: at each walk bin the value moves to
|C| e^{i s alpha}, s = +1 for a 1 bit and -1 for a 0 bit; the delta D =
2 (new - C) (the Hermitian half, doubled), boosted per image by the write
floor, and the stego is floor(planes + Re(ifft2(conj D)) + 0.5) clamped to
[0, 255]. Read: a bit is 1 when sign(sin alpha) Im C >= 0; Rep groups vote
by majority.

Everything is computed in float64 with full FFTs, image by image, and
imports nothing of the program.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from turtlebench.reference import aead

MAGIC = b"FTTG"
HEADER_BYTES = 38
HEADER_SLOTS = HEADER_BYTES * 8 * 3


def frame_slots(secret_len: int) -> int:
    """Walk bins a secret of secret_len bytes takes."""
    return HEADER_SLOTS + (secret_len + 16) * 8 * 7


def seal_stream(master_key: bytes, salt: bytes, secret: bytes) -> bytes:
    """header || ciphertext || tag of one image."""
    key, nonce = aead.derive_keys(master_key, salt)
    header = (MAGIC + bytes([2, 0]) + salt + nonce
              + struct.pack(">I", len(secret)))
    ct, tag = aead.seal(key, nonce, header, secret)
    return header + ct + tag


def frame_bits(stream: bytes) -> np.ndarray:
    """The Rep-3 / Rep-7 frame of a stream, u8 bits MSB first."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    return np.concatenate([np.repeat(bits[:HEADER_BYTES * 8], 3),
                           np.repeat(bits[HEADER_BYTES * 8:], 7)])


def _spectrum_at(planes: torch.Tensor, walk) -> torch.Tensor:
    """C at the walk bins, complex128 (n,), of float64 planes (3, H, W)."""
    p, y, x = walk
    return torch.fft.fft2(planes)[p, y, x].conj()


def embed(cover: torch.Tensor, bits: np.ndarray, walk, *, alpha: float,
          floor: float) -> torch.Tensor:
    """u8 stego (3, H, W) of a u8 cover (3, H, W), its frame bits and the
    walk (three int64 device tensors of the frame's length)."""
    planes = cover.to(torch.float64)
    H, W = planes.shape[-2:]
    c = _spectrum_at(planes, walk)
    s = torch.as_tensor(bits, device=planes.device).to(torch.float64) * 2 - 1
    mag = c.abs().clamp_min(1e-12)
    new = torch.complex(mag * math.cos(alpha), s * mag * math.sin(alpha))
    d = 2.0 * (new - c)
    if floor:
        # the smallest boost b in [1, 32] of the moved bins' magnitudes
        # (phases kept) that lifts the write's spatial RMS to `floor`
        sc = 1.0 / (H * W)
        h = 0.5 * sc * d
        cs = sc * c
        moved = (h.abs() > 0).to(torch.float64)
        V = (moved * cs.abs() ** 2).sum()
        X = (cs.real * h.real + cs.imag * h.imag).sum()
        Hs = (h.abs() ** 2).sum()
        p = V + 2.0 * X + Hs
        disc = torch.clamp_min((V + X) ** 2 - p * (V - 1.5 * floor ** 2), 0.0)
        b = torch.clamp((V + X + torch.sqrt(disc)) / torch.clamp_min(p, 1e-30),
                        1.0, 32.0)
        d = b * d + 2.0 * (b - 1.0) * moved * c
    g = torch.zeros((3, H, W), dtype=torch.complex128, device=planes.device)
    g[walk] = d.conj()
    out = planes + torch.fft.ifft2(g).real
    return torch.floor(out + 0.5).clamp_(0.0, 255.0).to(torch.uint8)


def decision_values(stego: torch.Tensor, walk, alpha: float) -> np.ndarray:
    """sign(sin alpha) Im C at the walk bins, float64 (n,)."""
    c = _spectrum_at(stego.to(torch.float64), walk)
    return (c.imag * (1.0 if math.sin(alpha) >= 0 else -1.0)).cpu().numpy()


def _vote(v: np.ndarray, n: int) -> bytes:
    """The majority of each group of n copies' hard decisions, packed."""
    g = v[:len(v) // n * n].reshape(-1, n)
    bits = (g >= 0).sum(1) >= (n + 1) // 2
    return np.packbits(bits.astype(np.uint8)).tobytes()


def read_decisive(d: np.ndarray, master_key: bytes) -> bytes | None:
    """The secret of a hard read whose header is beyond doubt: every Rep-3
    group of the header unanimous, and the payload's majority opening the
    AEAD; else None."""
    g = d[:HEADER_SLOTS].reshape(-1, 3) >= 0
    if not (g.all(1) | ~g.any(1)).all():
        return None
    header = _vote(d[:HEADER_SLOTS], 3)
    if header[:4] != MAGIC or header[4] != 2:
        return None
    salt, nonce = header[6:22], header[22:34]
    clen = struct.unpack(">I", header[34:38])[0]
    end = frame_slots(clen)
    if end > len(d):
        return None
    body = _vote(d[HEADER_SLOTS:end], 7)
    key, _ = aead.derive_keys(master_key, salt)
    return aead.open_(key, nonce, header, body[:clen], body[clen:clen + 16])
