"""The on-wire ECC frame that the batch and the single-image paths share.

header||ct||tag becomes Rep-3 over the 304 header bits (reference frame
layout, steganosaur.cpp:986-995), then Rep-7 over the payload bits, or with
Params.rs the bits of the payload's interleaved RS(255,223) coding.
"""

from __future__ import annotations

import numpy as np

from steganosaurus_tpu_torch.ops import rs as rs_mod
from steganosaurus_tpu_torch.pipeline import header as header_mod

HEADER_STREAM_BITS = header_mod.FIXED_LEN * 8 * 3  # 38*8 under Rep-3 = 912


def frame_bits(stream: bytes, rs: bool = False) -> np.ndarray:
    """header||ct||tag -> the on-wire u8 frame bits, MSB first."""
    hdr = header_mod.FIXED_LEN
    h = np.repeat(np.unpackbits(np.frombuffer(stream[:hdr], np.uint8)), 3)
    if rs:
        p = np.unpackbits(np.frombuffer(
            rs_mod.rs_encode_interleaved(stream[hdr:]), np.uint8))
    else:
        p = np.repeat(np.unpackbits(np.frombuffer(stream[hdr:], np.uint8)), 7)
    return np.concatenate([h, p])
