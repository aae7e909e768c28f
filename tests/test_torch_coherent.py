"""The nine coherent compositions of tests/test_coherent.py, the port
against the JAX package, on the CPU, at fixed salts.

tests/test_coherent.py::test_coherent_roundtrip_compositions embeds under a
fresh random salt each run. Here both packages take the same salts,
default_rng(1000 + s).bytes(16), on that test's covers (a 256x256 u8 noise
cover drawn from a seed of the composition's keys), its 18-byte secret and
pbkdf2_iter=100, and each composition's stegos cross-decode both ways at
s = 0, 1, 2: port embed -> JAX extract and JAX embed -> port extract, every
extract under default Params (the header names the modes).

Under jitter=0.25 each package's f32 embed misses at a few of 2000 such
salts (s = 0..1999), and not at the same ones: JAX's at 7 (0.35%), the
port's at 8 (0.40%), F32_MISSES below; at every other salt of the 2000 each
package's own round trip reads back. At each of these 15 the other
package's f32 stego reads under both readers, the missing stego fails under
both readers with the same error, and the f64 arbiter
(fft_dtype="complex128") reads in both packages except at F64_MISSES (one
salt of each set), where both packages' f64 stegos fail under both readers.
So each f32 build falls short of the arbiter at ~0.4% of salts, on salts of
its own: last-bit differences decide which. These facts are pinned as
found.
"""

import dataclasses

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline.embed import embed_array as jembed
from steganosaurus_tpu.pipeline.errors import StegoError as JStegoError
from steganosaurus_tpu.pipeline.extract import extract_array as jextract
import steganosaurus_tpu_torch as stt
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.pipeline.errors import StegoError

torch.set_num_threads(2)

# tests/test_coherent.py's compositions, in its order
EXTRAS = [
    dict(),
    dict(soft_write=True),
    dict(qim=8),
    dict(rs=True),
    dict(qim=8, rs=True, pad_quantum=32),
    dict(write_floor=0.45),
    dict(alpha_spread=0.5),
    dict(jitter=0.25),
    dict(per_image_walk=True),
]
SECRET = b"coherent roundtrip"
SALTS = (0, 1, 2)
# salt index -> the package whose f32 stego misses (of s = 0..1999)
F32_MISSES = {**dict.fromkeys((85, 816, 818, 1214, 1365, 1539, 1765), "jax"),
              **dict.fromkeys((72, 271, 565, 743, 897, 1259, 1432, 1668),
                              "port")}
F64_MISSES = (72, 818)
JITTER = dict(jitter=0.25)


def _salt(s: int) -> bytes:
    return np.random.default_rng(1000 + s).bytes(16)


def _cover(extra: dict) -> np.ndarray:
    """tests/test_coherent.py's cover for the composition `extra`."""
    rng = np.random.default_rng(sum(map(ord, repr(sorted(extra)))))
    return rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)


def _params(extra: dict, **kw) -> Params:
    return Params(pbkdf2_iter=100, coherent=True, **extra, **kw)


def _stegos(extra: dict, s: int, **kw):
    """(port stego, JAX stego) of the composition at salt s."""
    p = _params(extra, **kw)
    cover = _cover(extra)
    t = stt.embed_array(cover, SECRET, password="pw", params=p,
                        salt=_salt(s), device="cpu")
    j = jembed(cover, SECRET, password="pw",
               params=JParams(**dataclasses.asdict(p)), salt=_salt(s))
    assert t.written_bits == j.written_bits
    return t.stego, np.asarray(j.stego)


def _reads(stego) -> tuple:
    """(port reader's result, JAX reader's result): the secret, or the
    StegoError's message."""
    out = []
    for read, err in ((lambda: stt.extract_array(
            stego, password="pw", params=Params(pbkdf2_iter=100),
            device="cpu"), StegoError),
            (lambda: jextract(stego, password="pw",
                              params=JParams(pbkdf2_iter=100)),
             JStegoError)):
        try:
            out.append(read())
        except err as e:
            out.append(f"StegoError: {e}")
    return tuple(out)


@pytest.mark.parametrize("s", SALTS)
@pytest.mark.parametrize("extra", EXTRAS, ids=lambda e: repr(e))
def test_coherent_compositions_cross_decode(extra, s):
    ts, js = _stegos(extra, s)
    assert _reads(ts) == (SECRET, SECRET)
    assert _reads(js) == (SECRET, SECRET)


@pytest.mark.parametrize("s", sorted(F32_MISSES))
def test_jitter_salts_where_an_f32_embed_misses(s):
    ts, js = _stegos(JITTER, s)
    missed, read = (js, ts) if F32_MISSES[s] == "jax" else (ts, js)
    assert _reads(read) == (SECRET, SECRET)
    port, jax_ = _reads(missed)
    assert port == jax_ and isinstance(port, str), (port, jax_)
    for stego in _stegos(JITTER, s, fft_dtype="complex128"):
        port, jax_ = _reads(stego)
        if s in F64_MISSES:
            assert port == jax_ and isinstance(port, str), (port, jax_)
        else:
            assert (port, jax_) == (SECRET, SECRET)
