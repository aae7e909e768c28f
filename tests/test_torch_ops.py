"""The torch port's host framing, bit packing, ECC, frame bits and static
maps against the JAX package (steganosaurus_tpu_torch vs steganosaurus_tpu).

Inputs are numpy arrays made from a seed and handed to both packages; every
comparison here is exact (integer and bit data)."""

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steganosaurus_tpu import crypto as jcrypto
from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.ops import ecc as jecc
from steganosaurus_tpu.parallel import batch as jpb
from steganosaurus_tpu.pipeline import batch as jbatch
from steganosaurus_tpu.pipeline import header as jheader
from steganosaurus_tpu_torch.ops import bits as tbits
from steganosaurus_tpu_torch.ops import ecc as tecc
from steganosaurus_tpu_torch.parallel import batch as tpb
from steganosaurus_tpu_torch.pipeline import batch as tbatch
from steganosaurus_tpu_torch.pipeline import header as theader
from steganosaurus_tpu_torch.spectral import corner as tcorner
from steganosaurus_tpu_torch import crypto as tcrypto
from steganosaurus_tpu_torch.config import Params


def jp(p: Params) -> JParams:
    """The JAX package's own Params with the fields of the port's p."""
    return JParams(**dataclasses.asdict(p))

torch.set_num_threads(2)

MK = bytes(range(32))


@pytest.mark.parametrize("name", ["MAGIC", "VERSION", "FIXED_LEN",
                                  "FLAG_PER_IMAGE_WALK", "FLAG_RS_PAYLOAD",
                                  "FLAG_PADDED", "FLAG_COHERENT",
                                  "QIM_SHIFT"])
def test_header_constants_match(name):
    assert getattr(theader, name) == getattr(jheader, name)


@pytest.mark.parametrize("flags,pad_quantum", [(0, 0), (0, 64),
                                               (jheader.FLAG_RS_PAYLOAD, 0)])
def test_seal_stream_bytes_match(flags, pad_quantum):
    """Same secret, key and salt -> the same header, ciphertext and tag."""
    rng = np.random.default_rng(1)
    secret = bytes(rng.integers(0, 256, 128, dtype=np.uint8))
    salt = bytes([9]) * 16
    outs = []
    for mod, crypto in ((jheader, jcrypto), (theader, tcrypto)):
        with crypto.derive_keys_vault(None, MK, salt=salt, iters=1) as km:
            outs.append(mod.seal_stream(secret, km, flags, pad_quantum))
    assert outs[0] == outs[1]
    hb = outs[1][0]
    assert len(hb) == theader.FIXED_LEN and hb[:4] == theader.MAGIC
    h = theader.Header.from_bytes(hb)
    assert h.to_bytes() == hb
    assert vars(h) == vars(jheader.Header.from_bytes(hb))


def test_maybe_unpad_and_padded_len_match():
    rng = np.random.default_rng(2)
    secret = bytes(rng.integers(0, 256, 50, dtype=np.uint8))
    with tcrypto.derive_keys_vault(None, MK, salt=bytes(16), iters=1) as km:
        pt = theader.pad_plaintext(secret, 64, km)
    with jcrypto.derive_keys_vault(None, MK, salt=bytes(16), iters=1) as km:
        assert pt == jheader.pad_plaintext(secret, 64, km)
    assert len(pt) == theader.padded_len(50, 64) == jheader.padded_len(50, 64)
    for flags in (0, theader.FLAG_PADDED):
        assert (theader.maybe_unpad(pt, flags)
                == jheader.maybe_unpad(pt, flags))
    assert theader.maybe_unpad(pt, theader.FLAG_PADDED) == secret


@pytest.mark.parametrize("n", [3, 7])
def test_rep_codes_match(n):
    """Encode, hard decode (partial trailing group dropped) and soft decode
    (sum >= 0 -> 1, ties included) against ops/ecc.py."""
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, 301).astype(np.uint8)
    enc = tecc.rep_encode(torch.from_numpy(bits), n).numpy()
    np.testing.assert_array_equal(enc, np.asarray(jecc.rep_encode(bits, n)))
    noisy = rng.integers(0, 2, 4 * 301 + n - 1).astype(np.uint8)
    np.testing.assert_array_equal(
        tecc.rep_decode(torch.from_numpy(noisy), n).numpy(),
        np.asarray(jecc.rep_decode(noisy, n)))
    vals = rng.integers(-3, 4, 2 * 301 + 1).astype(np.float32)
    np.testing.assert_array_equal(
        tecc.rep_decode_soft(torch.from_numpy(vals), n).numpy(),
        np.asarray(jecc.rep_decode_soft(vals, n)))
    # batched along the last axis == row by row
    rows = rng.integers(0, 2, (4, 7 * n + 2)).astype(np.uint8)
    got = tecc.rep_decode(torch.from_numpy(rows), n).numpy()
    for r, g in zip(rows, got):
        np.testing.assert_array_equal(g, np.asarray(jecc.rep_decode(r, n)))


def test_word_packing_matches():
    """Host and device MSB-first big-endian i32 word packing against
    parallel/batch.py (pack_bytes_words_host, _unpack_bits_words,
    _pack_bits_words; pack_bits_words_host's words unpack to its bits)."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 256)).astype(np.uint8)
    w = jpb.pack_bits_words_host(bits)
    rows = [bytes(rng.integers(0, 256, 42, dtype=np.uint8)) for _ in range(3)]
    wb = tbits.pack_bytes_words_host(rows)
    np.testing.assert_array_equal(wb, jpb.pack_bytes_words_host(rows))
    got = tbits.unpack_bits_words(torch.from_numpy(w), 256).numpy()
    np.testing.assert_array_equal(got, bits)
    for r in range(3):
        np.testing.assert_array_equal(
            got[r], np.asarray(jpb._unpack_bits_words(jnp.asarray(w[r]),
                                                      256)))
    odd = rng.integers(0, 2, (3, 77)).astype(np.uint8)
    tw = tbits.pack_bits_words(torch.from_numpy(odd)).numpy()
    for r in range(3):
        np.testing.assert_array_equal(
            tw[r], np.asarray(jpb._pack_bits_words(jnp.asarray(odd[r]))))
    # the host-facing byte order: words.view(u32).astype('>u4') is the stream
    assert (wb[0].view(np.uint32).astype(">u4").tobytes()[:42] == rows[0])


@pytest.mark.parametrize("stream_bytes,bucket", [(38 + 144, 4096 * 3),
                                                 (38 + 16 + 5, 4096)])
def test_frame_bits_match(stream_bytes, bucket):
    """Rep-3 header + Rep-7 payload frame, tail-padded with the last bit,
    against parallel/batch.py _frame_from_words."""
    rng = np.random.default_rng(stream_bytes)
    rows = [bytes(rng.integers(0, 256, stream_bytes, dtype=np.uint8))
            for _ in range(4)]
    words = tbits.pack_bytes_words_host(rows)
    got = tpb._frame_from_words(torch.from_numpy(words), stream_bytes,
                                bucket).numpy()
    want = np.asarray(jpb._frame_from_words(jnp.asarray(words),
                                            stream_bytes, bucket))
    assert got.shape == (4, bucket)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("soft", [False, True])
def test_decode_sections_match(soft):
    """Device section decode (Rep-3 header words | Rep-7 payload words)
    against parallel/batch.py _decode_sections / _decode_sections_soft."""
    rng = np.random.default_rng(5 + soft)
    hdr, n = 912, 912 + 7 * 200 + 3
    if soft:
        x = rng.normal(size=(3, n)).astype(np.float32)
        got = tpb._decode_sections_soft(torch.from_numpy(x), hdr).numpy()
        ref = jpb._decode_sections_soft
    else:
        x = rng.integers(0, 2, (3, n)).astype(np.uint8)
        got = tpb._decode_sections(torch.from_numpy(x), hdr).numpy()
        ref = jpb._decode_sections
    for r in range(3):
        np.testing.assert_array_equal(got[r],
                                      np.asarray(ref(jnp.asarray(x[r]), hdr,
                                                     7)))


def test_statics_from_numpy_matches_own_pos_map():
    """JAX's _corner_statics_device maps, pulled to numpy and carried over
    by statics_from_numpy, equal the port's own pos map."""
    PH, PW = 384, 640
    params = Params()
    Ky, Kx = tcorner.corner_dims(PH, PW, params.rmax)
    nbits = 912 + (128 + 16) * 56
    bucket = -(-nbits // 4096) * 4096
    jmaps, jn = jbatch._corner_statics_device(None, MK, jp(params), PH, PW, nbits,
                                              bucket, Ky, Kx, None)
    (pos_j,) = tpb.statics_from_numpy([np.asarray(m) for m in jmaps], "cpu")
    (pos,), n = tbatch._corner_statics_device(None, MK, params, PH, PW, nbits,
                                              bucket, Ky, Kx,
                                              torch.device("cpu"))
    assert n == jn
    assert pos_j.dtype == pos.dtype and pos_j.shape == (3, Ky, Kx)
    torch.testing.assert_close(pos_j, pos, rtol=0, atol=0)
    # each real walk slot owns one bin (the tail-pad duplicates of the last
    # slot share its bin), every other bin reads `bucket`
    slots = pos[pos < bucket]
    assert len(torch.unique(slots)) == nbits


def test_jitter_statics_match_jax():
    """With Params.jitter != 0 the static maps are (pos, cjd, sjd), equal
    to the JAX package's: pos exactly, the cos/sin maps to f32 rounding."""
    PH, PW = 384, 640
    params = Params(jitter=0.2)
    Ky, Kx = tcorner.corner_dims(PH, PW, params.rmax)
    nbits = 912 + (64 + 16) * 56
    bucket = -(-nbits // 4096) * 4096
    jmaps, jn = jbatch._corner_statics_device(None, MK, jp(params), PH, PW, nbits,
                                              bucket, Ky, Kx, None)
    maps, n = tbatch._corner_statics_device(None, MK, params, PH, PW, nbits,
                                            bucket, Ky, Kx,
                                            torch.device("cpu"))
    assert n == jn and len(maps) == len(jmaps) == 3
    want = tpb.statics_from_numpy([np.asarray(m) for m in jmaps], "cpu")
    torch.testing.assert_close(maps[0], want[0], rtol=0, atol=0)
    for got, ref in zip(maps[1:], want[1:]):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    assert (maps[2] != 0).any()  # the sine map carries the walk's jitter


def test_host_bit_words_round_trip():
    """pack_bits_words_host / unpack_words_host against the JAX package's
    pack_bits_words_host and unpack_words_host, and the device unpack."""
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (3, 4096)).astype(np.uint8)
    words = tbits.pack_bits_words_host(bits)
    np.testing.assert_array_equal(words, jpb.pack_bits_words_host(bits))
    np.testing.assert_array_equal(tbits.unpack_words_host(words, 4096), bits)
    np.testing.assert_array_equal(
        jpb.unpack_words_host(words, 4000), bits[:, :4000])
    np.testing.assert_array_equal(
        tbits.unpack_bits_words(torch.from_numpy(words), 4096).numpy(), bits)
    odd = bits[:, :100]   # a partial last word is zero-padded
    np.testing.assert_array_equal(
        tbits.unpack_words_host(tbits.pack_bits_words_host(odd), 100), odd)
