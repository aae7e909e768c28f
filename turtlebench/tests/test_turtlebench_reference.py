"""The plain reference against the program at small sizes on the CPU: the
same walk, the same AEAD and frames, stegos that differ only by rounding,
and each side reads the other's stego."""

import hashlib
import os

import numpy as np
import pytest
import torch

from turtlebench.reference import aead, stego, walk

KEY = hashlib.sha256(b"turtlebench reference test").digest()


@pytest.mark.parametrize("H,W,n", [(128, 256, 3000), (255, 383, 20000),
                                   (256, 509, 9000)])
def test_walk_equals_the_programs(H, W, n):
    from steganosaurus_tpu_torch import _build, crypto, keystream

    _build.ensure_native()
    pk = crypto.derive_path_key(None, KEY)
    kw, kr, kg, kb = crypto.derive_turtle_keys(pk)
    assert walk.walk_key(KEY) == kw
    p, y, x, _ = keystream.turtle_expand(kw, (kr, kg, kb), H, W, 0.05, 0.45,
                                         0.7, 0.0, n)
    got = walk.expand(kw, H, W, 0.05, 0.45, 0.7, n)
    for a, b in zip((p, y, x), got):
        np.testing.assert_array_equal(a, b)


def test_walk_cache_round_trip(tmp_path):
    k = walk.walk_key(KEY)
    a = walk.cached_walk(tmp_path, k, 128, 256, 0.05, 0.45, 0.7, 2000)
    b = walk.cached_walk(tmp_path, k, 128, 256, 0.05, 0.45, 0.7, 2000)
    assert len(list(tmp_path.glob("walk_*.npy"))) == 1
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 16384])
def test_aead_equals_the_programs(n):
    from steganosaurus_tpu_torch.crypto import _pure

    rng = np.random.default_rng(n)
    key, nonce = rng.bytes(32), rng.bytes(12)
    aad, pt = rng.bytes(38), rng.bytes(n)
    ct, tag = aead.seal(key, nonce, aad, pt)
    assert (ct, tag) == _pure.aead_seal(key, nonce, aad, pt)
    assert aead.open_(key, nonce, aad, ct, tag) == pt
    assert aead.open_(key, nonce, aad + b"x", ct, tag) is None


def test_stream_and_frame_equal_the_programs():
    from steganosaurus_tpu_torch import crypto
    from steganosaurus_tpu_torch.pipeline import frame, header

    salt, secret = bytes(range(16)), b"s" * 100
    km = crypto.derive_keys_from_raw(KEY, salt)
    assert aead.derive_keys(KEY, salt) == (km.aead_key, km.nonce)
    hb, ct, tag = header.seal_stream(secret, km, 0, 0)
    assert stego.seal_stream(KEY, salt, secret) == hb + ct + tag
    np.testing.assert_array_equal(stego.frame_bits(hb + ct + tag),
                                  frame.frame_bits(hb + ct + tag))


@pytest.fixture(scope="module")
def pair():
    """A CPU batch of the program's stegos and the reference's, 256x512."""
    import steganosaurus_tpu_torch as stt

    rng = np.random.default_rng(5)
    B, H, W, n = 2, 256, 512, 150
    base = np.floor(np.linspace(150, 235, W)).astype(np.int16)
    covers = np.clip(base + rng.integers(-18, 19, (B, 3, H, W)), 0,
                     255).astype(np.uint8)
    secrets = [rng.bytes(n) for _ in range(B)]
    salts = [rng.bytes(16) for _ in range(B)]
    os.environ.setdefault("STEGANOSAURUS_MM_PRECISION", "mix_adaptive")
    res = stt.embed_batch(torch.from_numpy(covers), secrets, master_key=KEY,
                          salts=salts, layout="nchw", device_resident=True)
    w = tuple(torch.from_numpy(a).long() for a in walk.expand(
        walk.walk_key(KEY), H, W, 0.05, 0.45, 0.7, stego.frame_slots(n)))
    refs = [stego.embed(torch.from_numpy(covers[i]), stego.frame_bits(
        stego.seal_stream(KEY, salts[i], secrets[i])), w, alpha=0.5,
        floor=0.45) for i in range(B)]
    return covers, secrets, res.stego, torch.stack(refs), w, salts


def test_stegos_differ_by_rounding_alone(pair):
    _, _, prog, ref, _, _ = pair
    d = prog.to(torch.int16) - ref.to(torch.int16)
    assert int(d.abs().max()) <= 1
    assert float((d != 0).float().mean()) < 0.02


def test_each_side_reads_the_others_stego(pair):
    import steganosaurus_tpu_torch as stt

    _, secrets, prog, ref, w, salts = pair
    for i, s in enumerate(secrets):
        # at this size the hard read loses a few Rep-7 groups, so the
        # reference's reading is its raw decisions against the frame
        bits = stego.frame_bits(stego.seal_stream(KEY, salts[i], s))
        d = stego.decision_values(prog[i], w, 0.5)
        assert float(((d >= 0) != bits.astype(bool)).mean()) < 0.05
    assert stt.extract_batch(ref, master_key=KEY, layout="nchw") == secrets


def test_both_reads_of_a_stego_err_alike(pair):
    """The raw decisions read_gap compares: the program's channel_report and
    the reference's float64 read of the same stegos count the same raw
    bit errors, to a few."""
    import steganosaurus_tpu_torch as stt

    _, secrets, prog, _, w, salts = pair
    rep = stt.channel_report(prog, secrets, salts, master_key=KEY,
                             layout="nchw", per_image=True)
    n = stego.frame_slots(len(secrets[0]))
    for i, r in enumerate(rep["per_image"]):
        bits = stego.frame_bits(stego.seal_stream(KEY, salts[i], secrets[i]))
        d = stego.decision_values(prog[i], w, 0.5)
        ref_err = int(((d >= 0) != bits.astype(bool)).sum())
        prog_err = round(r["header_ber_raw"] * stego.HEADER_SLOTS
                         + r["payload_ber_raw"] * (n - stego.HEADER_SLOTS))
        assert abs(prog_err - ref_err) <= max(2, ref_err // 50), (
            prog_err, ref_err)
