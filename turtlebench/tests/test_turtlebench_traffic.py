"""The seeded traffic: the same seed sends the same covers, secrets and
salts and samples the same images; another seed sends others."""

import json
import pathlib

import numpy as np
import torch

from turtlebench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
BIG = 2**31 + 12345


def small_cell(name="uhd4k_16k.stream_w3839"):
    cell = harness.load_cell(BENCH, REPO, name)
    cell.config = dict(cell.config, height=64, width=96, batch=3)
    return cell


def test_covers_are_one_pool_ordered_by_the_seed():
    cell = small_cell()
    a = harness.make_covers(cell, BIG, "cpu")
    b = harness.make_covers(cell, BIG, "cpu")
    c = harness.make_covers(cell, BIG + 1, "cpu")
    assert a.shape == (3, 3, 64, 95) and a.dtype == torch.uint8
    assert a.is_contiguous()
    assert torch.equal(a, b)
    # the same covers, in another order
    key = sorted(bytes(x.flatten().tolist()) for x in a)
    assert key == sorted(bytes(x.flatten().tolist()) for x in c)
    assert len(set(key)) == 3
    # the gradient 150..235 plus noise in [-18, 18]
    base = torch.floor(torch.linspace(150, 235, 96, dtype=torch.float64))
    d = a.to(torch.int16) - base[:95].to(torch.int16)
    assert int(d.min()) >= -18 and int(d.max()) <= 18
    orders = {tuple(bytes(x[0, 0, :4].tolist()) for x in
                    harness.make_covers(cell, BIG + j, "cpu"))
              for j in range(6)}
    assert len(orders) > 1


def test_secrets_and_salts_are_a_function_of_seed_and_batch():
    f, g = harness.Feed(BIG, 4, 100), harness.Feed(BIG, 4, 100)
    assert f.batch(7) == g.batch(7)
    s, t = f.batch(7)
    assert len(s) == 4 and all(len(x) == 100 for x in s)
    assert len(t) == 4 and all(len(x) == 16 for x in t)
    assert len(set(s)) == 4 and len(set(t)) == 4
    assert f.batch(8) != f.batch(7)
    assert harness.Feed(BIG + 1, 4, 100).batch(7) != f.batch(7)


def test_the_sample_is_drawn_from_the_seed():
    def draw(seed, size=3, B=4):
        smp = harness.Sample(seed, size)
        for k in range(20):
            stego = torch.full((B, 1), k)
            smp.offer(stego, torch.arange(B), [bytes([k, i]) for i in
                                                range(B)], [b"s" * 16] * B)
        return [(int(c), s) for c, s, _, _ in smp.drawn()]

    assert draw(BIG) == draw(BIG)
    assert len(draw(BIG)) == 3
    picks = {tuple(draw(BIG + j)) for j in range(6)}
    assert len(picks) > 1
    ks = {s[0] for seed in range(8) for _, s in draw(seed)}
    assert max(ks) > 10   # late batches get drawn too


def test_the_sample_draws_every_class_of_slot():
    """One image for each slot modulo the sample's size, from any batch: a
    fault confined to some slots of a batch is always drawn."""
    for seed in range(5):
        smp = harness.Sample(BIG + seed, 16)
        for k in range(30):
            smp.offer(torch.zeros(64, 1), torch.arange(64),
                      [bytes([k, i]) for i in range(64)], [b"s" * 16] * 64)
        slots = [s[1] for _, s, _, _ in smp.drawn()]
        assert sorted(x % 16 for x in slots) == list(range(16))
        assert len({s[0] for _, s, _, _ in smp.drawn()}) > 1


def test_the_key_is_one_per_configuration():
    a = harness.load_cell(BENCH, REPO, "uhd4k_16k.stream")
    b = harness.load_cell(BENCH, REPO, "uhd4k_16k.stream_w3839")
    c = harness.load_cell(BENCH, REPO, "uhd4k_16k.stream")
    c.config = dict(c.config, name="another_config")
    ka, kb, kc = (harness.service_key(x) for x in (a, b, c))
    assert ka == kb != kc and len(ka) == 32
    assert np.frombuffer(ka, np.uint8).std() > 0
