"""The port's graft entry (steganosaurus_tpu_torch/graft_entry.py) against
the repository's __graft_entry__.py, on the CPU.

- entry(device="cpu"): the same draws as JAX's entry() (the bits packed
  into words), and its forward step's u8 stego within +-1 of JAX's on at
  most ENTRY_DIFF_FRAC of the bytes (f32 FFTs that sum in other orders put
  a few pixels on the other side of .5), counted;
- each bin the step's random walk names twice carries its last bit;
- dryrun_multichip(4, device="cpu") on 4 logical CPU shards: every assert
  of the dry run holds;
- axis 2 of the dry run (the sharded single-image FFT) on its own inputs,
  the port on logical CPU shards against JAX's fft_dist under jax.jit on
  tests/conftest.py's virtual CPU devices: planes within DIST_PLANES_ATOL
  (0-255 units), the read bits equal;
- without a card the entry points raise rather than run on the CPU.

JAX's own dryrun_multichip is not called here: it clears JAX's backends,
which other tests in the same worker process share.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as jentry
from steganosaurus_tpu.parallel import fft_dist as jfd
from steganosaurus_tpu_torch import graft_entry
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.parallel import fft_dist as tfd

torch.set_num_threads(2)

ENTRY_DIFF_FRAC = 5e-3
# sharded embed, port against JAX: real planes of 0-255 values after two
# f32 round trips through FFTs summing in other orders
DIST_PLANES_ATOL = 2e-3


def test_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    imgs, plane, y, x, words, jit, alpha = args
    for got, want in zip((imgs, plane, y, x, jit), jargs[:4] + (jargs[5],)):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = (jargs[1] * 128 + jargs[2]) * 128 + jargs[3]
    np.testing.assert_array_equal(
        bit_ops.unpack_words_host(words.numpy(), jargs[4].shape[1]),
        graft_entry.last_write_bits(jargs[4], flat))
    assert alpha == float(jargs[6])
    out = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert out.dtype == torch.uint8 and tuple(out.shape) == want.shape
    diff = out.numpy().astype(np.int16) - want.astype(np.int16)
    n = int(np.count_nonzero(diff))
    print(f"entry: {n} of {diff.size} bytes differ from JAX's")
    assert np.abs(diff).max() <= 1
    assert n <= ENTRY_DIFF_FRAC * diff.size, n
    # the step writes: the stego is not the cover
    assert not torch.equal(out, imgs)


def test_entry_bins_named_twice_take_the_last_write():
    """entry()'s random bins name 37 bins more than once. Each repeat
    carries its bin's last bit (and only repeats change), so the core
    writes one value there on every device; on the CPU, which keeps a
    bin's last write, the step equals the step with the raw draws."""
    fn, (imgs, plane, y, x, words, jit, alpha) = graft_entry.entry(
        device="cpu")
    raw = jentry.entry()[1][4]
    flat = ((plane.long() * 128 + y) * 128 + x).numpy()
    uniq, inv, count = np.unique(flat, return_inverse=True,
                                 return_counts=True)
    assert np.count_nonzero(count > 1) == 37
    bits = bit_ops.unpack_words_host(words.numpy(), flat.size)
    for k in range(uniq.size):
        slots = np.flatnonzero(inv == k)
        assert (bits[:, slots] == raw[:, slots[-1:]]).all()
    assert (bits != raw).any()
    assert torch.equal(fn(imgs, plane, y, x, words, jit, alpha),
                       fn(imgs, plane, y, x, torch.from_numpy(
                           bit_ops.pack_bits_words_host(raw)), jit, alpha))


def test_dryrun_multichip_on_cpu_shards():
    report = graft_entry.dryrun_multichip(4, device="cpu")
    assert report["flips"] <= 2
    assert report["t_sharded"] <= 2.0 * report["t_single"] + 0.25


def _jx(fn, jmesh, **static):
    return jax.jit(functools.partial(fn, mesh=jmesh, **static))


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_axis2_matches_jax(n):
    """The dry run's axis 2 at n shards: the port's sharded embed against
    JAX's on the same planes and bins, and both packages' sharded reads of
    the exact and the u8-rounded planes."""
    if len(jax.devices()) < n:
        pytest.fail("tests/conftest.py forces 8 virtual CPU devices")
    rng = np.random.default_rng(7)
    graft_entry.batch_covers(rng, n)
    planes, plane, y, x, bits, jit = graft_entry.image_inputs(rng, n)
    mesh = pbatch.make_mesh(n, axis="image", device="cpu")
    jmesh = JMesh(np.asarray(jax.devices()[:n]), ("image",))
    rows = NamedSharding(jmesh, P(None, "image", None))

    out = np.asarray(tfd.embed_core_distributed(planes, plane, y, x, bits,
                                                jit, 0.5, mesh))
    jout = np.asarray(_jx(jfd.embed_core_distributed, jmesh)(
        jax.device_put(planes, rows), plane, y, x, jnp.asarray(bits), jit,
        jnp.float32(0.5)))
    assert out.shape == jout.shape == planes.shape
    np.testing.assert_allclose(out, jout, rtol=0, atol=DIST_PLANES_ATOL)

    jread = _jx(jfd.read_core_distributed, jmesh)
    stego_u8 = np.clip(np.floor(out + 0.5), 0, 255).astype(np.float32)
    for stego, exact in ((out, True), (jout, True), (stego_u8, False)):
        got = tfd.read_core_distributed(stego, plane, y, x, jit, 0.5,
                                        mesh).numpy()
        jgot = np.asarray(jread(jax.device_put(stego, rows), plane, y, x,
                                jit, jnp.float32(0.5)))
        np.testing.assert_array_equal(got, jgot)
        if exact:
            np.testing.assert_array_equal(got, bits)
        else:
            assert int(np.sum(got != bits)) <= 2


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """With no card, entry() and dryrun_multichip() raise (no branch moves
    the work to the CPU); device="cpu" alone takes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
    mesh = graft_entry._mesh(4, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
