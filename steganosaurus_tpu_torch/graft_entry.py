"""The port's graft entry: the single-device forward step and the multichip
dry run, the twins of entry() and dryrun_multichip() in the repository's
__graft_entry__.py.

    python -m steganosaurus_tpu_torch.graft_entry

runs entry() on the card and prints its output's shape and dtype, then
dryrun_multichip() over the machine's cards (up to 8) and over 4 logical
shards of card 0. Every entry point runs on CUDA unless the caller passes
device="cpu"; none of them moves work to the CPU by itself.

The mesh is single-controller (parallel/batch.py): one process queues every
shard's work. Where the JAX dry run re-points JAX at a virtual CPU mesh when
the machine has fewer chips than asked for, this one takes that many logical
shards of card 0 (make_mesh(n, device="cuda:0")), the same arithmetic
without the interconnect.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from steganosaurus_tpu_torch import _build, runtime
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.parallel import fft_dist
from steganosaurus_tpu_torch.pipeline.batch import embed_batch, extract_batch


def entry(device=None):
    """(fn, example_args) for a single-device forward step: fn is the
    full-grid batched embed core (center off, alpha not adaptive), and
    fn(*example_args) is a (2, 128, 128, 3) u8 stego batch. The arguments
    are JAX's entry()'s draws from default_rng(0), on `device` (default the
    card), with the bits packed into (B, nbits/32) int32 words. The random
    bins name 37 bins more than once; each repeat carries its bin's last
    bit (last_write_bits), so the core's scatter writes one value there on
    every device, the one the CPU keeps in both packages."""
    dev = runtime.resolve_device(device)
    B, H, W, nbits = 2, 128, 128, 1024
    fn = functools.partial(pbatch.batched_embed_core, center=False,
                           adaptive=False)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    plane = rng.integers(0, 3, nbits).astype(np.int32)
    y = rng.integers(1, H // 2, nbits).astype(np.int32)
    x = rng.integers(1, W // 2, nbits).astype(np.int32)
    bits = rng.integers(0, 2, (B, nbits)).astype(np.uint8)
    jit = np.zeros(nbits, np.float32)
    words = bit_ops.pack_bits_words_host(
        last_write_bits(bits, (plane * H + y) * W + x))
    example_args = tuple(runtime.upload(a, dev)
                         for a in (imgs, plane, y, x, words, jit)) + (0.5,)
    return fn, example_args


def last_write_bits(bits: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """bits (B, n) with each slot given the bit of the last slot that names
    the same bin (flat (n,), one int per bin)."""
    _, inv = np.unique(flat, return_inverse=True)
    last = np.zeros(inv.max() + 1, np.int64)
    last[inv] = np.arange(flat.size)  # a repeated index keeps its last write
    return bits[:, last[inv]]


def batch_covers(rng, n_devices: int) -> np.ndarray:
    """The dry run's axis-1 covers, drawn from rng: (n, 128, 128, 3) u8, a
    horizontal ramp plus [-12, 12] noise."""
    B, H, W = n_devices, 128, 128  # 64x64 lacks capacity for the frame
    base = np.linspace(170, 225, W)
    return np.clip(
        base[None, None, :, None] + rng.integers(-12, 13, (B, H, W, 3)),
        0, 255,
    ).astype(np.uint8)


def image_inputs(rng, n_devices: int) -> tuple:
    """Axis 2's inputs, drawn from rng after batch_covers: (planes (3, PH,
    PW) f32 in [0, 255), PH = PW = max(64, 8n); 32 distinct bins plane, y,
    x int32 off the lowest frequencies; their bits u8 and zero jitters)."""
    PH = PW = max(64, 8 * n_devices)
    planes = rng.uniform(0, 255, (3, PH, PW)).astype(np.float32)
    nb = 32
    # distinct bins (a duplicate would scatter-conflict: last write wins)
    ylo, yhi = 4, PH // 2 - 1
    xlo, xhi = 4, PW // 2 - 1
    ncell = 3 * (yhi - ylo) * (xhi - xlo)
    cells = rng.choice(ncell, size=nb, replace=False)
    plane = (cells % 3).astype(np.int32)
    yy = (ylo + (cells // 3) % (yhi - ylo)).astype(np.int32)
    xx = (xlo + (cells // 3) // (yhi - ylo)).astype(np.int32)
    bits = rng.integers(0, 2, nb).astype(np.uint8)
    jit = np.zeros(nb, np.float32)
    return planes, plane, yy, xx, bits, jit


def _mesh(n_devices: int, device) -> pbatch.Mesh:
    """n_devices shards along "batch": the first n cards where the machine
    has that many and no device is given, else n logical shards of `device`
    (default card 0). Raises without a card unless device is the CPU."""
    if device is None and torch.cuda.is_available() \
            and torch.cuda.device_count() >= n_devices:
        return pbatch.make_mesh(n_devices)
    return pbatch.make_mesh(n_devices, device=device or "cuda:0")


def _check(ok: bool, msg) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the full pipeline over an n-device mesh on small shapes, with the
    inputs and checks of JAX's dryrun_multichip, in its order:

      1. data parallel: embed_batch -> extract_batch over the mesh (crypto,
         ECC framing, the shared walk, the sharded device cores,
         AEAD-verified recovery) at B = n 128x128 covers; 1b the same with
         per-image walks, alpha spread and QIM; 1c per-image walks, RS and
         QIM; every extract under default Params (the header names the
         modes); then the flat-scaling check, the sharded embed at most
         2x + 0.25 s the unsharded one (min of 3 steady steps, each ending
         in a host pull of the stego);
      2. the sharded single-image FFT (parallel/fft_dist.py) over n shards
         along "image": embed_core_distributed on 32 distinct bins, then
         read_core_distributed on the exact planes (every bit back) and on
         the u8-rounded planes (at most 2 of 32 flipped).

    The mesh is _mesh's. Any failure raises. Returns the scaling check's
    seconds and the u8 read's flips."""
    _build.ensure_native()  # the native walk expander and crypto
    mesh = _mesh(n_devices, device)
    dev = mesh.devices[0]

    # --- axis 1: the data-parallel batch pipeline, end to end ---------------
    rng = np.random.default_rng(7)
    imgs = batch_covers(rng, n_devices)
    secrets = [f"s{i}".encode() for i in range(n_devices)]
    p = Params(pbkdf2_iter=100)
    for params in (p,
                   Params(pbkdf2_iter=100, per_image_walk=True,
                          alpha_spread=0.5, qim=3),
                   Params(pbkdf2_iter=100, per_image_walk=True, rs=True,
                          qim=3)):
        res = embed_batch(imgs, secrets, password="pw", params=params,
                          mesh=mesh)
        got = extract_batch(res.stego, password="pw", params=p, mesh=mesh)
        _check(got == secrets, (params, got))

    # --- scaling: per-device work must be flat under sharding ---------------
    # Logical shards of one card (or the CPU) run one after another, so an
    # n-sharded batch should take about the unsharded same-batch time; a
    # replicated-compute bug shows as ~n x.
    def steady_step_time(mesh_) -> float:
        embed_batch(imgs, secrets, password="pw", params=p, mesh=mesh_,
                    device=dev)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = embed_batch(imgs, secrets, password="pw", params=p,
                            mesh=mesh_, device=dev)
            np.asarray(r.stego)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_sharded = steady_step_time(mesh)
    t_single = steady_step_time(None)
    _check(t_sharded <= 2.0 * t_single + 0.25,
           f"sharded step {t_sharded:.3f}s vs single-device {t_single:.3f}s: "
           f"per-device work is not flat; replicated compute or collective "
           f"blowup in the mesh path")

    # --- axis 2: one image's spectrum sharded (the distributed FFT) ---------
    smesh = pbatch.Mesh(mesh.devices, ("image",))
    planes, plane, yy, xx, bits, jit = image_inputs(rng, n_devices)
    out = np.asarray(fft_dist.embed_core_distributed(
        planes, plane, yy, xx, bits, jit, 0.5, smesh))
    _check(out.shape == planes.shape, out.shape)

    # ... and back through the distributed read, on the exact planes and on
    # the u8-quantized ones (floor(x + 0.5), clamped, as the pipeline rounds)
    got_exact = fft_dist.read_core_distributed(out, plane, yy, xx, jit, 0.5,
                                               smesh).cpu().numpy()
    _check(np.array_equal(got_exact, bits),
           "distributed embed->extract round trip lost bits "
           "pre-quantization")
    stego_u8 = np.clip(np.floor(out + 0.5), 0, 255).astype(np.float32)
    got_u8 = fft_dist.read_core_distributed(stego_u8, plane, yy, xx, jit,
                                            0.5, smesh).cpu().numpy()
    flips = int(np.sum(got_u8 != bits))
    _check(flips <= 2,  # raw u8 channel BER is ~0.2%; ECC absorbs this
           f"{flips}/{bits.size} bits flipped through u8 quantization: the "
           f"distributed read path is broken, not just channel noise")
    return {"t_sharded": t_sharded, "t_single": t_single, "flips": flips}


if __name__ == "__main__":
    fn, args = entry()
    r = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(r.shape), r.dtype)
    n = min(8, torch.cuda.device_count())
    print(f"dryrun_multichip({n}) ok:", dryrun_multichip(n))
    print("dryrun_multichip(4) on logical shards of cuda:0 ok:",
          dryrun_multichip(4, device="cuda:0"))
