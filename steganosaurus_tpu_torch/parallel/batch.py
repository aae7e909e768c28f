"""Batch device cores of the corner fast path, and the batch axis over a
mesh of devices.

The port's twin of the corner half of steganosaurus_tpu/parallel/batch.py.
JAX builds each core as a cached jitted factory; here each is a plain
function that PyTorch runs eagerly on the device of its inputs, with the
static configuration passed as keyword arguments. Every core carries every
corner wire mode the JAX batch cores carry: the hard or soft write, the
jittered write and read, per-bin amplitudes (Params.alpha_spread), QIM on
the payload slots (Params.qim), and the Rep-7 or RS (raw coded bits)
payload section.

- corner_statics_core: the static maps of a shared walk: the slot map
  `pos`, and the cos/sin jitter maps, the cos/sin amplitude maps and the
  QIM dither and payload-slot maps when the Params ask for them.
- _frame_from_words: stream words -> Rep-3/Rep-7 ECC frame bits (the
  equal-length Rep-7 path; other frames are built on the host).
- corner_embed_core: forward corner DFT -> dense write (hard or soft,
  QIM on payload bins) -> write floor -> inverse corner DFT -> u8 stego.
- corner_piw_embed_core: the same for per-image walks: each image gathers
  its own bins, computes its write values and scatters them into a zero
  corner.
- corner_extract_fused_core: forward corner DFT -> decision values at the
  walk bins -> Rep-3 header + payload words, hard and (optionally) soft.
  A shared walk is (n,) index tensors, per-image walks (B, n): the one
  core is the twin of JAX's corner_extract_fused_core and
  corner_piw_extract_core. A shared walk without QIM reads and decodes in
  one kernel (K5, spectral/read_kernels.py read_decode); QIM and
  per-image walks take the eager chain (_walk_decisions), as do the
  retry and raw-bits cores below.
- corner_soft_extract_core: the soft-decision retry pass (f32 decision
  values, matched-filter combining; RS confidences), either walk.
- corner_raw_bits_core: the raw (pre-ECC) bits at the walk bins, for the
  channel report.

The full-grid cores (JAX batched_analyze_core, batched_embed_core,
batched_gather_decode_core) carry Params.adaptive_alpha, whose write angle
scales with |F| over the whole spectrum's median: a full-grid FFT per image
(torch.fft), the per-bin write of ops/phase.py scattered into it, and the
inverse FFT. batched_read_core is the full-grid read in one call (analyze,
gather, the phase rule). The JAX package's batched_gather_bits_core has no
caller outside its tests and is not ported.

The batch axis over several devices (JAX's "batch" mesh axis): a Mesh is an
ordered tuple of devices, make_mesh builds one over the CUDA cards or as
logical shards of one device, and shard_batch splits a batch along axis 0
into a Sharded, one tensor per mesh device. One process drives every
device, as JAX's single-controller mesh does: the pipeline runs each
shard's rows through the single-device cores on that shard's device, with
that card current (card, on_shards), and
the full-grid cores here take a Sharded batch and return one. The images
are independent, so the batch axis needs no collective.

The JAX single-chip cores pack 32 images per i32 word before every bit
gather because TPU gathers pay a full HBM granule per row
(steganosaurus_tpu/parallel/batch.py:465-473); the port gathers per image
directly and has no batch packing. The JAX shared-walk reads gather from
dense jitter, dither and payload-mask maps; the port takes each walk slot's
own jitter angle, dither and slot index (slot >= 912 is a payload slot),
which are the values those maps hold at the walk's bins.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from steganosaurus_tpu_torch import runtime, spectral
from steganosaurus_tpu_torch.ops import bits as bit_ops
from steganosaurus_tpu_torch.ops import ecc
from steganosaurus_tpu_torch.ops import phase as phase_ops
from steganosaurus_tpu_torch.spectral import (corner, read_kernels,
                                                write_kernels)

HEADER_BITS = 304    # 38 header bytes
HEADER_REP = 3
PAYLOAD_REP = 7
HEADER_SLOTS = HEADER_BITS * HEADER_REP   # 912: QIM starts at this slot


# --- the mesh ----------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: an ordered tuple of torch devices along one named
    axis. A device may repeat (logical shards of one card). Hashable, so
    caches may key on it."""
    devices: tuple
    axis_names: tuple = ("batch",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return {self.axis_names[0]: self.size}


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device=None) -> Mesh:
    """A Mesh along `axis`. Without `device`: the first n_devices CUDA
    cards (all of them by default); raises when there is no card or too
    few, and never falls back to the CPU. With `device`: n_devices logical
    shards (default 1) on that one device, the counterpart of XLA's
    --xla_force_host_platform_device_count."""
    if device is not None:
        dev = runtime.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return Mesh((dev,) * n, (axis,))
    runtime.require_cuda()
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"asked for a mesh of {n} CUDA devices; this "
                         f"machine has {count}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), (axis,))


def card(dev):
    """The context of one shard's work: on a CUDA card, that card current,
    so every op and library plan (cuFFT's included) is made for it and
    queued on its current stream, whatever card the caller has current.
    Queued with card 0 current, per-shard FFTs gave stale spectra now and
    then on a four-card H100 host (tools/mesh_cards_torch.py). Whatever
    dispatches shard work runs each shard under it: on_shards, Sharded.map
    and the pipeline's shard loops. Copies between cards need nothing more:
    PyTorch orders a copy against both cards' current streams."""
    dev = torch.device(dev)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def on_shards(devices, fn) -> list:
    """[fn(k) for each shard k], each call made with devices[k] current
    (card): fn queues shard k's work; nothing here waits for a device."""
    out = []
    for k, d in enumerate(devices):
        with card(d):
            out.append(fn(k))
    return out


class Sharded:
    """A tensor split along one axis over a Mesh (axis 0, the batch, unless
    said otherwise): `parts[k]` holds indices [offsets[k], offsets[k] +
    parts[k].shape[axis]) of that axis on mesh.devices[k]. np.asarray(s)
    gathers it to the host, as it does a JAX sharded array."""

    def __init__(self, parts, mesh: Mesh, axis: int = 0):
        self.parts = tuple(parts)
        self.mesh = mesh
        self.axis = axis
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of "
                             f"{mesh.size}")
        self.offsets = tuple(int(o) for o in np.cumsum(
            [0] + [p.shape[axis] for p in self.parts[:-1]]))

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    def __array__(self, dtype=None, copy=None):
        a = np.concatenate([p.cpu().numpy() for p in self.parts],
                           axis=self.axis)
        return a if dtype is None else a.astype(dtype)

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on `device`."""
        return torch.cat([p.to(device, non_blocking=True)
                          for p in self.parts], dim=self.axis)

    def locate(self, i: int) -> tuple[int, int]:
        """(shard, index within it) of index i along the split axis."""
        k = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return k, i - self.offsets[k]

    def map(self, fn) -> "Sharded":
        """Sharded([fn(k, parts[k]) for each shard k]) along the same
        axis, each call made on its shard's card (on_shards)."""
        return Sharded(on_shards([p.device for p in self.parts],
                                 lambda k: fn(k, self.parts[k])),
                       self.mesh, self.axis)


def shard_batch(arr, mesh: Mesh, axis: str = "batch",
                dim: int = 0) -> Sharded:
    """`arr` (numpy, a tensor, or a Sharded) split along `dim` (the batch
    axis by default) into mesh.size equal parts, part k on mesh.devices[k].
    A size the mesh does not divide raises ValueError, as JAX's device_put
    does."""
    if isinstance(arr, Sharded):
        if arr.mesh == mesh and arr.axis == dim:
            return arr
        arr = arr.gather(mesh.devices[0])
    n = mesh.size
    N = arr.shape[dim]
    if N % n:
        raise ValueError(f"a size of {N} along dimension {dim} does not "
                         f"split evenly over the {n} devices of the mesh's "
                         f"{axis!r} axis")
    k = N // n
    if not isinstance(arr, torch.Tensor):
        a = np.ascontiguousarray(arr)
        # torch.from_numpy shares memory and warns on read-only buffers
        arr = torch.from_numpy(a if a.flags.writeable else a.copy())
    parts = []
    for i, d in enumerate(mesh.devices):
        p = arr.narrow(dim, i * k, k)
        if d.type == "cuda" and p.device.type == "cpu":
            parts.append(runtime.upload(p.numpy(), d))
        else:
            parts.append(p.to(d, non_blocking=True))
    return Sharded(parts, mesh, dim)


def _part(a, s: Sharded, k: int, per_row: bool):
    """An argument of a sharded core call, for shard k of batch s: a
    Sharded argument's part k; a per-row tensor's rows of shard k; any
    other tensor on shard k's device; anything else as it is."""
    if isinstance(a, Sharded):
        return a.parts[k]
    if not isinstance(a, torch.Tensor):
        return a
    if per_row:
        a = a[s.offsets[k]:s.offsets[k] + s.parts[k].shape[0]]
    return a.to(s.parts[k].device, non_blocking=True)


def _per_row_walk(plane) -> bool:
    """Per-image (B, n) walk tensors, sharded or not, against a shared
    (n,) walk."""
    return isinstance(plane, Sharded) or plane.dim() == 2


def corner_statics_core(plane, y, x, Ky: int, Kx: int, bucket: int,
                        jit=None, alphas=None, dither=None
                        ) -> tuple[torch.Tensor, ...]:
    """Static corner maps of a shared walk, in the JAX package's order:
    (pos, [cjd, sjd], [cad, sad], [dq, qm]).

    pos: (3, Ky, Kx) int32 (as JAX's; the K3 kernel reads it as is), the
    walk slot owning each corner bin, and `bucket` where no walk bin
    lives. cjd/sjd, when the per-slot jitter angles `jit` are given:
    cos/sin of the owning slot's jitter, 1 and 0 elsewhere. cad/sad, when
    the per-slot amplitudes `alphas` are given (Params.alpha_spread):
    cos/sin of the owning slot's amplitude, 1 and 0 elsewhere. dq/qm, when
    the per-slot QIM dithers `dither` are given: the owning slot's dither,
    and 1.0 where that slot is a payload slot (>= HEADER_SLOTS), 0
    elsewhere. All maps f32 but pos.

    plane/y/x and the per-slot arrays are the walk's (bucket,) tensors,
    tail-padded by repeating the last real slot's values, so which of the
    duplicate writes the scatter keeps does not matter."""
    dev = plane.device
    idx = (plane, y, x)
    pos = torch.full((3, Ky, Kx), bucket, dtype=torch.int32, device=dev)
    slots = torch.arange(bucket, dtype=torch.int32, device=dev)
    pos.index_put_(idx, slots)
    out = (pos,)

    def put(fill: float, vals):
        m = torch.full((3, Ky, Kx), fill, dtype=torch.float32, device=dev)
        return m.index_put_(idx, vals)

    if jit is not None:
        out += (put(1.0, torch.cos(jit)), put(0.0, torch.sin(jit)))
    if alphas is not None:
        out += (put(1.0, torch.cos(alphas)), put(0.0, torch.sin(alphas)))
    if dither is not None:
        out += (put(0.0, dither),
                put(0.0, (slots >= HEADER_SLOTS).to(torch.float32)))
    return out


def _unpack_maps(maps, has_jitter: bool, has_spread: bool, qim: bool):
    """(pos, cjd, sjd, cad, sad, dq, qm) from a corner_statics_core tuple,
    None for each pair the tuple does not carry."""
    it = iter(maps[1:])
    pos = maps[0]
    cjd, sjd = (next(it), next(it)) if has_jitter else (None, None)
    cad, sad = (next(it), next(it)) if has_spread else (None, None)
    dq, qm = (next(it), next(it)) if qim else (None, None)
    return pos, cjd, sjd, cad, sad, dq, qm


def statics_from_numpy(maps, device) -> tuple[torch.Tensor, ...]:
    """Carry static corner maps built elsewhere — e.g. the JAX package's
    _corner_statics_device maps pulled to numpy — into the port's tensors on
    `device`: integer maps (pos) become int32, float maps float32."""
    out = []
    for a in maps:
        a = np.asarray(a)
        dt = torch.int32 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        out.append(torch.tensor(a, dtype=dt, device=device))  # a copy
    return tuple(out)


def _frame_from_words(words: torch.Tensor, stream_bytes: int,
                      bucket: int) -> torch.Tensor:
    """(B, ceil(stream_bytes/4)) int32 big-endian words of header||ct||tag
    -> (B, bucket) u8 ECC frame bits: Rep-3 over the 304 header bits, Rep-7
    over the payload bits (reference frame layout, steganosaur.cpp:986-995),
    tail-padded by repeating each image's last bit."""
    nwords = -(-stream_bytes // 4)
    nmax = HEADER_SLOTS + (stream_bytes - 38) * 8 * PAYLOAD_REP
    bits = bit_ops.unpack_bits_words(words, nwords * 32)[:, :stream_bytes * 8]
    frame = torch.cat([ecc.rep_encode(bits[:, :HEADER_BITS], HEADER_REP),
                       ecc.rep_encode(bits[:, HEADER_BITS:], PAYLOAD_REP)],
                      dim=1)
    if bucket > nmax:
        frame = torch.cat(
            [frame, frame[:, -1:].expand(frame.shape[0], bucket - nmax)],
            dim=1)
    return frame


def _planes_u8(imgs: torch.Tensor, layout: str) -> torch.Tensor:
    """(B, 3, H, W) contiguous u8 view of the batch in either layout."""
    if layout == "nchw":
        return imgs.contiguous()
    return imgs.permute(0, 3, 1, 2).contiguous()


def _cos_sin(alpha: float):
    """cos/sin of alpha in f32, as 0-dim host tensors: they broadcast into
    device math as scalars, with no host-to-device copy."""
    a = torch.tensor(alpha, dtype=torch.float32)
    return torch.cos(a), torch.sin(a)


def corner_embed_core(imgs: torch.Tensor, frame: torch.Tensor, maps,
                      alpha: float, *, Ky: int, Kx: int, center: bool,
                      layout: str, floor: float, soft: bool = False,
                      has_jitter: bool = False, has_spread: bool = False,
                      qim_levels: int = 0) -> torch.Tensor:
    """Corner embed over a shared walk, single device: (imgs u8 in
    `layout`, frame (B, bucket) u8 ECC frame bits or a write_kernels
    RepFrame (an equal-length Rep-3/Rep-7 frame as its stream words), maps from
    corner_statics_core — which pairs it carries is said by has_jitter,
    has_spread and qim_levels) -> u8 stego in the same layout.

    Forward corner DFT -> each bin's frame bit through `pos` -> dense
    write_delta (soft when `soft`, jittered with cjd/sjd, amplitudes from
    cad/sad under spread) and the write floor, both in the K3 kernel
    (write_kernels.write_floor, which, where the inverse's y-stage is bf16,
    stores its bf16 operands itself); or, with qim_levels,
    write_delta_qim (payload bins on the dithered lattice) in eager torch
    and the floor alone in K3 (write_kernels.floor_only) -> inverse corner
    DFT and the u8 epilogue (_inverse_u8), each stage at the precision
    mode's precision (corner.precision())."""
    planes = _planes_u8(imgs, layout)
    H, W = planes.shape[-2:]
    pos, cjd, sjd, cad, sad, dq, qm = _unpack_maps(maps, has_jitter,
                                                   has_spread,
                                                   bool(qim_levels))
    mode = corner.precision()
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    cr, ci = corner.fwd_corner(planes, center, Ky, Kx, tabs, mode)
    ca, sa = _cos_sin(alpha) if cad is None else (cad, sad)
    pixels = float(H) * float(W)
    operands = False
    if qim_levels:
        sign, mask = write_kernels.bit_signs(pos,
                                             write_kernels.frame_bits(frame))
        dr, di = corner.write_delta_qim(cr, ci, sign, mask, qm, ca, sa, dq,
                                        qim_levels, cjd, sjd, soft=soft)
        del sign, mask
        if floor:
            dr, di, _ = write_kernels.floor_only(dr, di, cr, ci, floor=floor,
                                                 img_pixels=pixels)
    else:
        # where the y-stage is bf16 K3 stores bf16(Re D), bf16(-Im D): the
        # inverse DFT's operands, neither cast nor negated again
        operands = mode.inv_y == "bf16"
        dr, di, _ = write_kernels.write_floor(
            cr, ci, pos, frame, ca, sa, cjd, sjd, floor=floor,
            img_pixels=pixels, soft=soft, ifft_operands=operands)
    del cr, ci
    return _inverse_u8(dr, di, tabs, planes, center, layout, mode, operands)


def _inverse_u8(dr, di, tabs, planes, center: bool, layout: str, mode,
                conjugated: bool) -> torch.Tensor:
    """The embed cores' last step: the inverse corner DFT of the delta (dr,
    di) and the u8 epilogue over the cover planes -> u8 stego in `layout`,
    at the precisions of `mode` (a corner.Precision or a mode name).
    A bf16 y-stage (corner.ifft_corner_y: on CUDA the K6 kernel,
    write_kernels.ifft_y, which rounds its f32 sums to bf16 in registers)
    hands its two bf16 (3B*H, Kx) outputs to K4
    (write_kernels.ifft_epilogue), the x-stage with the epilogue in its
    registers: neither the y-stage's f32 products nor the (B, 3, H, W) f32
    image is made. An f32 y-stage (mix2) hands its products, cast to bf16
    (the x-stage's operands), to K4. An f32 x-stage takes the f32 inverse
    DFT, left unscaled, to K4e (write_kernels.epilogue), which scales; peak
    memory then holds one (B, 3, H, W) f32 tensor. The caller has dropped
    the spectrum, and the deltas go before the last step."""
    mode = corner.stages(mode)
    if mode.inv_x != "bf16":
        t = corner.ifft_corner_real(dr, di, *planes.shape[-2:], tabs, mode,
                                    scale=False, conjugated=conjugated)
        del dr, di
        return write_kernels.epilogue(t, planes, center, layout)
    if mode.inv_y == "bf16":
        mr16, mi16 = corner.ifft_corner_y(dr, di, tabs, conjugated=conjugated)
    else:
        mr, mi = corner._ifft_y(dr, di, tabs, mode.inv_y, conjugated)
        Kx = mr.shape[-1]
        mr16 = mr.to(torch.bfloat16).reshape(-1, Kx)
        del mr
        mi16 = mi.to(torch.bfloat16).reshape(-1, Kx)
        del mi
    del dr, di
    return write_kernels.ifft_epilogue(mr16, mi16, tabs, planes, center,
                                       layout)


def _flat(plane, y, x, Ky: int, Kx: int) -> torch.Tensor:
    """(B, n) per-image walk indices -> int64 offsets into a flattened
    (3, Ky, Kx) corner."""
    return (plane.to(torch.int64) * Ky + y.to(torch.int64)) * Kx \
        + x.to(torch.int64)


def _clamped(per_slot: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """(B, n) values per_slot[min(k, nbits[b] - 1)]: a shared slot-aligned
    array read up to each image's last real slot, so an image's tail-pad
    duplicates carry that slot's value."""
    n = per_slot.shape[0]
    k = torch.arange(n, device=per_slot.device)
    return per_slot[torch.minimum(k[None, :], nbits[:, None] - 1)]


def corner_piw_embed_core(imgs: torch.Tensor, frame: torch.Tensor, plane, y,
                          x, jit, alpha: float, *, Ky: int, Kx: int,
                          center: bool, layout: str, floor: float,
                          soft: bool = False, alphas=None, dither=None,
                          nbits=None, qim_levels: int = 0) -> torch.Tensor:
    """Corner embed over per-image walks (JAX corner_piw_embed_core):
    (imgs u8, frame (B, n) u8 frame bits, plane/y/x (B, n) walk indices,
    jit (B, n) f32 jitter angles) -> u8 stego in `layout`.

    Each image gathers its own bins from the corner spectrum, computes its
    write values there (write_delta with the slot's own jitter and
    amplitude; QIM on slots >= HEADER_SLOTS when qim_levels) and scatters them
    into a zero corner; then the write floor (K3's floor_only), the inverse
    DFT and the u8 epilogue (_inverse_u8, at the precision mode's stage
    precisions: K6 and K4 under mix_adaptive). alphas (n,)
    (Params.alpha_spread) and dither (n,) (QIM) are the shared slot-aligned
    per-slot arrays, read up to each image's last real slot nbits[b] - 1
    (nbits (B,) int64), so the tail-pad duplicates of the last real bin
    scatter identical values."""
    planes = _planes_u8(imgs, layout)
    B, _, H, W = planes.shape
    mode = corner.precision()
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    cr, ci = corner.fwd_corner(planes, center, Ky, Kx, tabs, mode)
    flat = _flat(plane, y, x, Ky, Kx)
    vr = cr.reshape(B, -1).gather(1, flat)
    vi = ci.reshape(B, -1).gather(1, flat)
    s = frame.to(torch.float32) * 2.0 - 1.0
    if alphas is None:
        ca, sa = _cos_sin(alpha)
    else:
        a = _clamped(alphas, nbits)
        ca, sa = torch.cos(a), torch.sin(a)
    dr_v, di_v = corner.write_delta(vr, vi, s, 1.0, ca, sa, torch.cos(jit),
                                    torch.sin(jit), soft=soft)
    if qim_levels:
        qr, qi = corner.qim_lattice_delta(vr, vi, s, _clamped(dither, nbits),
                                          qim_levels)
        pay = torch.arange(flat.shape[1], device=flat.device) >= HEADER_SLOTS
        dr_v = torch.where(pay, qr, dr_v)
        di_v = torch.where(pay, qi, di_v)
    del vr, vi, s
    dr = torch.zeros_like(cr).reshape(B, -1).scatter_(1, flat, dr_v)
    di = torch.zeros_like(ci).reshape(B, -1).scatter_(1, flat, di_v)
    del flat, dr_v, di_v
    dr, di = dr.reshape(cr.shape), di.reshape(ci.shape)
    if floor:
        dr, di, _ = write_kernels.floor_only(dr, di, cr, ci, floor=floor,
                                             img_pixels=float(H) * float(W))
    del cr, ci
    return _inverse_u8(dr, di, tabs, planes, center, layout, mode, False)


def _decode_sections(raw: torch.Tensor, hdr_stream_bits: int,
                     payload_rep: int = PAYLOAD_REP) -> torch.Tensor:
    """(B, n) hard bits -> (B, words) int32: Rep-3 header words (when
    hdr_stream_bits) then payload words under payload_rep (7 = Rep-7, 1 =
    the raw coded bits of the RS wire), MSB-first packed."""
    outs = []
    if hdr_stream_bits:
        outs.append(bit_ops.pack_bits_words(
            ecc.rep_decode(raw[:, :hdr_stream_bits], HEADER_REP)))
    outs.append(bit_ops.pack_bits_words(
        ecc.rep_decode(raw[:, hdr_stream_bits:], payload_rep)))
    return torch.cat(outs, dim=1)


def _soft_parts(d: torch.Tensor, hdr_stream_bits: int, payload_rep: int):
    """(words, conf): the matched-filter twin of _decode_sections over
    decision values d, and for the RS wire (payload_rep == 1) the payload's
    hard sign bits with a per-coded-byte confidence, min |d| over the
    byte's 8 bits, (B, n_bytes) f32 (else conf is None)."""
    outs = []
    if hdr_stream_bits:
        outs.append(bit_ops.pack_bits_words(
            ecc.rep_decode_soft(d[:, :hdr_stream_bits], HEADER_REP)))
    pay = d[:, hdr_stream_bits:]
    conf = None
    if payload_rep == 1:
        outs.append(bit_ops.pack_bits_words((pay >= 0).to(torch.uint8)))
        conf = pay.abs().reshape(pay.shape[0], -1, 8).amin(-1)
    else:
        outs.append(bit_ops.pack_bits_words(
            ecc.rep_decode_soft(pay, payload_rep)))
    return torch.cat(outs, dim=1), conf


def _decode_sections_soft(d: torch.Tensor, hdr_stream_bits: int,
                          payload_rep: int = PAYLOAD_REP) -> torch.Tensor:
    """One int32 row per image laid out [hdr soft words | payload soft
    words | conf as f32 bits (RS only)], the layout
    pipeline.batch._ExtractJob._soft_sections parses."""
    words, conf = _soft_parts(d, hdr_stream_bits, payload_rep)
    if conf is None:
        return words
    return torch.cat([words, conf.to(torch.float32).view(torch.int32)],
                     dim=1)


def _spectrum(imgs: torch.Tensor, *, Ky: int, Kx: int, center: bool,
              layout: str):
    """(cr, ci): the forward corner DFT of the u8 batch in `layout`."""
    planes = _planes_u8(imgs, layout)
    H, W = planes.shape[-2:]
    tabs = corner.dft_tables_device(H, Ky, W, Kx, planes.device)
    return corner.fwd_corner(planes, center, Ky, Kx, tabs, corner.precision())


def _sign_sin(alpha: float) -> float:
    """sign(sin alpha) in f32, the read's factor: -1.0, 0.0 or 1.0."""
    return float(np.sign(np.sin(np.float32(alpha))))


def _walk_decisions(imgs: torch.Tensor, alpha: float, plane, y, x, *,
                    Ky: int, Kx: int, center: bool, layout: str,
                    jit=None, dither=None, qim_levels: int = 0,
                    qim_from: int = 0) -> torch.Tensor:
    """(B, n) f32 decision values d at the walk bins: forward corner DFT,
    then d = sign(sin a) * (Im C * cos jd - Re C * sin jd)
    (spectral/corner.py decision_values), jd the slots' jitter angles `jit`
    — and, with qim_levels, d = -cos(L * (theta - dither)) * |C| on slots
    >= qim_from (qim_values_dense), `dither` the slots' own dithers.

    plane/y/x (and jit) are a shared walk's (n,) tensors, or per-image
    walks' (B, n). Without jitter and QIM a shared read needs Im C alone,
    and Re C is freed as soon as the DFT returns. Per-image walks floor
    the QIM magnitude at 1e-12, as JAX's per-image cores do (its dense
    shared-walk read does not).

    The eager read chain: the extract cores take it only for what K5
    (_read_decode) does not read, QIM and per-image walks, and count each
    such call under read_kernels.KERNEL_READ_EAGER."""
    read_kernels.LAUNCHES[read_kernels.KERNEL_READ_EAGER] += 1
    B = imgs.shape[0]
    cr, ci = _spectrum(imgs, Ky=Ky, Kx=Kx, center=center, layout=layout)
    ssa = _sign_sin(alpha)
    per_image = plane.dim() == 2
    if per_image:
        flat = _flat(plane, y, x, Ky, Kx)
        vi = ci.reshape(B, -1).gather(1, flat)
        vr = cr.reshape(B, -1).gather(1, flat)
    elif jit is None and not qim_levels:
        del cr
        return corner.decision_values(ci[:, plane, y, x], ssa)
    else:
        vi, vr = ci[:, plane, y, x], cr[:, plane, y, x]
    del cr, ci
    q = vi.shape[1] if not qim_levels else qim_from
    if jit is None:
        d = corner.decision_values(vi[:, :q], ssa)
    else:
        jh = jit[..., :q]
        d = corner.decision_values(vi[:, :q], ssa, vr[:, :q], torch.cos(jh),
                                   torch.sin(jh))
    if not qim_levels:
        return d
    dq = corner.qim_values_dense(vr[:, q:], vi[:, q:], dither[q:],
                                 qim_levels,
                                 mag_floor=1e-12 if per_image else 0.0)
    return torch.cat([d, dq], dim=1)


def _kernel_read(plane, qim_levels: int) -> bool:
    """Whether K5 reads this walk: a shared (n,) walk by the half-plane
    rule. QIM and per-image (B, n) walks take the eager chain."""
    return plane.dim() == 1 and not qim_levels


def _read_decode(imgs: torch.Tensor, alpha: float, plane, y, x, jit, *,
                 Ky: int, Kx: int, center: bool, layout: str,
                 hdr_stream_bits: int, payload_rep: int, hard: bool,
                 soft: str | None, plan=None):
    """(hard rows, soft rows) of a shared walk: the forward corner DFT,
    then K5 (read_kernels.read_decode: the read at the walk bins and the
    decode in one kernel, through the walk's read plan `plan` where the
    caller has one). Without jitter Re C is freed as soon as the DFT
    returns; with it, torch takes cos and sin of the slots' angles."""
    cr, ci = _spectrum(imgs, Ky=Ky, Kx=Kx, center=center, layout=layout)
    cjd = sjd = None
    if jit is None:
        cr = None
    else:
        cjd, sjd = torch.cos(jit), torch.sin(jit)
    return read_kernels.read_decode(
        ci, plane, y, x, _sign_sin(alpha), cr, cjd, sjd,
        hdr_stream_bits=hdr_stream_bits, payload_rep=payload_rep, hard=hard,
        soft=soft, plan=plan)


def corner_extract_fused_core(imgs: torch.Tensor, alpha: float, plane, y, x,
                              *, Ky: int, Kx: int, center: bool, layout: str,
                              hdr_stream_bits: int, with_soft: bool,
                              jit=None, dither=None, qim_levels: int = 0,
                              qim_from: int = 0,
                              payload_rep: int = PAYLOAD_REP, plan=None):
    """Corner extract: (imgs u8 in `layout`, walk plane/y/x — a shared
    (n,) walk or per-image (B, n) walks — their jitter angles or None,
    their QIM dithers when qim_levels) -> (B, words) int32 decoded rows
    laid out [hdr words | payload words] (the header section, 10 words =
    38 bytes + 2 pad, only when hdr_stream_bits), or (hard, soft) rows
    when with_soft.

    The hard bit at a bin is d >= 0 (_walk_decisions; QIM on slots >=
    qim_from). The payload decodes under payload_rep (7 = Rep-7, 1 = the
    RS wire's raw coded bits). The soft rows (_decode_sections_soft, RS
    confidences included) combine each group's copies by the sum of d,
    with d rounded to bf16 first, as the JAX core does before its
    gather. A shared walk without QIM reads and decodes in K5
    (_read_decode, through the walk's read_kernels.ReadPlan `plan` where
    the caller has one), the rest on the eager chain."""
    if _kernel_read(plane, qim_levels):
        hard, soft = _read_decode(
            imgs, alpha, plane, y, x, jit, Ky=Ky, Kx=Kx, center=center,
            layout=layout, hdr_stream_bits=hdr_stream_bits,
            payload_rep=payload_rep, hard=True,
            soft="bf16" if with_soft else None, plan=plan)
        return (hard, soft) if with_soft else hard
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit, dither=dither,
                        qim_levels=qim_levels, qim_from=qim_from)
    hard = _decode_sections((d >= 0).to(torch.uint8), hdr_stream_bits,
                            payload_rep)
    if not with_soft:
        return hard
    soft = _decode_sections_soft(d.to(torch.bfloat16).to(torch.float32),
                                 hdr_stream_bits, payload_rep)
    return hard, soft


def corner_soft_extract_core(imgs: torch.Tensor, alpha: float, plane, y, x,
                             *, Ky: int, Kx: int, center: bool, layout: str,
                             hdr_stream_bits: int, jit=None, dither=None,
                             qim_levels: int = 0,
                             payload_rep: int = PAYLOAD_REP, plan=None):
    """The soft-decision retry pass (JAX corner_soft_extract_core, shared
    walk with (n,) indices or per-image walks with (B, n)): matched-filter
    decode of the Rep-3 header and Rep-7 payload copies from f32 decision
    values (no bf16 rounding, unlike the fused pass's inline soft rows),
    QIM on the payload slots (>= hdr_stream_bits) when qim_levels. Returns
    (B, words) int32 rows in the corner_extract_fused_core layout, and for
    the RS wire (payload_rep == 1) (rows, conf): the payload's hard bits
    and its (B, n_bytes) f32 per-coded-byte confidences. A shared walk
    without QIM reads and decodes in K5 (`plan` as in
    corner_extract_fused_core)."""
    if _kernel_read(plane, qim_levels):
        _, rows = _read_decode(
            imgs, alpha, plane, y, x, jit, Ky=Ky, Kx=Kx, center=center,
            layout=layout, hdr_stream_bits=hdr_stream_bits,
            payload_rep=payload_rep, hard=False, soft="f32", plan=plan)
        if payload_rep != 1:
            return rows
        hw, pw, _ = read_kernels.row_words(plane.shape[0], hdr_stream_bits,
                                           payload_rep)
        return rows[:, :hw + pw], rows[:, hw + pw:].view(torch.float32)
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit, dither=dither,
                        qim_levels=qim_levels, qim_from=hdr_stream_bits)
    words, conf = _soft_parts(d, hdr_stream_bits, payload_rep)
    return words if conf is None else (words, conf)


def corner_raw_bits_core(imgs: torch.Tensor, alpha: float, plane, y, x, *,
                         Ky: int, Kx: int, center: bool, layout: str,
                         jit=None, dither=None, qim_levels: int = 0,
                         plan=None) -> torch.Tensor:
    """Raw (pre-ECC) bits of a shared walk's frame slots, packed MSB first
    into (B, ceil(n/32)) int32 words: the channel report's read (JAX
    corner_bits_core + corner_gather_raw_core, without the batch packing),
    payload slots (>= 912) by the QIM rule when qim_levels. Without QIM
    K5 reads them (no header section, payload_rep 1, hard rows only;
    `plan` as in corner_extract_fused_core)."""
    if _kernel_read(plane, qim_levels):
        return _read_decode(imgs, alpha, plane, y, x, jit, Ky=Ky, Kx=Kx,
                            center=center, layout=layout, hdr_stream_bits=0,
                            payload_rep=1, hard=True, soft=None,
                            plan=plan)[0]
    d = _walk_decisions(imgs, alpha, plane, y, x, Ky=Ky, Kx=Kx,
                        center=center, layout=layout, jit=jit, dither=dither,
                        qim_levels=qim_levels, qim_from=HEADER_SLOTS)
    return bit_ops.pack_bits_words((d >= 0).to(torch.uint8))


# --- full-grid cores (Params.adaptive_alpha) ---------------------------------

def batched_analyze_core(imgs: torch.Tensor, *, center: bool,
                         layout: str = "nhwc"):
    """(imgs u8 in `layout`) -> ((B, 3, PH, PW) complex64 reference-sign
    spectra, (B, 3) f32 upper medians of |F| per plane): one full-grid FFT
    per image-plane, kept on the device for the header and payload reads."""
    planes = _planes_u8(imgs, layout).to(torch.float32)
    H, W = planes.shape[-2:]
    PH, PW = spectral.fft_dims(H, W)
    spec = spectral.fft2(spectral.pad_planes(
        spectral.apply_center(planes, center), PH, PW))
    return spec, spectral.median_abs(spec)


def _gather_bins(spec: torch.Tensor, med: torch.Tensor, plane, y, x):
    """(v, med_at): the (B, n) bins of spectra spec (B, 3, PH, PW) at a
    shared (n,) walk or per-image (B, n) walks, and each bin's plane
    median, with the index tuple that addresses them."""
    plane, y, x = plane.long(), y.long(), x.long()
    if plane.dim() == 1:
        idx = (slice(None), plane, y, x)
        return spec[idx], med[:, plane], idx
    b = torch.arange(spec.shape[0], device=spec.device)[:, None]
    idx = (b, plane, y, x)
    return spec[idx], med[b, plane], idx


def batched_embed_core(imgs: torch.Tensor, plane, y, x, bits_words, jit,
                       alpha, n_valid=None, *, center: bool,
                       adaptive: bool = True, soft: bool = False,
                       floor: float = 0.0,
                       layout: str = "nhwc") -> torch.Tensor:
    """Full-grid batch embed (JAX batched_embed_core with packed bits;
    adaptive alpha, the one pipeline mode that needs it, unless `adaptive`
    is False, as in the graft entry's forward step, graft_entry.entry):
    (imgs u8, walk plane/y/x — a shared (n,) walk or per-image (B, n)
    walks — bits_words (B, n/32) int32 MSB-first frame words, jit the
    slots' jitter angles, alpha a number or the (n,) per-slot amplitudes,
    n_valid the un-padded slot count (an int, or (B,) per image; slots
    past it are tail-pad duplicates, left out of the write floor's energy))
    -> u8 stego in `layout`.

    Per image: full FFT, medians, the ops/phase.py write at the walk bins
    (adaptive alpha; the soft write and the floor as asked), the
    Hermitian-half scatter (2*nv - v at the primary bins only: real(IFFT)
    sees exactly nv there and conj(nv) at the mirror), the inverse FFT and
    the u8 rounding. Tail-pad duplicates carry their twin's value, so the
    scatter keeps the same value whichever write wins (on a card
    index_put_ lets any of a bin's writes win, on the CPU the last: a bin
    written twice with two values differs between them).

    A Sharded imgs runs each shard on its own device and returns a Sharded
    stego: the per-row arguments (bits_words; per-image walks and jitters;
    per-image n_valid) may be Sharded or whole-batch tensors."""
    if isinstance(imgs, Sharded):
        walk = _per_row_walk(plane)
        per_n = isinstance(n_valid, Sharded) or (
            isinstance(n_valid, torch.Tensor) and n_valid.dim() == 1)
        return imgs.map(lambda k, part: batched_embed_core(
            part, *(_part(a, imgs, k, walk) for a in (plane, y, x)),
            _part(bits_words, imgs, k, True), _part(jit, imgs, k, walk),
            _part(alpha, imgs, k, False), _part(n_valid, imgs, k, per_n),
            center=center, adaptive=adaptive, soft=soft, floor=floor,
            layout=layout))
    spec, med = batched_analyze_core(imgs, center=center, layout=layout)
    H, W = (imgs.shape[2], imgs.shape[3]) if layout == "nchw" \
        else (imgs.shape[1], imgs.shape[2])
    PH, PW = spec.shape[-2:]
    bits = bit_ops.unpack_bits_words(bits_words, bits_words.shape[-1] * 32)
    v, med_at, idx = _gather_bins(spec, med, plane, y, x)
    nv = phase_ops.write_values(v, bits, jit, alpha, med_at, adaptive,
                                soft=soft, floor=floor,
                                img_pixels=float(H) * W, n_valid=n_valid,
                                gain=(H * W) / (PH * PW))
    spec[idx] = 2.0 * nv - v
    del v, nv, med_at
    t = spectral.ifft2_real(spec)[..., :H, :W]
    del spec
    out = spectral.from_planes(spectral.apply_center(t, center))
    return out.permute(0, 3, 1, 2).contiguous() if layout == "nchw" else out


def batched_read_core(imgs, plane, y, x, jit, alpha, *, center: bool,
                      adaptive: bool, layout: str = "nhwc"):
    """Full-grid read in one call (JAX batched_read_core): (imgs u8 in
    `layout`, a shared (n,) walk or per-image (B, n) walks, their jitter
    angles, alpha a number) -> (B, n) int32 raw bits by the reference's
    phase rule (ops/phase.read_phases_at), alpha magnitude-adaptive when
    `adaptive`. A Sharded imgs gives a Sharded result, each shard read on
    its own device."""
    if isinstance(imgs, Sharded):
        walk = _per_row_walk(plane)
        return imgs.map(lambda k, part: batched_read_core(
            part, *(_part(a, imgs, k, walk) for a in (plane, y, x, jit)),
            alpha, center=center, adaptive=adaptive, layout=layout))
    spec, med = batched_analyze_core(imgs, center=center, layout=layout)
    v, med_at, _ = _gather_bins(spec, med, plane, y, x)
    del spec
    return phase_ops.read_phases_at(v, med_at, jit, alpha, adaptive).to(
        torch.int32)


def batched_gather_decode_core(spec: torch.Tensor, med: torch.Tensor, plane,
                               y, x, jit, alpha: float, *,
                               hdr_stream_bits: int,
                               payload_rep: int = PAYLOAD_REP,
                               with_soft: bool = False):
    """Full-grid batch read + decode (JAX batched_gather_decode_core) under
    the adaptive-alpha rule: spectra and medians from batched_analyze_core,
    a shared (n,) walk or per-image (B, n) walks and their jitter angles ->
    (B, words) int32 rows [Rep-3 header words (when hdr_stream_bits) |
    payload words under payload_rep], or (hard, soft) rows with
    with_soft: the soft rows come
    from the same f32 decision values whose sign is the hard bit
    (ops/phase.read_values), with no bf16 rounding."""
    v, med_at, _ = _gather_bins(spec, med, plane, y, x)
    if with_soft:
        d = phase_ops.read_values_at(v, med_at, jit, alpha, True)
        return (_decode_sections((d >= 0).to(torch.uint8), hdr_stream_bits,
                                 payload_rep),
                _decode_sections_soft(d, hdr_stream_bits, payload_rep))
    raw = phase_ops.read_phases_at(v, med_at, jit, alpha, True)
    return _decode_sections(raw, hdr_stream_bits, payload_rep)
