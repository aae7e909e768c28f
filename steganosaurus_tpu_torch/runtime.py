"""Device resolution and numeric setup for the port.

Every pipeline entry point resolves its device here, explicitly: the input
tensor's device when it is given one, else the caller's `device` argument,
else CUDA. Nothing falls back to the CPU on its own — the CPU runs only when
the caller hands it CPU tensors or asks for it by name.
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch.utils.spans import span


def configure_precision() -> None:
    """Disable TF32 for float32 matmuls and convolutions, on purpose.

    The forward stage-2 band and the "highest" arbiter are full-f32 products
    (spectral/corner.py). TF32 keeps ~10 mantissa bits, about what bf16
    keeps, and would silently turn those f32 stages into the bf16-class
    accuracy that breaks 4K/16 KB recovery on high-energy spectrum columns.
    PyTorch's matmul default is already off, cuDNN's is on; both are set so
    the choice is stated rather than inherited."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "steganosaurus_tpu_torch: CUDA requested but torch.cuda is not "
            "available on this machine")


def resolve_device(device=None, like=None) -> torch.device:
    """The device a pipeline call runs on: `like`'s device when `like` is a
    tensor, else `device`, else "cuda". A CUDA device requires CUDA."""
    configure_precision()
    if isinstance(like, torch.Tensor):
        dev = like.device
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def to_device(imgs, dev: torch.device) -> torch.Tensor:
    """u8 images (a numpy array or a tensor) as a tensor on `dev`."""
    if isinstance(imgs, torch.Tensor):
        t = imgs
    else:
        a = np.ascontiguousarray(imgs)
        # torch.from_numpy shares memory and warns on read-only buffers
        # (e.g. a JAX array's numpy view): copy those
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dtype != torch.uint8:
        raise ValueError(f"images must be uint8, got {t.dtype}")
    return t.to(dev)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`. To CUDA it goes through pinned
    memory with a non-blocking copy: a pageable .to(cuda) synchronizes the
    stream, which would make the host wait for every batch queued ahead of
    it and undo the stream pipeline's overlap."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class HostCopy:
    """A device tensor's copy to the host, queued at construction and
    waited for in numpy(). On CUDA the copy goes into pinned memory behind
    the work that produced the tensor, and numpy() waits on an event
    recorded right after it: only for that work, not for batches queued
    later on the same stream (torch.cuda.synchronize() or a plain .cpu()
    would wait for those too)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with span("stt.wait.pull"):
                self._event.synchronize()
        return self._host.numpy()
