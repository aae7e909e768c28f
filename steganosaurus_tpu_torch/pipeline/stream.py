"""Host/device pipelining across batches, in torch.

The port's twin of steganosaurus_tpu/pipeline/stream.py. CUDA work is
asynchronous: embed_batch and extract_dispatch queue a batch's device work
and return (pipeline/batch.py keeps every upload and pull off the host's
critical path), so while batch N's kernels run, the host seals batch N+1's
AEAD streams, parses and opens batch N-1's headers, and queues the next
kernels. With host time h and device time d per batch, a depth-bounded
stream approaches max(h, d) per batch instead of h + d.

One CUDA stream per device carries every batch, in order. A batch is waited
for by a torch.cuda.Event recorded after its last op on each device it ran
on — never torch.cuda.synchronize(), which would also wait for the batch
queued behind it. Under mesh= (parallel.make_mesh) each batch is split over
the mesh's devices by embed_batch / extract_dispatch; the overlap across
batches is the same. Each batch's steps and waits run under the spans of
utils/spans.py, numbered by batch, for a profiler to read.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from steganosaurus_tpu_torch import crypto
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel.batch import Sharded
from steganosaurus_tpu_torch.pipeline.batch import (
    embed_batch,
    extract_dispatch,
    prefetch_piw_walks,
    prefetch_walk,
)
from steganosaurus_tpu_torch.utils.spans import span


def _hw(imgs, layout: str) -> tuple[int, int]:
    return ((imgs.shape[2], imgs.shape[3]) if layout == "nchw"
            else (imgs.shape[1], imgs.shape[2]))


def _done_events(t) -> list[torch.cuda.Event]:
    """An event recorded after the last op queued so far on the stream of
    each CUDA device t (a tensor, or a Sharded batch) lives on (none off
    CUDA, where the work has already run)."""
    parts = t.parts if isinstance(t, Sharded) else (t,)
    devs = dict.fromkeys(p.device for p in parts
                         if isinstance(p, torch.Tensor)
                         and p.device.type == "cuda")
    events = []
    for d in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    return events


def embed_stream(
    batches,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    verify: bool = False,
    max_retries: int = 2,
    depth: int = 2,
    layout: str = "nhwc",
    device=None,
):
    """Pipeline embed_batch over an iterable of batches.

    batches: iterable of (imgs, secrets), (imgs, secrets, salts), or
    (imgs, secrets, salts, master_key); imgs may be numpy or a tensor
    already on the device. A per-batch master_key (4th element) overrides
    the stream-level key — when it CHANGES between batches, the new key's
    sequential turtle-walk expansion is run by prefetch_walk on a worker
    thread, overlapping the batches in flight (the walk cache is locked; the
    later embed_batch finds it warm). Under Params.per_image_walk a batch's
    salts are drawn up front (when not given) and its salt-keyed payload
    walks are expanded by prefetch_piw_walks on the same worker thread.
    The stream reads one batch ahead of the one it embeds, so batch N+1's
    host walks run while batch N embeds; batch N waits for its own
    prefetch to finish and embed_batch pops every walk it made (none is
    expanded twice, none is left in the cache).

    Yields one BatchEmbedResult per batch, in order, with the stego as a
    tensor on the device, or a Sharded over `mesh` (feed it straight to
    extract_stream). Up to
    `depth` batches are in flight: batch N+1's host crypto runs while batch
    N's kernels execute (verify=True reads every batch back, which waits
    for it and shrinks — but does not remove — the overlap).
    """
    q: deque = deque()
    pool: ThreadPoolExecutor | None = None

    def _submit(fn, *args):
        nonlocal pool
        if pool is None:
            pool = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="walk-pf")
        return pool.submit(fn, *args)

    def _prepared():
        """(imgs, secrets, salts, key, password, piw future) per batch:
        the host walk work of each batch is submitted here, in order."""
        last_mk = master_key
        for item in batches:
            imgs, secrets = item[0], item[1]
            salts = item[2] if len(item) > 2 else None
            mk = (item[3] if len(item) > 3 and item[3] is not None
                  else master_key)
            pw = password if mk is None else None
            if mk != last_mk:
                _submit(prefetch_walk, pw, mk, params, *_hw(imgs, layout),
                        [len(s) for s in secrets])
                last_mk = mk
            walks = None
            if params.per_image_walk:
                if salts is None:
                    salts = [crypto.get_random_bytes(16) for _ in secrets]
                walks = _submit(prefetch_piw_walks, pw, mk, params,
                                *_hw(imgs, layout), list(salts),
                                [len(s) for s in secrets])
            yield imgs, secrets, salts, mk, pw, walks

    def _drain():
        b, res, events = q.popleft()
        # bounds the batches in flight; waits for this batch's kernels only
        with span("stt.wait.stream", b):
            for ev in events:
                ev.synchronize()
        return res

    try:
        items = _prepared()
        b = 0
        with span("stt.stream.take", b):
            nxt = next(items, None)
        while nxt is not None:
            imgs, secrets, salts, mk, pw, walks = nxt
            # one batch of look-ahead: batch N+1's walks expand on the
            # worker while batch N embeds
            with span("stt.stream.take", b + 1):
                nxt = next(items, None)
            if walks is not None:
                # batch N's own walks: embed_batch pops them rather than
                # expanding them a second time beside the worker
                walks.result()
            if len(q) >= depth:
                yield _drain()
            with span("stt.stream.embed", b):
                res = embed_batch(imgs, secrets, password=pw, master_key=mk,
                                  params=params, salts=salts, mesh=mesh,
                                  device_resident=True, verify=verify,
                                  max_retries=max_retries, layout=layout,
                                  device=device)
                q.append((b, res, _done_events(res.stego)))
            b += 1
        while q:
            yield _drain()
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def extract_stream(
    batches,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    clen_hint: int | None = None,
    depth: int = 2,
    layout: str = "nhwc",
    device=None,
):
    """Pipeline extract_batch over an iterable of stego batches.

    batches: iterable of stego arrays or tensors, or (stego, master_key)
    tuples for per-batch key rotation (symmetric with embed_stream — a
    rotated key's walk expansion is prefetched on a worker thread while the
    passes in flight complete).

    Yields one list[bytes | None] per batch, in order. The fused pass for
    batch N+1 is queued before batch N's results are waited for and
    AEAD-opened, so the host parse/open work and the device pass overlap.
    """
    q: deque = deque()
    pool: ThreadPoolExecutor | None = None

    def _finalize():
        b, job = q.popleft()
        with span("stt.stream.extract_finalize", b):
            return job.finalize()

    try:
        last_mk = master_key
        for b, item in enumerate(batches):
            if isinstance(item, tuple):
                imgs, mk = item[0], (item[1] if item[1] is not None
                                     else master_key)
            else:
                imgs, mk = item, master_key
            pw = password if mk is None else None
            if mk != last_mk:
                if pool is None:
                    pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="walk-pf")
                pool.submit(prefetch_walk, pw, mk, params, *_hw(imgs, layout),
                            [clen_hint or 0])
                last_mk = mk
            if len(q) >= depth:
                yield _finalize()
            with span("stt.stream.extract_dispatch", b):
                q.append((b, extract_dispatch(
                    imgs, password=pw, master_key=mk, params=params,
                    mesh=mesh, clen_hint=clen_hint, layout=layout,
                    device=device)))
        while q:
            yield _finalize()
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def load_rgb_batches(paths, batch_size: int, threads: int = 8):
    """Threaded PNG ingest: decode `paths` with a thread pool (PIL releases
    the GIL around decode) and yield (paths, (B, H, W, 3) u8 stack) pairs
    of consecutive same-shape images, each at most batch_size. A shape
    change flushes the current stack.

    Decode is backpressured: at most 2*threads images are decoded ahead of
    the consumer, so a stalled device pipeline never piles up decoded
    frames in host memory. Host code only, the JAX package's
    load_rgb_batches on the port's io.image."""
    from steganosaurus_tpu_torch.io import image as image_io

    paths = list(paths)
    window = max(2 * threads, 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs: deque = deque(
            pool.submit(image_io.load_rgb, p) for p in paths[:window])
        nxt = window
        cur: list[np.ndarray] = []
        cur_paths: list = []
        for path in paths:
            img = futs.popleft().result()
            if nxt < len(paths):
                futs.append(pool.submit(image_io.load_rgb, paths[nxt]))
                nxt += 1
            if cur and (img.shape != cur[0].shape
                        or len(cur) == batch_size):
                yield cur_paths, np.stack(cur)
                cur, cur_paths = [], []
            cur.append(img)
            cur_paths.append(path)
        if cur:
            yield cur_paths, np.stack(cur)
