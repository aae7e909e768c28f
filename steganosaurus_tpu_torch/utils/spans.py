"""Named spans at the port's stream and host-step boundaries.

`span(name, b)` opens a torch.profiler.record_function range while a
profiler runs, which the profiler records as a user_annotation event on the
same clock as the card's kernels and copies; with no profiler running it
returns one shared null context and costs one attribute check. There is no
buffer, exporter or clock here: the profiler keeps the spans and writes
them out with its trace.

Names (all opened on the thread that drives the stream, none across a
yield but stt.stream.take, which wraps the stream's read of its input):

- stream (pipeline/stream.py), each with the batch's number `(b=N)`,
  counted from 0 in each embed_stream / extract_stream call:
  stt.stream.take, stt.stream.embed, stt.wait.stream,
  stt.stream.extract_dispatch, stt.stream.extract_finalize;
- host steps (pipeline/batch.py, runtime.py): stt.embed.seal,
  stt.embed.frame, stt.embed.walk, stt.embed.queue, stt.extract.walk,
  stt.extract.queue, stt.extract.parse, stt.extract.open, stt.wait.pull;
- events, one span each time they happen: stt.extract.payload_pass,
  stt.extract.soft_retry, stt.extract.row_fallback, stt.walk.expand,
  stt.read.plan_build.

Every stt.wait.* span is the host waiting for the card.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str, b: int | None = None):
    """A context manager: the profiler's range `name`, or `name(b=N)` for
    batch b, while a profiler runs; else one shared null context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(
            name if b is None else f"{name}(b={b})")
    return _OFF
