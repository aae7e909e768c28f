"""The program's own host steps in a traced stretch, read from its spans.

The port opens a span (torch.profiler.record_function, recorded as a
user_annotation on the profiler's clock, so on the card's timeline) around
each step the stream's thread takes for a batch, named with the batch's
number: stt.stream.embed(b=N) (embed_batch), stt.stream.extract_dispatch(b=N)
and stt.stream.extract_finalize(b=N); and a stt.wait.* span around each wait
for the card, inside those steps or beside them. A step's own time is its
interval less the waits inside it. On a program without these spans
own_intervals is empty, and the readers built on it return None.
"""

from __future__ import annotations

from turtlebench.harness import Trace, busy_intervals, short_name

STEPS = frozenset({"stt.stream.embed", "stt.stream.extract_dispatch",
                   "stt.stream.extract_finalize"})
WAIT = "stt.wait."


def subtract(a: list, b: list) -> list:
    """The merged, sorted intervals a less the merged, sorted intervals b."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def length(intervals: list) -> float:
    return sum(e - s for s, e in intervals)


def own_intervals(trace: Trace) -> list:
    """The host's own time in the program's steps, as merged [start, end]
    intervals in microseconds: the steps' union less every wait's."""
    steps = busy_intervals([h for h in trace.host
                            if short_name(h[0]) in STEPS])
    waits = busy_intervals([h for h in trace.host if h[0].startswith(WAIT)])
    return subtract(steps, waits)
