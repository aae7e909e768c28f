"""host_ms_per_batch: the host's own time in the program's steps, per batch
of the traced stretch, in ms: the spans stt.stream.embed,
stt.stream.extract_dispatch and stt.stream.extract_finalize less the
stt.wait.* spans inside them (host_steps.py). The h of the stream's
max(h, d) a batch; its distance below the card's busy ms a batch says how
far the cell is from being host-bound. None where the program opens no
such span."""

from turtlebench.host_steps import length, own_intervals


def read(run):
    t = run.trace
    if t is None or not t.batches:
        return None
    own = own_intervals(t)
    if not own:
        return None
    return length(own) / 1e3 / t.batches
