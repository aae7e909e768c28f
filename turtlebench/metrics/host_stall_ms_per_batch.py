"""host_stall_ms_per_batch: the card's idle time that falls inside the
program's own host steps, per batch of the traced stretch, in ms: the
intervals of host_ms_per_batch (the steps less their waits, host_steps.py)
less the union of the device's busy intervals (kernels, copies, sets). The
part of device_idle_share that the program's host work causes, as opposed
to the feed (stt.stream.take) or the harness. None without device
operations, or where the program opens no such span."""

from turtlebench.harness import busy_intervals
from turtlebench.host_steps import length, own_intervals, subtract


def read(run):
    t = run.trace
    if t is None or not t.device_ops or not t.batches:
        return None
    own = own_intervals(t)
    if not own:
        return None
    idle = subtract(own, busy_intervals(t.device_ops))
    return length(idle) / 1e3 / t.batches
