"""device_idle_share: 100 x (1 - the union of the device's busy intervals
(kernels, copies, sets) over the traced stretch's host seconds), in %."""

from turtlebench.harness import busy_seconds


def read(run):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(t) / t.window_s)
