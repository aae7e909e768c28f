"""launches_per_batch: the operations the host dispatched to the card over
the traced stretch, per batch (one batch: its embed and its extract): every
kernel, copy and memset the profiler records on the device, each one launch
or one asynchronous copy. The dispatch layer's work count, which CUDA
graphs or fewer host round trips would cut."""


def read(run):
    t = run.trace
    if t is None or not t.batches or not t.device_ops:
        return None
    return len(t.device_ops) / t.batches
