"""peak_gib: torch.cuda.max_memory_allocated() over the window, its peak
statistics reset as the window starts, in GiB."""


def read(run):
    w = run.window
    if w is None or not w["peak_bytes"]:
        return None
    return w["peak_bytes"] / 2**30
