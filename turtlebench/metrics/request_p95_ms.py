"""request_p95_ms: the 95th percentile, over every batch of the window, of
the time from the batch's submission to the stream (the stream takes it
from the feed) until its secrets are returned (host clock)."""

import numpy as np


def read(run):
    w = run.window
    if w is None or not w["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(w["latencies_s"]), 95)) * 1e3
