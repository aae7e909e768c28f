"""The host-step readers' arithmetic on a synthetic trace (host_steps.py,
metrics/host_ms_per_batch.py, metrics/host_stall_ms_per_batch.py)."""

import pytest

from turtlebench import harness

SHAPE = {"B": 2, "H": 64, "W": 128, "Ky": 32, "Kx": 64, "secret_bytes": 10,
         "precision": "mix_adaptive", "slots": 912 + 26 * 56}


def read(name, trace):
    return harness.load_reader(name)(harness.Run(None, trace, SHAPE, {}))


def test_host_readers_subtract_waits_and_read_idle_inside_steps():
    """Steps embed [0, 1000] and finalize [2000, 3000] (us), a wait.pull
    [2500, 2900] inside finalize, a wait.stream [1000, 1500] between them
    and a take [1500, 2000]: the host's own time 1000 + 500 + 100 = 1600
    us over 4 batches, 0.4 ms. The card is busy [0, 600] and [1200, 2800]:
    idle [600, 1000] in embed, [1000, 1200] in the wait.stream, [2800,
    2900] in the wait.pull and [2900, 3000] in finalize; the stall is 400 +
    100 = 500 us, 0.125 ms a batch."""
    host = [("stt.stream.embed(b=0)", 0.0, 1000.0),
            ("stt.embed.queue", 200.0, 700.0),
            ("stt.wait.stream(b=0)", 1000.0, 500.0),
            ("stt.stream.take(b=2)", 1500.0, 500.0),
            ("stt.stream.extract_finalize(b=0)", 2000.0, 1000.0),
            ("stt.wait.pull", 2500.0, 400.0)]
    dev = [("k", 0.0, 600.0), ("k", 1200.0, 1600.0)]
    t = harness.Trace(dev, [], host, 1.0, 4)
    assert read("host_ms_per_batch", t) == pytest.approx(0.4)
    assert read("host_stall_ms_per_batch", t) == pytest.approx(0.125)
    # no device operations, or no spans of the program: nothing
    assert read("host_stall_ms_per_batch",
                harness.Trace([], [], host, 1.0, 4)) is None
    assert read("host_ms_per_batch", harness.Trace(dev, [], [], 1.0, 4)) is None
