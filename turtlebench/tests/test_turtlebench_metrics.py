"""Each metric reader's arithmetic on a synthetic window and trace."""

import pytest

from turtlebench import harness

PEAKS = {"bf16": 1e15, "fp32": 1e14, "hbm_bytes": 1e12}
SHAPE = {"B": 2, "H": 64, "W": 128, "Ky": 32, "Kx": 64, "secret_bytes": 10,
         "precision": "mix_adaptive", "slots": 912 + 26 * 56}


def run_of(window=None, trace=None, shape=SHAPE, peaks=PEAKS):
    return harness.Run(window, trace, shape, peaks)


def read(name, run):
    return harness.load_reader(name)(run)


def test_window_readers():
    w = {"seconds": 2.0, "batches": 4, "images": 8, "ok": 7,
         "latencies_s": [0.1 * i for i in range(1, 21)],
         "peak_bytes": 3 * 2**30, "setup_s": 5.5}
    r = run_of(window=w)
    assert read("ips", r) == 3.5
    assert read("request_p95_ms", r) == pytest.approx(1000 * 1.905)
    assert read("peak_gib", r) == 3.0
    assert read("setup_s", r) == 5.5
    # nothing to read in a traced run's per-layer pass
    assert read("ips", run_of()) is None
    assert read("peak_gib", run_of(window=dict(w, peak_bytes=0))) is None


def trace_of(ops, runtime=(), window_s=1.0, batches=2):
    return harness.Trace(list(ops), list(runtime), [], window_s, batches)


def test_idle_share_takes_the_union_of_busy_intervals():
    t = trace_of([("a", 0, 100_000), ("b", 50_000, 100_000),
                  ("c", 400_000, 100_000)])
    # busy 0..150 ms and 400..500 ms of a 1 s window
    assert read("device_idle_share", run_of(trace=t)) == pytest.approx(75.0)
    assert read("device_idle_share", run_of(trace=trace_of([]))) is None


def test_launches_per_batch_counts_the_device_operations():
    ops = [("k", 0, 1)] * 14 + [("Memcpy HtoD (Pinned -> Device)", 0, 1)] * 2
    t = trace_of(ops, [("cudaStreamSynchronize", 0, 1)] * 7, batches=4)
    assert read("launches_per_batch", run_of(trace=t)) == 4.0
    assert read("launches_per_batch", run_of(trace=trace_of([]))) is None


@pytest.mark.parametrize("metric,kernels,work", [
    ("fwd_dft_roofline",
     ["void (anonymous namespace)::corner_stage1_tma_kernel(CUtensorMap)",
      "(anonymous namespace)::corner_stage2_prep_kernel",
      "(anonymous namespace)::corner_stage2_band_kernel",
      "(anonymous namespace)::corner_stage2_kernel"], "side_work"),
    ("inv_dft_roofline",
     ["(anonymous namespace)::resident_kernel<__nv_bfloat16, 1>",
      "(anonymous namespace)::corner_ifft_y_kernel<true>",
      "(anonymous namespace)::corner_ifft_nchw_kernel<true>"], "embed_work"),
])
def test_roofline_share_is_the_bound_over_the_groups_kernel_time(
        metric, kernels, work):
    import importlib.util
    import pathlib

    path = pathlib.Path(harness.ROOT) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("m_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bf16, f32, nbytes = getattr(mod, work)(SHAPE)
    bound = max(bf16 / PEAKS["bf16"] + f32 / PEAKS["fp32"],
                nbytes / PEAKS["hbm_bytes"])
    sides = 2 if metric == "fwd_dft_roofline" else 1
    batches = 3
    # each group kernel takes 1 ms a batch; other kernels do not count
    ops = [(k, 0, 1000.0) for k in kernels for _ in range(batches)]
    ops += [("at::native::sbtopk::gatherTopK<float>", 0, 5e6),
            ("Memcpy DtoH", 0, 5e6)]
    t = trace_of(ops, batches=batches)
    got = read(metric, run_of(trace=t))
    want = 100 * sides * batches * bound / (len(kernels) * batches * 1e-3)
    assert got == pytest.approx(want)
    # no card peaks, another precision mode, or none of the kernels: nothing
    assert read(metric, run_of(trace=t, peaks=None)) is None
    assert read(metric, run_of(trace=t, shape=dict(SHAPE, precision="high"))) \
        is None
    assert read(metric, run_of(trace=trace_of(ops[-2:]))) is None


def test_breakdown_sums_device_ops_and_labels_idle_gaps():
    dev = [("void ns::k1<int>(float*)", 0, 10), ("ns::k2", 20, 10),
           ("void ns::k1<int>(float*)", 40, 10)]
    host = [("aten::copy_", 9, 12), ("outer", 0, 100)]
    t = harness.Trace(dev, [], host, 1.0, 1)
    b = harness.breakdown(t)
    assert b["device_ops"][0] == ["ns::k1<int>", 20e-6]
    # gaps 10..20 (aten::copy_ at its middle) and 30..40 and 50..100
    labels = dict(b["idle_gaps"])
    assert labels["aten::copy_"] == pytest.approx(10e-6)
    assert labels["outer"] == pytest.approx(60e-6)
    assert harness.busy_seconds(t) == pytest.approx(30e-6)
