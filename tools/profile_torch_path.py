"""Where the time goes in the torch port's main path, on one CUDA card.

    python3 tools/profile_torch_path.py [--stream | --single | --crop | --stage2]
        [--tree=DIR] [TRACE_DIR]

Runs one warm embed_batch -> extract_batch round trip of chip_smoke.py's 4K
workload (2160x3840, B=64, 16 KB; seed-42 bench covers, rng(7) secrets,
salts bytes([i])*16) under torch.profiler and prints, for embed and extract
separately: host wall ms (ending in torch.cuda.synchronize), device busy ms
(the sum of the kernels' device time on the one stream), the idle share,
device ms per stage, and the top kernels. Stages are profiler ranges put
around the corner functions for this run only (stage1 = the K1 wrapper,
stage 2 = "stage2 prep" (the prep kernel's wrapper: bf16 copies and column
energies), "topk" (the band's torch.topk), "band" (the band kernel: the
band columns' bf16 terms and the column mask) and "K2" (the K2 wrapper), or
"stage2" where the eager y-contraction
corner._fwd_y_split runs (a tree before K2), write+floor = the K3 wrapper's
write_floor, floor = its floor_only (QIM, per-image walks), ifft y = the
inverse DFT's y-stage (corner.ifft_corner_y: the K6 kernel's wrapper, or in
a tree before K6 the eager chain of cuBLAS products, sums and casts), K4 =
the K4 wrapper (the x-stage with the u8 epilogue); under
STEGANOSAURUS_MM_PRECISION=highest ifft = the f32 inverse DFT and epilogue
= the K4e wrapper; read+decode = the K5 wrapper (the extract's read at
the walk bins and its Rep-3/Rep-7 decode), or in a tree before K5 part
of "other"; "other" is the rest). Each
window also prints the device kernels inside each stage's span, so a
stage shows which kernels ran it.

--stream profiles a two-batch embed_stream -> extract_stream (depth 2) of
the same workload against the serialized loop of two round trips, and
prints wall ms, device busy ms and idle share of each: the overlap of host
and device work that the stream buys shows as a lower idle share.

--crop runs the same round trip on the covers cropped to 3839 columns
(chip_smoke.py's phase 4c): a width that is not a multiple of 16, so stage 1
takes the K1 kernel's load route and every other stage an odd width.

--stage2 profiles the embed's forward corner DFT alone (corner.fwd_corner
under mix_adaptive on the same covers, warm) and prints every device kernel
by its time: stage 2 broken down by op, beside K1's one kernel.

--tree=DIR imports the package and chip_smoke.py from the checkout DIR
in place of this one (another commit unpacked by `git archive`): a parent
and a change profiled by the same tool, in one call.

--single profiles one warm embed_array -> extract_array of the first of
those covers with one 16 KB secret under default Params (chip_smoke.py's
phase 7a at the salt that reads back: the full-grid single-image path), with
the stages fft, median, capacity, features, write, ifft, u8 (the rounding
epilogue) and read as profiler ranges, and the host seconds of the turtle
walk beside them.

The Chrome traces go to TRACE_DIR/profile_torch_path_<window>.json (default
build/profile/, gitignored). The round trip's profile ends with one more
embed and extract, not profiled, that print the peak device memory
allocated during each stage (torch.cuda.max_memory_allocated, reset as
each stage starts): where each side's peak is set.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


# {stage: peak GiB allocated while it ran} while a pass records them (None:
# not recording)
_PEAKS: dict | None = None


def _span(name, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _PEAKS is None:
            with record_function(name):
                return fn(*args, **kwargs)
        import torch

        torch.cuda.reset_peak_memory_stats()
        try:
            return fn(*args, **kwargs)
        finally:
            _PEAKS[name] = max(_PEAKS.get(name, 0.0),
                               torch.cuda.max_memory_allocated() / 2 ** 30)

    return wrapped


def _stage_peaks(fn) -> dict:
    """{stage: peak GiB of device memory allocated while it ran} over one
    unprofiled fn() (each stage span resets the peak at its entry)."""
    import torch

    global _PEAKS
    _PEAKS = {}
    try:
        fn()
        torch.cuda.synchronize()
        return dict(_PEAKS)
    finally:
        _PEAKS = None


def _kernels_within(events, spans: set) -> dict:
    """{span: {device kernel name: count}} of the device events (kernels,
    copies) that lie inside a device window of each stage span."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    wins: dict = {}
    for e in dev:
        if e.name in spans:
            wins.setdefault(e.name, []).append((e.time_range.start,
                                                e.time_range.end))
    inside: dict = {k: {} for k in wins}
    for e in dev:
        if e.name in spans:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        for span, ws in wins.items():
            if any(a <= t0 and t1 <= b for a, b in ws):
                key = e.name[:70]
                inside[span][key] = inside[span].get(key, 0) + 1
    return inside


def _profile(name: str, fn, out: pathlib.Path, spans: set):
    """Run fn() under torch.profiler; print and return (wall ms, device
    busy ms, device events other than the stage spans, span ms by name);
    print the device kernels inside each span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # the stage ranges appear on the device as annotations spanning their
    # kernels (K1, launched through ctypes, is attributed to its range only
    # there); every other device event is a kernel or a copy
    dev_evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev_evts if e.key not in spans]
    span_ms = {e.key: e.self_device_time_total / 1e3 for e in dev_evts
               if e.key in spans}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{name}: wall {wall!r} ms, device busy {busy!r} ms, idle share "
          f"{max(0.0, 1.0 - busy / wall)!r}")
    for span, ks in _kernels_within(prof.events(), spans).items():
        print(f"  kernels inside {span!r}: {ks}")
    prof.export_chrome_trace(str(out / f"profile_torch_path_{name}.json"))
    return wall, busy, kernels, span_ms


def _host_timed(fn, times: list):
    """fn, appending each call's host seconds to `times`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t)

    return wrapped


def _print_stages(busy: float, kernels, spans: dict) -> None:
    for key, ms in spans.items():
        print(f"  stage {key:8s} {ms:10.3f} ms")
    print(f"  stage {'other':8s} {busy - sum(spans.values()):10.3f} ms")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"  kernel {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<3d} {e.key[:80]}")


def single_image(out: pathlib.Path) -> int:
    """--single: the 4K single-image round trip, stage by stage."""
    import torch

    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import keystream, spectral
    from steganosaurus_tpu_torch.ops import mask, phase

    stages = [("fft", spectral, "fft2"), ("median", spectral, "median_abs"),
              ("capacity", mask, "capacity_bits"),
              ("features", spectral, "cover_hash_features"),
              ("write", phase, "embed_phases"),
              ("ifft", spectral, "ifft2_real"),
              ("u8", spectral, "from_planes"),
              ("read", phase, "read_phases")]
    for name, mod, attr in stages:
        setattr(mod, attr, _span(name, getattr(mod, attr)))
    walk_s: list = []
    for attr in ("turtle_expand", "header_walk_with_visited",
                 "turtle_expand_chained"):
        setattr(keystream, attr, _host_timed(getattr(keystream, attr),
                                             walk_s))
    dev = torch.device("cuda", 0)
    cover = torch.from_numpy(chip_smoke.make_covers(
        chip_smoke.UHD_BASE, chip_smoke.UHD_H, chip_smoke.UHD_W)[0]).to(dev)
    secret = chip_smoke.secrets_for(1, chip_smoke.UHD_SECRET)[0]
    mk = chip_smoke.SINGLE_KEY

    salt = bytes([next(i for i, ok in chip_smoke.SINGLE_SALT_READS.items()
                       if ok)]) * 16

    def embed():
        return stt.embed_array(cover, secret, master_key=mk,
                               salt=salt).stego

    def extract(stego):
        assert stt.extract_array(stego, master_key=mk) == secret, \
            "payload recovery failed"

    extract(embed())                 # warm: walk expansion, cuFFT plans
    torch.cuda.synchronize()
    chip_smoke.phase_probe()
    stego = embed()
    torch.cuda.synchronize()
    names = {s[0] for s in stages}
    for name, fn in (("single_embed", embed),
                     ("single_extract", lambda: extract(stego))):
        walk_s.clear()
        _, busy, kernels, spans = _profile(name, fn, out, names)
        print(f"  host walk {sum(walk_s) * 1e3:10.3f} ms over "
              f"{len(walk_s)} calls (cached after the warm-up)")
        _print_stages(busy, kernels, spans)
    return 0


def _stage2_ops(covers, out: pathlib.Path) -> int:
    """--stage2: the embed's forward corner DFT alone, every kernel by its
    device time."""
    import torch

    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch.spectral import corner

    H, W = covers.shape[-2:]
    Ky, Kx = corner.corner_dims(H, W, stt.Params().rmax)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, covers.device)

    def fwd():
        corner.fwd_corner(covers, False, Ky, Kx, tabs, "mix_adaptive")

    fwd()
    torch.cuda.synchronize()
    _, busy, kernels, _ = _profile("stage2", fwd, out, set())
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True):
        print(f"  kernel {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<3d} {e.key[:100]}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    flags = {a for a in args if a in ("--stream", "--single", "--crop",
                                      "--stage2")}
    tree = [a.split("=", 1)[1] for a in args if a.startswith("--tree=")]
    args = [a for a in args if a not in flags and not a.startswith("--tree")]
    sys.path.insert(0, str(pathlib.Path(tree[0]).resolve() if tree else REPO))
    stream_mode = "--stream" in flags
    crop = "--crop" in flags
    out = pathlib.Path(args[0]) if args else REPO / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    if "--single" in flags:
        from steganosaurus_tpu_torch import _build, runtime

        runtime.configure_precision()
        _build.ensure_native()
        return single_image(out)
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck
    from steganosaurus_tpu_torch.spectral import write_kernels as wk

    # a tree before K5 has no read_kernels: its read stays in "other"
    rk = (importlib.import_module("steganosaurus_tpu_torch.spectral."
                                  "read_kernels")
          if importlib.util.find_spec("steganosaurus_tpu_torch.spectral."
                                      "read_kernels") else None)
    print(f"package: {pathlib.Path(stt.__file__).parent}")
    stages = [("stage1", ck, "fwd_stage1"), ("stage2 prep", ck, "stage2_prep"),
              ("topk", corner, "band_topk"), ("band", ck, "stage2_band"),
              ("K2", ck, "fwd_stage2"),
              ("stage2", corner, "_fwd_y_split"),
              ("write+floor", wk, "write_floor"), ("floor", wk, "floor_only"),
              ("ifft y", corner, "ifft_corner_y"),
              ("K4", wk, "ifft_epilogue"),
              ("ifft", corner, "ifft_corner_real"),
              ("epilogue", wk, "epilogue"),
              ("read+decode", rk, "read_decode")]
    stages = [s for s in stages if hasattr(s[1], s[2])]
    if "--stage2" not in flags:
        for name, mod, attr in stages:
            setattr(mod, attr, _span(name, getattr(mod, attr)))

    runtime.configure_precision()
    _build.ensure_native()
    dev = torch.device("cuda", 0)
    B, secret = chip_smoke.UHD_B, chip_smoke.UHD_SECRET
    base = chip_smoke.make_covers(chip_smoke.UHD_BASE, chip_smoke.UHD_H,
                                  chip_smoke.UHD_W)
    covers = torch.from_numpy(base).to(dev).permute(0, 3, 1, 2)
    covers = covers.repeat(-(-B // base.shape[0]), 1, 1, 1)[:B].contiguous()
    if crop:
        covers = covers[..., :chip_smoke.UHD_W - 1].contiguous()
    if "--stage2" in flags:
        chip_smoke.phase_probe()
        return _stage2_ops(covers, out)
    secrets = chip_smoke.secrets_for(B, secret)
    salts = [bytes([i]) * 16 for i in range(B)]
    mk = chip_smoke.MASTER_KEY

    def embed():
        return stt.embed_batch(covers, secrets, master_key=mk, salts=salts,
                               device_resident=True, layout="nchw").stego

    def extract(stego):
        got = stt.extract_batch(stego, master_key=mk, clen_hint=secret,
                                layout="nchw")
        assert got == secrets, "payload recovery failed"

    extract(embed())                 # warm: walk expansion, tables, library
    torch.cuda.synchronize()
    chip_smoke.phase_probe()
    names = {s[0] for s in stages}
    if stream_mode:
        def loop():
            for _ in range(2):
                extract(embed())

        def stream():
            embeds = stt.embed_stream(
                ((covers, secrets, salts) for _ in range(2)), master_key=mk,
                depth=2, layout="nchw")
            for got in stt.extract_stream((r.stego for r in embeds),
                                          master_key=mk, clen_hint=secret,
                                          depth=2, layout="nchw"):
                assert got == secrets, "payload recovery failed"

        stream()                     # warm the stream's own first use
        torch.cuda.synchronize()
        for name, fn in (("loop2", loop), ("stream2", stream),
                         ("stream2_again", stream), ("loop2_again", loop)):
            _profile(name, fn, out, names)
        return 0
    stego = embed()
    torch.cuda.synchronize()
    for name, fn in (("embed", embed), ("extract", lambda: extract(stego))):
        _, busy, kernels, spans = _profile(name, fn, out, names)
        _print_stages(busy, kernels, spans)
    for name, fn in (("embed", embed), ("extract", lambda: extract(stego))):
        peaks = _stage_peaks(fn)
        print(f"{name} peak device memory by stage (GiB, unprofiled pass): "
              + "; ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
