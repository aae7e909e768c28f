"""utils/cost.py of the port against the JAX package's, on the CPU.

The JAX cost model asks XLA to count the lowered modules; the port counts
stage by stage from the shapes its cores use. Held here: the geometry and
the link bytes equal JAX's, the same errors for the branches the model does
not cover, and the model's matrix-product FLOPs equal what
torch.utils.flop_counter counts while the two cores run (the port's
counterpart of JAX's "the counted module is the dispatched module"). The
ratio to XLA's counts is recorded, not asserted: XLA counts the elementwise
work too, and its own fusions.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.utils import cost as jcost
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.parallel import batch as pbatch
from steganosaurus_tpu_torch.utils import cost

torch.set_num_threads(2)

MK = bytes(range(32))
# the model's matrix-product FLOPs against torch's count of the same run
FLOP_REL = 0.01


def jp(p: Params) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _covers(B, H, W, rng):
    base = np.linspace(170, 225, W)
    return np.clip(base[None, None, None, :]
                   + rng.integers(-12, 13, (B, 3, H, W)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("H,W", [(128, 128), (384, 640), (1080, 1920),
                                 (2160, 3840), (1079, 1917)])
@pytest.mark.parametrize("secret_len,pad", [(40, 0), (16384, 0),
                                            (1000, 4096), (3, 64)])
def test_geometry_equals_jax(H, W, secret_len, pad):
    p = Params(pad_quantum=pad)
    assert cost._geometry(H, W, secret_len, p) == jcost._geometry(
        H, W, secret_len, jp(p))


@pytest.mark.parametrize("field", ["adaptive_alpha", "per_image_walk", "rs"])
def test_off_branch_params_raise_like_jax(field):
    p = Params(**{field: True})
    with pytest.raises(ValueError):
        jcost.roundtrip_cost(2, 128, 128, 40, params=jp(p))
    with pytest.raises(ValueError):
        cost.roundtrip_cost(2, 128, 128, 40, params=p)
    with pytest.raises(ValueError):
        cost._geometry(128, 128, 40, p)


@pytest.mark.parametrize("B,H,W,n", [(4, 128, 128, 40),
                                     (64, 2160, 3840, 16384)])
def test_link_and_ingest_bytes_equal_jax(B, H, W, n):
    rep = cost.roundtrip_cost(B, H, W, n)
    g = rep["geometry"]
    assert rep["link_bytes_per_image"] == 4 * (
        g["stream_words_per_image"] + g["hard_words_per_image"]) == (
        4 * (jcost._geometry(H, W, n, JParams())["stream_words_per_image"]
             + jcost._geometry(H, W, n, JParams())["hard_words_per_image"]))
    assert rep["ingest_bytes_per_image"] == 2 * 3 * H * W
    assert rep["roundtrip_flops_per_image"] == (
        rep["embed_flops"] + rep["extract_flops"]) / B
    sides = {s["side"] for s in rep["stages"]}
    assert sides == {"embed", "extract"}
    assert rep["embed_hbm_bytes"] == sum(
        s["hbm_bytes"] for s in rep["stages"] if s["side"] == "embed")


def test_headline_stage_flops():
    """The 4K B=64 sizing: K1 2 x 2 (192*2160) 3840 1024, stage 2's bulk
    and the inverse's y stage 8 * 192*1024*2160*1024 each, K2 the bulk over
    the 960 columns it keeps and six bf16 products of the 64-column band,
    its prep no product, the inverse's x stage the K1 count; the embed's
    products ~2.1e13, the extract's ~1.1e13, each the sum of its stages'."""
    rep = cost.roundtrip_cost(64, 2160, 3840, 16384)
    st = {(s["side"], s["stage"]): s["gemm_flops"] for s in rep["stages"]}
    k1 = 2 * 2 * (192 * 2160) * 3840 * 1024
    bulk = 8 * 192 * 1024 * 2160 * 1024
    assert st["embed", "K1"] == {"bf16": k1} == st["extract", "K1"]
    band = 8 * 192 * 64 * 2160 * 1024
    assert st["embed", "K2"] == {"bf16": bulk - band + 6 * band} == st[
        "extract", "K2"]
    assert st["embed", "stage2 prep"] == {} == st["extract", "stage2 prep"]
    assert st["embed", "stage2 band"] == {} == st["extract", "stage2 band"]
    assert st["embed", "K6 inverse y-stage"] == {"bf16": bulk}
    assert st["embed", "K4 inverse x-stage + epilogue"] == {"bf16": k1}
    gemm = {side: sum(sum(f.values()) for (sd, _), f in st.items()
                      if sd == side) for side in ("embed", "extract")}
    assert gemm["embed"] == 2 * k1 + 2 * bulk + 5 * band
    assert gemm["extract"] == k1 + bulk + 5 * band
    assert 2.1e13 < gemm["embed"] < 2.2e13
    assert cost.k1_cost(192, 2160, 3840, 1024)["gemm_flops"] == {"bf16": k1}


@pytest.mark.parametrize("qim", [0, 3])
def test_stage_bounds_and_the_round_trip_bound(qim):
    """The round trip's bound is the sum of its stages' bounds. The write
    and the floor are one K3 write_floor stage where the main path runs
    them so (the shared walk: the RepFrame's stream words in, the bf16
    operands of the inverse DFT out; 0.725 ms at 4K B=64 16 KB); under QIM
    the eager write and K3's floor_only stay two stages."""
    peaks = dict(bf16=989e12, tf32=495e12, fp32=67e12, hbm_bytes=3.35e12)
    p = Params(qim=qim)
    rep = cost.roundtrip_cost(64, 2160, 3840, 16384, params=p)
    b = cost.roundtrip_bound(rep, peaks)
    ms = {(sd, st): (m, by) for sd, st, m, by in b["stages"]}
    k1 = 2 * 2 * (192 * 2160) * 3840 * 1024
    assert ms["embed", "K1"] == (k1 / 989e12 * 1e3, "operations")
    g = rep["geometry"]
    if qim:
        assert ms["embed", "write"][1] == "bytes"
        assert ms["embed", "K3 floor"] == cost.stage_bound(
            cost.floor_only_cost(64, 1024, 1024), peaks)
        assert ("embed", "K3 write + floor") not in ms
    else:
        k3 = cost.write_floor_cost(64, 1024, 1024, g["bucket"], 0,
                                   out_bytes=2,
                                   stream_bytes=g["stream_bytes"])
        assert ms["embed", "K3 write + floor"] == cost.stage_bound(k3, peaks)
        assert ms["embed", "K3 write + floor"] == pytest.approx(
            (0.725, "bytes"), abs=1e-3)
        assert ("embed", "write") not in ms and ("embed", "floor") not in ms
    assert b["roundtrip_ms"] == pytest.approx(
        sum(m for _, _, m, _ in b["stages"]))
    assert b["roundtrip_ms"] == b["embed_ms"] + b["extract_ms"]


def test_peak_rates_refuse_what_they_do_not_know():
    with pytest.raises(ValueError):
        cost.peak_rates("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        cost.peak_rates()


def _counted(monkeypatch) -> dict:
    """Run the two cores under FlopCounterMode, each alone."""
    counts = {}
    for name in ("corner_embed_core", "corner_extract_fused_core"):
        real = getattr(pbatch, name)

        def counted(*a, _real=real, _name=name, **kw):
            with FlopCounterMode(display=False) as fc:
                out = _real(*a, **kw)
            counts[_name] = fc.get_total_flops()
            return out

        monkeypatch.setattr(pbatch, name, counted)
    return counts


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_model_flops_are_torchs_count_of_the_cores(monkeypatch, layout,
                                                   record_property):
    B, H, W, n = 4, 128, 128, 40
    rng = np.random.default_rng(0)
    covers = torch.from_numpy(_covers(B, H, W, rng))
    if layout == "nhwc":
        covers = covers.permute(0, 2, 3, 1).contiguous()
    counts = _counted(monkeypatch)
    cost.measure_device_step(covers, MK, n, layout=layout, reps=1)
    rep = cost.roundtrip_cost(B, H, W, n, layout=layout)
    # the model counts K2 as the card runs it: the bulk over the columns
    # it keeps and the band's six bf16 products; the CPU path
    # (corner._fwd_y_split) runs the bulk over every column and the band
    # once, in f32
    Ky, Kx = rep["geometry"]["Ky"], rep["geometry"]["Kx"]
    band = 8 * 3 * B * 64 * H * Ky
    assert Kx > 64
    gemm = {side: sum(sum(s["gemm_flops"].values()) for s in rep["stages"]
                      if s["side"] == side) - 4 * band
            for side in ("embed", "extract")}
    assert counts["corner_embed_core"] == pytest.approx(gemm["embed"],
                                                        rel=FLOP_REL)
    assert counts["corner_extract_fused_core"] == pytest.approx(
        gemm["extract"], rel=FLOP_REL)
    # recorded only: XLA's counts of JAX's modules at the same shapes
    jrep = jcost.roundtrip_cost(B, H, W, n, layout=layout)
    for side in ("embed", "extract"):
        ratio = rep[f"{side}_flops"] / jrep[f"{side}_flops"]
        record_property(f"{side}_flops_over_xla", ratio)
        print(f"{layout} {side}: model {rep[side + '_flops']:.4g}, XLA "
              f"{jrep[side + '_flops']:.4g}, ratio {ratio:.3f}")


def test_measure_device_step_and_link_smoke():
    rng = np.random.default_rng(1)
    covers = torch.from_numpy(_covers(2, 128, 128, rng))
    d = cost.measure_device_step(covers, MK, 40, reps=1)
    assert d["embed_s"] > 0 and d["extract_s"] > 0
    assert d["device_roundtrip_s"] == d["embed_s"] + d["extract_s"]
    assert d["batch"] == 2 and d["device"] == "cpu"
    link = cost.measure_link(nbytes=1 << 20, reps=1, device="cpu")
    assert link["up_bytes_per_sec"] > 0 and link["down_bytes_per_sec"] > 0
    assert link["probe_bytes"] == 1 << 20 and link["device"] == "cpu"
    assert cost.min_over(2, lambda: None) >= 0


@pytest.mark.parametrize("B,Ky,Kx,bucket,n_maps", [
    (64, 1024, 1024, 921600, 0), (8, 512, 512, 131072, 2),
    (1, 256, 256, 8192, 4)])
def test_write_floor_cost_counts_the_output_width(B, Ky, Kx, bucket, n_maps):
    """K3's bytes with the inverse DFT's bf16 operands stored (2 B a value)
    are the f32 count less 2 B for each of the 2E outputs, whatever the
    maps; its operations do not change. stage_costs counts the write and
    the floor as the one K3 launch the main path runs (stream words in,
    bf16 operands out: 0.725 ms), so the round trip's bound at the
    headline is 36.97 ms: 36.82 when the read counted 4 bytes a gathered
    slot in place of the 32-byte sectors the walk touches (0.078 ms for
    the read and decode against 0.233); 42.23 with the inverse DFT and K4e counted
    apart, less the 2.73 ms that their f32 product t cost before K4 fused
    them; 38.52 with stage 2 as the prep pass (1.52 ms, bytes), the band
    operand (0.16 ms, bytes) and K2 (4.62 ms, its band in split bf16 on
    the tensor cores) in place of 6.78 ms with an f32 band; less the eager
    write's 0.987 ms and the floor's 1.442 ms over an f32 delta, plus
    K3's 0.725 ms."""
    E = 3 * B * Ky * Kx
    f32 = cost.write_floor_cost(B, Ky, Kx, bucket, n_maps)
    b16 = cost.write_floor_cost(B, Ky, Kx, bucket, n_maps, out_bytes=2)
    assert f32 == cost.write_floor_cost(B, Ky, Kx, bucket, n_maps,
                                        out_bytes=4)
    assert f32["hbm_bytes"] - b16["hbm_bytes"] == 2 * E * 2
    assert b16["hbm_bytes"] == 2 * E * 4 + 3 * Ky * Kx * (4 + 4 * n_maps) \
        + B * bucket + 2 * E * 2
    assert b16["elementwise_flops"] == f32["elementwise_flops"]
    stages = {s["stage"] for s in cost.stage_costs(64, 2160, 3840, 16384)}
    assert "K3 write + floor" in stages
    assert not {"write", "floor"} & stages
    peaks = dict(cost._PEAKS[0][1])
    rep = cost.roundtrip_cost(64, 2160, 3840, 16384)
    assert cost.roundtrip_bound(rep, peaks)["roundtrip_ms"] == \
        pytest.approx(36.97, abs=0.01)


def test_ifft_epilogue_cost_and_the_split_inverse(monkeypatch):
    """K4 at 4K B=64: 2 * (192*2160) * 2048 * 3840 bf16 FLOPs (the K1
    count), mr and mi (1.70e9 B), the table, the planes and the stego once:
    4.90e9 B, bound by its products (6.596 ms at 989 TFLOP/s, 6.714 with
    the epilogue's estimate at the fp32 rate). K6, the y-stage: 8 * 192 *
    2160 * 1024 * 1024 bf16 FLOPs against the bf16 delta, the (2Hp, 2Kyp)
    table and the bf16 mr, mi once (2.52e9 B): 3.518 ms, bound by its
    products. Under mix_adaptive the stage table's inverse is K6 and K4;
    under highest the f32 inverse and K4e's epilogue, as before K4."""
    peaks = dict(cost._PEAKS[0][1])
    k4 = cost.ifft_epilogue_cost(64, 2160, 3840, 1024)
    M = 192 * 2160
    assert k4["gemm_flops"] == {"bf16": 2 * M * 2048 * 3840}
    assert k4["hbm_bytes"] == 2 * M * 1024 * 2 + 2 * 1024 * 3840 * 2 \
        + 2 * M * 3840
    assert cost.ifft_epilogue_cost(64, 2160, 3840, 1024, "nhwc") == k4
    ms, by = cost.stage_bound(k4, peaks)
    assert by == "operations" and ms == pytest.approx(6.714, abs=1e-3)
    y = cost.ifft_y_cost(64, 2160, 1024, 1024)
    assert y["gemm_flops"] == {"bf16": 8 * 192 * 2160 * 1024 * 1024}
    assert y["hbm_bytes"] == 2 * 192 * 1024 * 1024 * 2 \
        + (2 * 2176) * (2 * 1024) * 2 + 2 * 192 * 2160 * 1024 * 2
    assert cost.stage_bound(y, peaks) == pytest.approx((3.518, "operations"),
                                                        abs=1e-3)
    with pytest.raises(ValueError):
        cost.ifft_epilogue_cost(1, 8, 8, 8, "hwc")
    names = [s["stage"] for s in cost.stage_costs(64, 2160, 3840, 16384)
             if s["side"] == "embed"]
    assert names[-2:] == ["K6 inverse y-stage",
                          "K4 inverse x-stage + epilogue"]
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", "highest")
    names = [s["stage"] for s in cost.stage_costs(64, 2160, 3840, 16384)
             if s["side"] == "embed"]
    assert names[-2:] == ["inverse", "epilogue"]


@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_read_decode_cost_counts_the_sectors_the_walk_touches(jitter):
    """K5 at 4K B=64 16 KB: the 921,600-slot walk covers 29.3% of the 3 x
    1024 x 1024 corner bins, so a uniform walk touches 1 - (1 - 0.293)^8 =
    93.8% of the Im plane's 32-byte sectors: 755 MB over the batch, with
    the walk's read plan (int32 slot ids and int16 offsets) and the hard
    and soft words: 0.228 ms, bound by its bytes (Re C's sectors too under
    jitter, and the jitter's cos and sin). walk_sectors counts a real walk's sectors: on a uniform
    draw of distinct bins it lands within 1% of sector_share's."""
    peaks = dict(cost._PEAKS[0][1])
    p = Params(jitter=jitter)
    g = cost.stage_costs(64, 2160, 3840, 16384, params=p)
    st = {s["stage"]: s for s in g if s["side"] == "extract"}
    n, E = 921600, 3 * 1024 * 1024
    share = cost.sector_share(n, 1024, 1024)
    assert share == pytest.approx(1 - (1 - n / E) ** 8)
    assert share == pytest.approx(0.9376, abs=1e-4)
    words = 2 * (10 + 4111)
    planes = 2 if jitter else 1
    want = (64 * planes * share * E / 8 * 32 + 6 * n
            + (2 * n * 4 if jitter else 0) + 64 * words * 4)
    assert st["read + decode"]["hbm_bytes"] == pytest.approx(want)
    assert st["read + decode"] == cost.read_decode_cost(
        64, 1024, 1024, n, words, planes=planes, jitter=bool(jitter))
    ms, by = cost.stage_bound(st["read + decode"], peaks)
    assert by == "bytes"
    if not jitter:
        assert ms == pytest.approx(0.2277, abs=1e-3)
    rng = np.random.default_rng(3)
    Ky = Kx = 64
    m = 3 * Ky * Kx * 3 // 10
    flat = torch.from_numpy(rng.choice(3 * Ky * Kx, m, replace=False))
    got = cost.walk_sectors(flat // (Ky * Kx), flat // Kx % Ky, flat % Kx,
                            Ky, Kx)
    assert got / (3 * Ky * Kx / 8) == pytest.approx(
        cost.sector_share(m, Ky, Kx), rel=0.01)
    assert cost.walk_sectors(*(torch.zeros(5, dtype=torch.int64),) * 3,
                             Ky, Kx) == 1


@pytest.mark.parametrize("band", [0, 64, 1024])
def test_k2_cost_by_band_width(band):
    """K2 at 4K B=64 (P = 192, H = 2160, Ky = Kx = 1024) with a band of
    nb = 0, 1 and Kx/64 groups: the bulk's four bf16 products over the
    Kx - band columns it keeps, six split-bf16 products over the band's;
    bytes: the bf16 copies only where there is a bulk, the band operand's
    three terms, the table's terms read (T0 alone without a band), cr and
    ci in f32. The band pass moves the band columns' f32 values and terms
    and the mask."""
    P, H, Ky, Kx = 192, 2160, 1024, 1024
    k2 = cost.k2_cost(P, H, Ky, Kx, band=band)
    assert k2["gemm_flops"] == {"bf16": 8 * P * Ky * H * (Kx - band)
                                + 6 * 8 * P * band * H * Ky}
    assert k2["hbm_bytes"] == ((2 * P * H * Kx * 2 if band < Kx else 0)
                               + 6 * P * H * band * 2
                               + (3 if band else 1) * 2 * Ky * 2 * H * 2
                               + 2 * P * Ky * Kx * 4)
    assert cost.k2_cost(P, H, Ky, Kx, band=2048) == cost.k2_cost(
        P, H, Ky, Kx, band=Kx)
    if band == 64:
        assert k2 == cost.k2_cost(P, H, Ky, Kx)
    b = cost.stage2_band_cost(P, H, Kx, band=band)
    assert b["gemm_flops"] == {} and b["hbm_bytes"] == (
        2 * P * H * band * 4 + 6 * P * H * band * 2 + P * Kx // 32 * 4)


# the stages of each mode's embed at 4K B=64 16 KB after K1, the forward
# stage 2 and K3, and its forward stage 2's stages
MODE_STAGES = {
    "mix_adaptive": (["K6 inverse y-stage", "K4 inverse x-stage + epilogue"],
                     ["stage2 prep", "stage2 band", "K2"]),
    "mix_split": (["K6 inverse y-stage", "K4 inverse x-stage + epilogue"],
                  ["stage2 prep", "stage2 band", "K2"]),
    "mix": (["K6 inverse y-stage", "K4 inverse x-stage + epilogue"],
            ["stage2 band", "K2"]),
    "mix3": (["K6 inverse y-stage", "K4 inverse x-stage + epilogue"],
             ["stage2 band", "K2"]),
    "mix2": (["inverse y-stage", "cast", "K4 inverse x-stage + epilogue"],
             ["stage2 band", "K2"]),
    "mix_conservative": (["inverse", "epilogue"], ["stage2 band", "K2"]),
    "bf16": (["K6 inverse y-stage", "K4 inverse x-stage + epilogue"],
             ["stage2 prep", "K2"]),
    "high": (["inverse", "epilogue"], ["stage2 band", "K2"]),
    "highest": (["inverse", "epilogue"], ["stage2"]),
}


@pytest.mark.parametrize("name", list(MODE_STAGES))
def test_stage_costs_per_precision_mode(name, monkeypatch):
    """Each mode's stage table at 4K B=64 16 KB counts every stage at its
    precision: K1 in bf16 (f32 under high and highest); K2's band of 64
    columns (mix_adaptive, mix_split), every column (the HIGH modes: no
    prep) or none (bf16: no band pass); the f32 stages exactly (forward
    stage 2 under highest 8 P Ky H Kx, the inverse's y-stage 8 P H Ky Kx,
    its x-stage 4 P H Kx W) at the fp32 rate; K3's output bf16 only where
    the y-stage is bf16. Every mode has a round-trip bound."""
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", name)
    P, H, W, Ky, Kx = 192, 2160, 3840, 1024, 1024
    stages = cost.stage_costs(64, H, W, 16384)
    embed = [s for s in stages if s["side"] == "embed"]
    extract = [s for s in stages if s["side"] == "extract"]
    inverse, fwd2 = MODE_STAGES[name]
    assert [s["stage"] for s in embed] == ["K1", *fwd2, "K3 write + floor",
                                           *inverse]
    assert [s["stage"] for s in extract] == ["K1", *fwd2, "read + decode"]
    k1 = 2 * 2 * (P * H) * W * Kx
    f32 = name in ("high", "highest")
    assert embed[0]["gemm_flops"] == {"fp32" if f32 else "bf16": k1}
    assert embed[0] == cost.k1_cost(P, H, W, Kx, "embed",
                                    "fp32" if f32 else "bf16")
    band = {"mix_adaptive": 64, "mix_split": 64, "bf16": 0}.get(name, Kx)
    st = {s["stage"]: s for s in embed}
    if name == "highest":
        assert st["stage2"]["gemm_flops"] == {"fp32": 8 * P * Ky * H * Kx}
    else:
        assert st["K2"] == cost.k2_cost(P, H, Ky, Kx, "embed", band)
    y = 8 * P * H * Ky * Kx
    x = 4 * P * H * Kx * W
    assert cost.ifft_y_f32_cost(64, H, Ky, Kx)["gemm_flops"] == {"fp32": y}
    assert cost.ifft_x_f32_cost(64, H, W, Kx)["gemm_flops"] == {"fp32": x}
    assert cost.ifft_x_f32_cost(64, H, W, Kx)["hbm_bytes"] == (
        2 * P * H * Kx * 4 + 2 * Kx * W * 4 + P * H * W * 4)
    if "inverse" in st:
        assert st["inverse"]["gemm_flops"] == {"fp32": y + x}
    if "inverse y-stage" in st:
        assert st["inverse y-stage"] == cost.ifft_y_f32_cost(64, H, Ky, Kx)
        assert st["cast"]["hbm_bytes"] == 2 * P * H * Kx * (4 + 2)
    y16 = name in ("mix_adaptive", "mix_split", "mix", "mix3", "bf16")
    g = cost._geometry(H, W, 16384, Params())
    assert st["K3 write + floor"] == cost.write_floor_cost(
        64, Ky, Kx, g["bucket"], 0, out_bytes=2 if y16 else 4,
        stream_bytes=g["stream_bytes"])
    peaks = dict(cost._PEAKS[0][1])
    b = cost.roundtrip_bound(cost.roundtrip_cost(64, H, W, 16384), peaks)
    assert b["roundtrip_ms"] > 0
    if name == "high":   # stage 1 at 67 TFLOP/s: >= 97 ms a side
        assert dict(((sd, s), ms) for sd, s, ms, _ in b["stages"])[
            "embed", "K1"] == pytest.approx(k1 / 67e12 * 1e3)
        assert k1 / 67e12 * 1e3 > 97
