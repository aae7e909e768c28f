"""The work counts frozen in the roofline readers equal the program's
utils/cost.py at each cell's shapes (compared here only: the readers never
import the program), and the corner the harness computes is the program's."""

import json
import pathlib

import pytest

from turtlebench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _reader_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"tb_{name}", REPO / "turtlebench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", CELLS)
def test_corner_dims_match_the_program(cell):
    from steganosaurus_tpu_torch.spectral import corner

    s = harness.shape_of(harness.load_cell(BENCH, REPO, cell))
    assert (s["Ky"], s["Kx"]) == corner.corner_dims(s["H"], s["W"], 0.45)


@pytest.mark.parametrize("cell", CELLS)
def test_forward_dft_flops_match_cost_py(cell):
    from steganosaurus_tpu_torch.utils import cost

    s = harness.shape_of(harness.load_cell(BENCH, REPO, cell))
    P = 3 * s["B"]
    bf16, f32, _ = _reader_module("fwd_dft_roofline").side_work(s)
    k1 = cost.k1_cost(P, s["H"], s["W"], s["Kx"])
    k2 = cost.k2_cost(P, s["H"], s["Ky"], s["Kx"])
    prep = cost.stage2_prep_cost(P, s["H"], s["Kx"])
    assert bf16 == k1["gemm_flops"]["bf16"] + k2["gemm_flops"]["bf16"]
    assert f32 == prep["elementwise_flops"]


@pytest.mark.parametrize("cell", CELLS)
def test_inverse_flops_match_cost_py(cell):
    from steganosaurus_tpu_torch.utils import cost

    s = harness.shape_of(harness.load_cell(BENCH, REPO, cell))
    B, H, W, Ky, Kx = s["B"], s["H"], s["W"], s["Ky"], s["Kx"]
    bf16, f32, _ = _reader_module("inv_dft_roofline").embed_work(s)
    k6 = cost.ifft_y_cost(B, H, Ky, Kx)
    k4 = cost.ifft_epilogue_cost(B, H, W, Kx)
    k3 = cost.write_floor_cost(B, Ky, Kx, 4096, 0, out_bytes=2,
                               stream_bytes=38 + s["secret_bytes"] + 16)
    assert bf16 == k6["gemm_flops"]["bf16"] + k4["gemm_flops"]["bf16"]
    assert f32 == k3["elementwise_flops"] + k4["elementwise_flops"]


@pytest.mark.parametrize("cell", CELLS)
def test_group_bytes_are_inputs_once_and_outputs_once(cell):
    """The groups' bytes sit under the sum of the program's stage bytes
    (which count the intermediates between the kernels) and over the
    images alone."""
    from steganosaurus_tpu_torch.utils import cost

    s = harness.shape_of(harness.load_cell(BENCH, REPO, cell))
    B, H, W, Ky, Kx = s["B"], s["H"], s["W"], s["Ky"], s["Kx"]
    P = 3 * B
    _, _, fwd = _reader_module("fwd_dft_roofline").side_work(s)
    stages = (cost.k1_cost(P, H, W, Kx), cost.stage2_prep_cost(P, H, Kx),
              cost.stage2_band_cost(P, H, Kx), cost.k2_cost(P, H, Ky, Kx))
    assert P * H * W < fwd < sum(st["hbm_bytes"] for st in stages)
    _, _, inv = _reader_module("inv_dft_roofline").embed_work(s)
    stages = (cost.write_floor_cost(B, Ky, Kx, 4096, 0, out_bytes=2),
              cost.ifft_y_cost(B, H, Ky, Kx),
              cost.ifft_epilogue_cost(B, H, W, Kx))
    assert 2 * P * H * W < inv < sum(st["hbm_bytes"] for st in stages)
