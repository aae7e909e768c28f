"""fwd_dft_roofline: the forward pruned corner DFT's share of its roofline,
both sides of a batch (the embed's and the extract's), in %.

Work, frozen at the cell's shapes under mix_adaptive (the arithmetic of
the program's utils/cost.py when this benchmark was made), per side of B
images, P = 3B planes of H x W into a Ky x Kx corner:
- stage 1, bf16 products: 2 * (P*H) * W * 2*Kx (cos and sin);
- stage 2, bf16 products: the bulk 8 * P * Ky * H * (Kx - 64) over the
  columns outside the 64-column band, and the band as six products of
  split bf16, 6 * 8 * P * 64 * H * Ky;
- elementwise, f32: 3 * P * H * Kx (the columns' energies, which pick the
  band).
Bytes: the group's inputs read once (the u8 planes, the x and y DFT
tables in bf16) and its output written once (the f32 corner, re and im);
what passes between its kernels is not counted, so the count holds for any
implementation. Bound: the larger of the products' time at each precision's
peak plus the elementwise time at the f32 peak, and the bytes at HBM
rate. Measured: the device time of the kernels whose names KERNELS matches
(stage 1, the stage-2 prep, band and K2); generic kernels between them,
such as torch.topk, are left to the breakdown.
"""

import re

KERNELS = re.compile(r"corner_stage1_(tma|ldg)_kernel|corner_stage2_prep_kernel"
                     r"|corner_stage2_band_kernel|corner_stage2_kernel")
BAND = 64


def side_work(s):
    """(bf16 FLOPs, f32 FLOPs, bytes) of one side's forward DFT."""
    P, H, W, Ky, Kx = 3 * s["B"], s["H"], s["W"], s["Ky"], s["Kx"]
    band = min(BAND, Kx)
    bf16 = (2.0 * P * H * W * 2 * Kx
            + 8.0 * P * Ky * H * (Kx - band)
            + 6 * 8.0 * P * band * H * Ky)
    f32 = 3.0 * P * H * Kx
    nbytes = P * H * W + 2 * Kx * W * 2 + 2 * Ky * H * 2 + 2 * P * Ky * Kx * 4
    return bf16, f32, nbytes


def read(run):
    t, s, peaks = run.trace, run.shape, run.peaks
    if t is None or peaks is None or s["precision"] != "mix_adaptive":
        return None
    busy = sum(d for name, _, d in t.device_ops if KERNELS.search(name))
    if busy <= 0 or not t.batches:
        return None
    bf16, f32, nbytes = side_work(s)
    bound = max(bf16 / peaks["bf16"] + f32 / peaks["fp32"],
                nbytes / peaks["hbm_bytes"])
    return 100.0 * 2 * t.batches * bound / (busy / 1e6)
