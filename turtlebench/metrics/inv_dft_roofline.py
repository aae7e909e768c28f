"""inv_dft_roofline: the embed's write, write floor and inverse pruned
corner DFT with its u8 epilogue as one group's share of its roofline, in %.

Work, frozen at the cell's shapes under mix_adaptive (the arithmetic of
the program's utils/cost.py when this benchmark was made), per embed of B
images, P = 3B planes, E = P * Ky * Kx corner bins:
- elementwise, f32: 14 * E for the phase write and 30 * E for the write
  floor (hand counts), and 5 per pixel, 5 * P * H * W, for the epilogue
  (scale, + cover, + 0.5, floor, clamp);
- the inverse y-stage, bf16 products: 8 * P * H * Ky * Kx;
- the inverse x-stage, bf16 products: 2 * (P*H) * 2*Kx * W.
Bytes: the group's inputs read once (the f32 corner, re and im; the
walk's bins as int32; each image's sealed stream; the u8 cover planes; the
y and x DFT tables in bf16) and its output written once (the u8 stego).
Bound and measured as in fwd_dft_roofline: the kernels KERNELS matches are
the write and floor (its resident schedule, or partials, boost and apply),
the inverse y-stage and the x-stage with the epilogue.
"""

import re

KERNELS = re.compile(r"\(anonymous namespace\)::"
                     r"(resident|partials|boost|apply)_kernel"
                     r"|corner_ifft_y_kernel|corner_ifft_(nchw|nhwc)_kernel")


def embed_work(s):
    """(bf16 FLOPs, f32 FLOPs, bytes) of one embed's write and inverse."""
    B, H, W, Ky, Kx = s["B"], s["H"], s["W"], s["Ky"], s["Kx"]
    P, E = 3 * B, 3 * B * Ky * Kx
    bf16 = 8.0 * P * H * Ky * Kx + 2.0 * P * H * 2 * Kx * W
    f32 = 44.0 * E + 5.0 * P * H * W
    stream = 38 + s["secret_bytes"] + 16
    nbytes = (2 * E * 4 + 4 * s["slots"] + B * stream + P * H * W
              + 2 * Ky * H * 2 + 2 * Kx * W * 2 + P * H * W)
    return bf16, f32, nbytes


def read(run):
    t, s, peaks = run.trace, run.shape, run.peaks
    if t is None or peaks is None or s["precision"] != "mix_adaptive":
        return None
    busy = sum(d for name, _, d in t.device_ops if KERNELS.search(name))
    if busy <= 0 or not t.batches:
        return None
    bf16, f32, nbytes = embed_work(s)
    bound = max(bf16 / peaks["bf16"] + f32 / peaks["fp32"],
                nbytes / peaks["hbm_bytes"])
    return 100.0 * t.batches * bound / (busy / 1e6)
