"""steganosaurus_tpu_torch — the PyTorch + CUDA port of steganosaurus_tpu.

The JAX package (steganosaurus_tpu/) is the reference; this package runs the
same single-image embed_array / extract_array (and the file-level embed /
extract), the same batch embed -> extract path with its serving surface,
the same `turtlefft` / `turtlefft-key` CLIs and `turtlefft serve` worker,
and the same warden and channel reports on an NVIDIA H100, in every wire
mode the JAX package writes (shared or per-image walks, hard or soft
write, jitter, alpha spread, QIM, Rep-7 or RS, padding, coherent,
adaptive alpha, cover-dependent walks; f64 under
Params(fft_dtype="complex128"), on the card or the CPU), and writes the
same wire format, so stegos cross-decode between the two in both
directions.

Layout follows the JAX package so each module's counterpart is easy to find:

- ``runtime``    device resolution, CUDA requirement, matmul precision,
                 host<->device copies that do not stall the stream.
- ``_build``     builds each ``csrc/*.cu`` with nvcc (sm_90a) and the host
                 native library (native/*.cc, g++) from the repository's own
                 sources.
- ``spectral/``  the full-grid FFT in the reference sign (torch.fft),
                 medians, cover hash features; corner pruned-DFT math;
                 ``corner_kernels`` wraps the hand-written stage-1 DFT
                 kernel (csrc/corner_stage1_wgmma.cu) for every width: A
                 by TMA where W % 16 == 0 on an aligned base, else by the
                 producer warpgroup's own loads.
- ``ops/``       MSB-first bit/word packing and repetition ECC on tensors;
                 the full-spectrum phase write and read rules (phase),
                 the exact median (stats), capacity (mask).
- ``parallel/``  the batch device cores: frame build, corner embed (shared
                 and per-image walks), fused extract, soft-decision retry,
                 raw-bit read; the full-grid cores of adaptive alpha; the
                 mesh (make_mesh, shard_batch: the pipeline's mesh= over
                 several cards or logical shards of one) and one image's
                 spectrum sharded across a mesh axis (fft_dist).
- ``pipeline/``  embed_array / extract_array over a torch backend (f32, or
                 f64 on a card) or the f64 host backend on the CPU
                 (device.py); the ECC frame (frame.py); header framing, spread
                 amplitudes and QIM dithers, the embed_batch /
                 extract_batch API with verify, ragged secrets, every wire
                 mode and channel_report, and the embed_stream /
                 extract_stream pipelining; ``serve`` the JSON-lines
                 serving worker.
- ``utils/``     PSNR, SSIM, BER and ecc_report; quality_device on the card;
                 the round trip's cost model, stage by stage (cost);
                 the reference's debug dumps (debug); the warden reports,
                 features and studies (steganalysis) and the channel reports
                 (channel: requantization noise, AWGN/JPEG robustness).
- ``cli``        the `turtlefft` CLI (gen-key, embed, extract, check,
                 batch-embed, batch-extract, serve; bin/turtlefft-torch),
                 on the card unless STEGANOSAURUS_PLATFORM=cpu.
- ``keytool``    the `turtlefft-key` tool (bin/turtlefft-key-torch).

- ``config``, ``crypto/``, ``keystream/``, ``_native_loader``, ``ops/rs``,
  ``io/image``, ``utils/debug``: the host modules, copied from the JAX
  package's modules of the same paths (Params, keys and AEAD, the two
  wrapped-key formats, the turtle walk — coherent sites too — and its disk
  cache, the native-library wrapper, RS(255,223), PNG load and save), so
  the wire format stays byte-identical (tests/test_torch_host.py,
  tests/test_torch_keys.py).

This package imports neither jax nor anything of steganosaurus_tpu.
"""

from steganosaurus_tpu_torch.config import Params

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): importing the package stays cheap and
# touches no device until a pipeline symbol is used.
_API = {
    "embed_array": ("steganosaurus_tpu_torch.pipeline.embed", "embed_array"),
    "extract_array": ("steganosaurus_tpu_torch.pipeline.extract",
                      "extract_array"),
    "embed": ("steganosaurus_tpu_torch.pipeline.embed", "embed"),
    "extract": ("steganosaurus_tpu_torch.pipeline.extract", "extract"),
    "embed_batch": ("steganosaurus_tpu_torch.pipeline.batch", "embed_batch"),
    "extract_batch": ("steganosaurus_tpu_torch.pipeline.batch",
                      "extract_batch"),
    "extract_dispatch": ("steganosaurus_tpu_torch.pipeline.batch",
                         "extract_dispatch"),
    "channel_report": ("steganosaurus_tpu_torch.pipeline.batch",
                       "channel_report"),
    "phase_histogram_report": ("steganosaurus_tpu_torch.utils.steganalysis",
                               "phase_histogram_report"),
    "pairwise_difference_report": (
        "steganosaurus_tpu_torch.utils.steganalysis",
        "pairwise_difference_report"),
    "magnitude_conditioned_report": (
        "steganosaurus_tpu_torch.utils.steganalysis",
        "magnitude_conditioned_report"),
    "requantization_noise_report": ("steganosaurus_tpu_torch.utils.channel",
                                    "requantization_noise_report"),
    "collusion_report": ("steganosaurus_tpu_torch.utils.steganalysis",
                         "collusion_report"),
    "srm_report": ("steganosaurus_tpu_torch.utils.steganalysis",
                   "srm_report"),
    "srm_study": ("steganosaurus_tpu_torch.utils.steganalysis", "srm_study"),
    "cross_channel_report": ("steganosaurus_tpu_torch.utils.steganalysis",
                             "cross_channel_report"),
    "cross_channel_study": ("steganosaurus_tpu_torch.utils.steganalysis",
                            "cross_channel_study"),
    "joint_residual_report": ("steganosaurus_tpu_torch.utils.steganalysis",
                              "joint_residual_report"),
    "joint_residual_study": ("steganosaurus_tpu_torch.utils.steganalysis",
                             "joint_residual_study"),
    "robustness_report": ("steganosaurus_tpu_torch.utils.channel",
                          "robustness_report"),
    "prefetch_walk": ("steganosaurus_tpu_torch.pipeline.batch",
                      "prefetch_walk"),
    "prefetch_piw_walks": ("steganosaurus_tpu_torch.pipeline.batch",
                           "prefetch_piw_walks"),
    "embed_stream": ("steganosaurus_tpu_torch.pipeline.stream",
                     "embed_stream"),
    "extract_stream": ("steganosaurus_tpu_torch.pipeline.stream",
                       "extract_stream"),
    "load_rgb_batches": ("steganosaurus_tpu_torch.pipeline.stream",
                         "load_rgb_batches"),
    "quality_device": ("steganosaurus_tpu_torch.utils.metrics",
                       "quality_device"),
    "StegoError": ("steganosaurus_tpu_torch.pipeline.errors", "StegoError"),
}


def __getattr__(name: str):
    try:
        mod, attr = _API[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    val = getattr(importlib.import_module(mod), attr)
    globals()[name] = val
    return val


__all__ = ["Params", "__version__", *_API]
