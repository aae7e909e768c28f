"""The port's warden and channel reports (steganosaurus_tpu_torch/utils/
steganalysis.py and utils/channel.py) against the JAX package's on the CPU.

The reports and features are the same numpy code on the same image, so on
one stego (written by the JAX package) they are compared exactly.
requantization_noise_report runs on each package's own f64 NumpyBackend,
frame, walk and keys: every field equal. robustness_report embeds, adds
AWGN, re-encodes as JPEG and reads back through each package's own
pipeline (f64 on the host under Params(fft_dtype="complex128"), f32
otherwise): every field equal on the 128x128 cover in both. The three
studies embed through each
package's own embed_batch (the port: device="cpu"); the f32 write rounds
some pixels the other way (+-1), which moves the features and so the
held-out AUC; on 8 pairs a fold of 2 test pairs scores in steps of 1/4,
and the mean AUC over 4 folds is held within 0.125 of JAX's per family.
"""

import dataclasses

import numpy as np
import pytest
import torch

from steganosaurus_tpu.config import Params as JParams
from steganosaurus_tpu.pipeline.embed import embed_array as jembed
from steganosaurus_tpu.utils import channel as jchannel
from steganosaurus_tpu.utils import steganalysis as jsa
from steganosaurus_tpu_torch.config import Params
from steganosaurus_tpu_torch.utils import channel as tchannel
from steganosaurus_tpu_torch.utils import steganalysis as tsa

torch.set_num_threads(2)

MK = bytes(range(32))
SECRET = b"warden report secret"
HW = (128, 160)


def jp(p: Params) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _cover(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.linspace(150, 225, HW[1])[None, :, None]
    return np.clip(base + rng.integers(-20, 21, (*HW, 3)), 0,
                   255).astype(np.uint8)


_CACHE: dict = {}


def _stegos():
    """Three covers and their JAX stegos under one key (shared walk)."""
    if not _CACHE:
        covers = [_cover(s) for s in (1, 2, 3)]
        p = JParams(pbkdf2_iter=500)
        stegos = [np.asarray(jembed(c, SECRET, master_key=MK, params=p,
                                    salt=bytes([i]) * 16).stego)
                  for i, c in enumerate(covers)]
        _CACHE["v"] = (covers, stegos)
    return _CACHE["v"]


def _equal(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


REPORTS = {
    "annulus_phases": lambda m, c, s: m.annulus_phases(s[0]),
    "phase_histogram": lambda m, c, s: m.phase_histogram_report(s[0]),
    "phase_histogram_spread": lambda m, c, s: m.phase_histogram_report(
        s[0], Params(alpha_spread=0.5), bins=64, window=0.1,
        phases=m.annulus_phases(s[0])),
    "pairwise_difference": lambda m, c, s: m.pairwise_difference_report(
        s[0], s[1]),
    "collusion": lambda m, c, s: m.collusion_report(s),
    "magnitude_conditioned": lambda m, c, s: m.magnitude_conditioned_report(
        s[0]),
    "cross_channel": lambda m, c, s: m.cross_channel_report(s[0]),
    "cross_channel_paired": lambda m, c, s: m.cross_channel_report(
        s[0], cover=c[0]),
    "cross_channel_features": lambda m, c, s: m.cross_channel_features(s[0]),
    "joint_residual": lambda m, c, s: m.joint_residual_report(s[0]),
    "joint_residual_paired": lambda m, c, s: m.joint_residual_report(
        s[0], cover=c[0]),
    "joint_residual_features": lambda m, c, s: m.joint_residual_features(
        s[0]),
    "srm_features": lambda m, c, s: m.srm_features(s[0]),
    "srm_report": lambda m, c, s: m.srm_report(*_srm_pairs(), folds=3),
}


def _srm_pairs():
    """8 same-source covers and a +-1 pixel-noise "stego" of each: enough
    pairs for the FLD of each fold to be trained."""
    covers = jsa.srm_corpus(8, (64, 96), 5, kind="texture")
    rng = np.random.default_rng(6)
    noisy = covers.astype(np.int16) + rng.integers(-1, 2, covers.shape)
    return covers, np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_equal_to_jax(name):
    covers, stegos = _stegos()
    _equal(REPORTS[name](tsa, covers, stegos),
           REPORTS[name](jsa, covers, stegos))


def test_params_defaults_are_the_ports():
    """The reports take the port's own Params (default arguments too)."""
    assert isinstance(tsa.phase_histogram_report.__defaults__[0], Params)


@pytest.mark.parametrize("kind", ["gradient", "texture", "photo"])
def test_srm_corpus_equal_to_jax(kind):
    np.testing.assert_array_equal(tsa.srm_corpus(3, (64, 96), 7, kind),
                                  jsa.srm_corpus(3, (64, 96), 7, kind))


@pytest.mark.parametrize("kw", [{}, {"qim": 3}, {"rs": True},
                                {"jitter": 0.2, "alpha_spread": 0.5}],
                         ids=["default", "qim", "rs", "jitter_spread"])
def test_requantization_noise_report_equal_to_jax(kw):
    p = Params(pbkdf2_iter=500, **kw)
    cover = _cover(9)[:128, :128]
    got = tchannel.requantization_noise_report(cover, SECRET, master_key=MK,
                                               params=p)
    want = jchannel.requantization_noise_report(cover, SECRET,
                                                master_key=MK, params=jp(p))
    assert got == want


def test_requantization_noise_report_refuses_per_image_walks():
    from steganosaurus_tpu_torch.pipeline.errors import StegoError

    with pytest.raises(StegoError, match="shared-walk"):
        tchannel.requantization_noise_report(
            _cover(9), SECRET, master_key=MK,
            params=Params(per_image_walk=True))


@pytest.mark.parametrize("fft_dtype", ["complex128", "complex64"])
def test_robustness_report_matches_jax(fft_dtype):
    p = Params(pbkdf2_iter=500, fft_dtype=fft_dtype)
    cover = _cover(10)[:128, :128]
    got = tchannel.robustness_report(cover, SECRET, params=p, master_key=MK,
                                     noise_sigmas=(0.5, 2.0, 8.0),
                                     device="cpu")
    want = jchannel.robustness_report(cover, SECRET, params=jp(p),
                                      master_key=MK,
                                      noise_sigmas=(0.5, 2.0, 8.0))
    assert got == want
    assert len(got["awgn"]) == 3 and len(got["jpeg"]) == 2
    assert got["awgn"][0]["recovered"]  # sigma 0.5 reads back


@pytest.mark.parametrize("study", ["srm_study", "cross_channel_study",
                                   "joint_residual_study"])
def test_study_auc_within_tolerance_of_jax(study):
    kw = dict(secret_bytes=60, n=8, hw=(128, 128), master_key=MK)
    p = Params(pbkdf2_iter=500)
    got = getattr(tsa, study)(p, device="cpu", **kw)
    want = getattr(jsa, study)(jp(p), **kw)
    assert got["params"] == want["params"]
    assert set(got["families"]) == {"gradient", "texture", "photo"}
    for fam, w in want["families"].items():
        g = got["families"][fam]
        assert (g["n_pairs"], g["feature_dim"], g["folds"]) == \
            (w["n_pairs"], w["feature_dim"], w["folds"])
        assert abs(g["auc"] - w["auc"]) <= 0.125, (fam, g, w)
