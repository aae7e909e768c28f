"""Warden-side self-check: phase-residual histogram analysis (the port's
copy of steganosaurus_tpu/utils/steganalysis.py: the reports and features
are the same numpy, equal to the JAX package's on the same image,
tests/test_torch_steganalysis.py; the *_study functions embed through the
port's embed_batch / embed_array on the `device` they are given).

Quantifies the scheme's primary statistical signature (doc/ATTACKS.md §2)
from a STEGO IMAGE ALONE — no cover, no key: natural-image phases over the
walk annulus are near-uniform on (-pi, pi], while the hard write
concentrates the footprint's mass exactly at +-alpha. This module measures
(a) a chi-square uniformity statistic over the annulus phase histogram and
(b) the excess mass in a narrow window around +-alpha, so users can check
what a histogram-based warden would see for their actual covers/params —
and verify that the mitigations (--alpha_spread, --jitter; ATTACKS §2a/§3)
actually flatten the signature on their data.

Pure numpy reporting tool (host-side, like utils.metrics).
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_tpu_torch.config import Params


def _annulus_spectrum(img: np.ndarray, params: Params
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(phases, magnitudes) of the walk-eligible annulus bins (primary
    half), from the stego alone. Uses the same eligibility predicate as the
    turtle walk (keystream/_pure.py: axis/DC exclusion + radius band on raw
    indices) so the measured population is exactly the attackable one."""
    H, W = img.shape[:2]
    planes = img.astype(np.float64).transpose(2, 0, 1)
    spec = np.conj(np.fft.fft2(planes))  # reference forward convention
    rlo = params.rmin * min(H, W)
    rhi = params.rmax * min(H, W)
    yy = np.arange(H)[:, None]
    xx = np.arange(W)[None, :]
    r = np.hypot(yy, xx)
    mask = (r >= rlo) & (r <= rhi) & (yy > 0) & (xx > 0)
    if H % 2 == 0:
        mask &= yy != H // 2
    if W % 2 == 0:
        mask &= xx != W // 2
    vals = spec[:, mask].ravel()
    return np.angle(vals), np.abs(vals)


def _annulus_phases(img: np.ndarray, params: Params) -> np.ndarray:
    return _annulus_spectrum(img, params)[0]


def annulus_phases(img: np.ndarray, params: Params = Params()) -> np.ndarray:
    """Public precompute hook: the walk-annulus phase population of `img`
    (3 planes concatenated). Callers running several wardens on the same
    image compute this once and pass it via the reports' `phases=` kwarg
    to skip the redundant full-image FFTs."""
    return _annulus_phases(img, params)


def phase_histogram_report(img: np.ndarray, params: Params = Params(),
                           bins: int = 256, window: float = 0.05,
                           phases: np.ndarray | None = None) -> dict:
    """Histogram-warden statistics for one image.

    Returns:
      n: annulus phase population size (3 planes).
      chi2_z: normalized chi-square uniformity statistic over `bins`
        histogram bins — (chi2 - dof)/sqrt(2*dof), ~N(0,1) for a clean
        natural image; values >> 3 mean the phase distribution visibly
        deviates from uniform.
      spike_excess: observed minus expected mass inside +-window rad of
        +-alpha (the §2 delta-spike feature a peak detector keys on). For
        the hard write this approaches the spectral footprint f; the
        one-sided spread dilutes it by ~window/(s*alpha) (ATTACKS §2a).
      band_excess: observed minus expected mass in +-[alpha - window,
        alpha*(1 + spread) + window] — the widest feature any amplitude
        randomization still occupies; what remains detectable after spread.
    """
    th = phases if phases is not None else _annulus_phases(img, params)
    n = th.size
    hist, _ = np.histogram(th, bins=bins, range=(-math.pi, math.pi))
    exp = n / bins
    chi2 = float(np.sum((hist - exp) ** 2) / exp)
    dof = bins - 1
    chi2_z = (chi2 - dof) / math.sqrt(2.0 * dof)

    a = params.alpha
    at = np.abs(th)
    in_spike = np.abs(at - a) <= window
    spike_expected = 2.0 * (2.0 * window) / (2.0 * math.pi)
    spike_excess = float(np.mean(in_spike)) - spike_expected

    hi = a * (1.0 + params.alpha_spread) + window
    lo = max(0.0, a - window)
    in_band = (at >= lo) & (at <= hi)
    band_expected = 2.0 * (hi - lo) / (2.0 * math.pi)
    band_excess = float(np.mean(in_band)) - band_expected

    return {
        "n": int(n),
        "chi2_z": float(chi2_z),
        "spike_excess": spike_excess,
        "band_excess": band_excess,
    }


def pairwise_difference_report(img_a: np.ndarray, img_b: np.ndarray,
                               params: Params = Params(),
                               max_harmonic: int = 32) -> dict:
    """SECOND-ORDER warden: circular-harmonic analysis of the PHASE
    DIFFERENCE between two images at common annulus bins (doc/ATTACKS.md
    §4a). This is the statistic that breaks shared-walk QIM across a
    collection: two stegos under one key/resolution write the SAME bins
    (shared walk) with the SAME per-slot dither, so at every common
    payload bin the difference theta_a - theta_b is an EXACT multiple of
    Delta/2 = pi/L — harmonic m = 2L of the difference distribution
    carries the full footprint mass, detecting QIM and revealing L with
    no key. The hard write leaks here too (differences in {0, +-2alpha}
    concentrate low harmonics). per_image_walk defeats the payload-bin
    component by construction (disjoint bin sets), leaving only the 912
    shared header bins.

    Returns z-scores z_m = |sum exp(i*m*(th_a - th_b))| / sqrt(n) for
    m = 1..max_harmonic: ~Rayleigh(1/sqrt(2)) under the null (independent
    uniform phases), so E[z] ~ 0.89 and z > 3 is a detection.
      max_z / argmax_m: the strongest harmonic (argmax_m == 2L fingers
      QIM level L); harmonics: the full array for plotting/inspection.
    """
    th_a = _annulus_phases(img_a, params)
    th_b = _annulus_phases(img_b, params)
    assert th_a.size == th_b.size, "images must share dimensions"
    d = th_a - th_b
    n = d.size
    m = np.arange(1, max_harmonic + 1, dtype=np.float64)
    z = np.abs(np.exp(1j * m[:, None] * d[None, :]).mean(axis=1)) \
        * math.sqrt(n)
    best = int(np.argmax(z))
    return {
        "n": int(n),
        "max_z": float(z[best]),
        "argmax_m": best + 1,
        "harmonics": [float(v) for v in z],
    }


def collusion_report(imgs, params: Params = Params(),
                     max_harmonic: int = 32) -> dict:
    """N-image COLLUSION warden (the reference doc/TODO.md "collusion test
    (mean FFT across multiple images)" — proposed there, never built):
    per-bin phase coherence across a collection of DIFFERENT covers
    suspected to share one key.

    Shared-walk embeds write the SAME bins in every image. At a written
    bin the phase is +-alpha (hard write; sign varies with each image's
    bit) or lattice-aligned (QIM with the shared per-slot dither), so the
    across-image resultant |mean_i exp(i*m*theta_i)| stays O(1) there —
    cos(m*alpha) at harmonic m for the hard write, ~1 at m = 2L for QIM —
    while unwritten bins average iid cover phases down as 1/sqrt(N).
    Averaging across the collection is exactly how the attack gains power:
    the per-bin null N*C^2 - 1 has mean 0 / variance ~1 regardless of N,
    while the written-bin signal grows linearly with N.

    Returns z_m = sqrt(nbins) * mean_bins(N*C_m^2 - 1) for m = 1..
    max_harmonic (~N(0,1) per harmonic under the null), max_z / argmax_m
    (argmax 2L fingers a QIM level, argmax 1-2 the hard write), and n /
    n_images. per_image_walk defeats the payload component by construction
    (disjoint payload bins); only the 912 shared header bins remain.
    """
    TH = np.stack([_annulus_phases(img, params) for img in imgs])
    N, nbins = TH.shape
    assert N >= 2, "collusion needs at least two images"
    m = np.arange(1, max_harmonic + 1, dtype=np.float64)
    z = np.empty(max_harmonic)
    for k in range(max_harmonic):  # loop to bound the (m, N, nbins) temp
        C2 = np.abs(np.exp(1j * m[k] * TH).mean(axis=0)) ** 2
        z[k] = math.sqrt(nbins) * float(np.mean(N * C2 - 1.0))
    best = int(np.argmax(z))
    return {
        "n": int(nbins),
        "n_images": int(N),
        "max_z": float(z[best]),
        "argmax_m": best + 1,
        "harmonics": [float(v) for v in z],
    }


def magnitude_conditioned_report(img: np.ndarray, params: Params = Params(),
                                 bins: int = 64, n_bands: int = 8,
                                 window: float = 0.05) -> dict:
    """SECOND-ORDER warden: phase statistics CONDITIONED on bin magnitude
    (the doc/TODO.md "phase-magnitude dependence" honesty item).

    The walk selects bins magnitude-blind (the reference disables mag_ok,
    steganosaur.cpp:797-799), so the write's phase signature lands uniformly
    across magnitude bands — while a marginal histogram dilutes it over the
    whole annulus population. Conditioning buys a warden nothing EXTRA for
    that reason (the signature is the same in every band), but it is the
    natural second axis to check, and for QIM it answers a sharper question:
    dithered quantization leaves each band's phases uniform, so even a
    magnitude-stratified warden measures nothing.

    Returns per-band {mag_lo, mag_hi, n, chi2_z, spike_excess} over
    magnitude quantiles of the annulus population (same statistics as
    phase_histogram_report, restricted per band), plus:
      max_chi2_z: the strongest band statistic (detection = any band >> 3;
        a Bonferroni-minded warden compares against ~3.2 for 8 bands).
      chi2_z_marginal: the unconditioned statistic, for comparison.
    """
    th, mag = _annulus_spectrum(img, params)
    order = np.quantile(mag, np.linspace(0.0, 1.0, n_bands + 1))
    a = params.alpha
    spike_expected = 2.0 * (2.0 * window) / (2.0 * math.pi)
    bands = []
    for i in range(n_bands):
        hi_incl = i == n_bands - 1
        m = (mag >= order[i]) & ((mag <= order[i + 1]) if hi_incl
                                 else (mag < order[i + 1]))
        t = th[m]
        n = t.size
        if n < 4 * bins:
            bands.append({"mag_lo": float(order[i]),
                          "mag_hi": float(order[i + 1]), "n": int(n),
                          "chi2_z": None, "spike_excess": None})
            continue
        hist, _ = np.histogram(t, bins=bins, range=(-math.pi, math.pi))
        exp = n / bins
        chi2 = float(np.sum((hist - exp) ** 2) / exp)
        dof = bins - 1
        chi2_z = (chi2 - dof) / math.sqrt(2.0 * dof)
        spike = float(np.mean(np.abs(np.abs(t) - a) <= window)) \
            - spike_expected
        bands.append({"mag_lo": float(order[i]),
                      "mag_hi": float(order[i + 1]), "n": int(n),
                      "chi2_z": float(chi2_z), "spike_excess": spike})
    zs = [b["chi2_z"] for b in bands if b["chi2_z"] is not None]
    marginal = phase_histogram_report(img, params, bins=bins, window=window)
    return {
        "bands": bands,
        "max_chi2_z": float(max(zs)) if zs else None,
        "chi2_z_marginal": float(marginal["chi2_z"]),
    }


def _wrap_abs(d: np.ndarray) -> np.ndarray:
    """|phase difference| wrapped to [0, pi]."""
    return np.abs((d + math.pi) % (2.0 * math.pi) - math.pi)


def cross_channel_report(img: np.ndarray, params: Params = Params(),
                         eps: float = 0.35, delta: float = 1.0,
                         cover: np.ndarray | None = None,
                         phases: np.ndarray | None = None,
                         cover_phases: np.ndarray | None = None) -> dict:
    """CROSS-CHANNEL warden (reference doc/TODO.md Tier-3 "cross-channel
    correlation tests" — the roadmap's last unbuilt detection line).

    Natural covers carry one shared structure (luma) in all three planes,
    so at a given annulus bin the R/G/B phases are mutually ALIGNED —
    strongly for photographic content (JPEG chroma subsampling makes
    high-frequency content luma-dominated), not at all for iid-noise
    covers. The walk writes ONE (plane, y, x) bin per bit (the per-plane
    keystreams are independent, keystream/_pure.py), so a written bin
    re-rolls exactly one plane's phase and leaves the triple in a
    "two aligned, one off" state that natural structure rarely produces.
    Unlike the phase-histogram wardens, NO mitigation flattens this:
    QIM/spread/jitter all randomize the written phase, which is precisely
    the signature — only covers without cross-channel correlation (or
    capacity left unused) hide it. Measured boundary in doc/ATTACKS.md §2e.

    Statistics (keyless, single image):
      align_z[pair]: cross-plane phase-alignment strength — resultant of
        exp(i*(th_a - th_b)) over the annulus, times sqrt(n). ~O(1) for
        iid channels; >> 3 means the cover class carries the correlation
        this warden needs (z ~ 14 on smooth-field covers, hundreds on
        photographs).
      cond_off_rate[plane]: P(plane's phase differs by > delta from BOTH
        others | the other two agree within eps) — the conditional
        misalignment rate the write inflates.
      n_aligned[plane]: the conditioning population size.
      n_bins: per-pair annulus population (the sqrt(n) scale of align_z).
    `phases`/`cover_phases`: optional precomputed annulus_phases() arrays
    to skip the full-image FFTs when a caller already has them.
    With a paired `cover`, adds cond_off_z[plane] (one-sided binomial
    z-score of the stego rate against the cover's own rate) and max_z —
    the paired diagnostic; the keyless corpus protocol lives in
    cross_channel_study.
    """
    def stats(image, th=None):
        if th is None:
            th = _annulus_phases(image, params)
        n = th.size // 3
        th3 = th.reshape(3, n)
        d = {(a, b): _wrap_abs(th3[a] - th3[b])
             for a in range(3) for b in range(a + 1, 3)}
        align = {f"{'rgb'[a]}{'rgb'[b]}":
                 float(np.abs(np.exp(1j * (th3[a] - th3[b])).mean())
                       * math.sqrt(n))
                 for (a, b) in d}
        rates, ns = [], []
        for c in range(3):
            a, b = [x for x in range(3) if x != c]
            sel = d[(a, b)] < eps
            da = d[(min(a, c), max(a, c))][sel]
            db = d[(min(b, c), max(b, c))][sel]
            off = (da > delta) & (db > delta)
            rates.append(float(off.mean()) if sel.any() else 0.0)
            ns.append(int(sel.sum()))
        return align, rates, ns, n

    align, rates, ns, n_bins = stats(img, phases)
    out = {
        "align_z": align,
        "cond_off_rate": rates,
        "n_aligned": ns,
        "n_bins": n_bins,
        "eps": eps,
        "delta": delta,
    }
    if cover is not None:
        _, crates, _cns, _ = stats(cover, cover_phases)
        zs = []
        for c in range(3):
            p0 = max(crates[c], 1e-6)
            se = math.sqrt(p0 * (1.0 - p0) / max(ns[c], 1))
            zs.append(float((rates[c] - crates[c]) / se))
        out["cover_cond_off_rate"] = crates
        out["cond_off_z"] = zs
        out["max_z"] = float(max(zs))
    return out


def cross_channel_features(img: np.ndarray,
                           params: Params = Params()) -> np.ndarray:
    """6-dim feature vector for the corpus protocol: the three pairwise
    alignment resultants + the three conditional misalignment rates."""
    r = cross_channel_report(img, params)
    # De-z by the same population that scaled them (the per-pair annulus
    # size), recovering the plain pairwise resultants in [0, 1] — NOT the
    # conditioning populations n_aligned, whose content-dependent size
    # would entangle the alignment dims with the rate dims.
    n = math.sqrt(max(r["n_bins"], 1))
    return np.array([*(v / n for v in r["align_z"].values()),
                     *r["cond_off_rate"]], dtype=np.float64)


def _study_embed(covers: np.ndarray, secrets: list, salts: list,
                 master_key: bytes, params: Params, device=None) -> np.ndarray:
    """Corpus embed for the warden studies, through the port's pipeline on
    `device` (default CUDA; runtime.resolve_device): the fused batch path,
    except Params.coherent (whose write the fused cores don't carry) — that
    mode embeds per image through the single-image pipeline instead, same
    secrets/salts, so every study can measure the coherent counter-move on
    identical corpora. The stegos come back as numpy arrays."""
    if getattr(params, "coherent", False):
        from steganosaurus_tpu_torch.pipeline.embed import embed_array

        return np.stack([
            embed_array(c, s, master_key=master_key, params=params,
                        salt=sa, device=device).stego
            for c, s, sa in zip(covers, secrets, salts)])
    from steganosaurus_tpu_torch.pipeline.batch import embed_batch

    res = embed_batch(covers, secrets, master_key=master_key, params=params,
                      salts=salts, device=device)
    return np.asarray(res.stego)


def cross_channel_study(params: Params = Params(), secret_bytes: int = 240,
                        n: int = 32, hw: tuple[int, int] = (256, 256),
                        seed: int = 7,
                        master_key: bytes | None = None,
                        device=None) -> dict:
    """Keyless corpus AUC of the cross-channel warden per cover family
    (same-source protocol, mirrors srm_study): embed a fresh secret per
    cover, train/evaluate a paired-CV Fisher discriminant on
    cross_channel_features. Expected shape (measured, doc/ATTACKS.md §2e):
    iid-channel families (gradient) are blind by construction; photographs
    and correlated textures expose the footprint regardless of QIM/spread
    mitigations — cover choice dominates, as with the SRM warden."""
    mk = master_key if master_key is not None else bytes(range(32))
    rng = np.random.default_rng(seed + 1)
    out = {"families": {}}
    for kind in ("gradient", "texture", "photo"):
        covers = srm_corpus(n, hw, seed, kind=kind)
        secrets = [bytes(rng.integers(0, 256, secret_bytes, dtype=np.uint8))
                   for _ in range(n)]
        salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
                 for _ in range(n)]
        stegos = _study_embed(covers, secrets, salts, mk, params,
                              device)
        X0 = np.stack([cross_channel_features(c, params) for c in covers])
        X1 = np.stack([cross_channel_features(s, params) for s in stegos])
        out["families"][kind] = _paired_eval(X0, X1, folds=4, seed=0)
    reps = out["families"].values()
    out["max_accuracy"] = float(max(r["accuracy"] for r in reps))
    out["max_auc"] = float(max(r["auc"] for r in reps))
    out["params"] = {
        "alpha": params.alpha, "jitter": params.jitter,
        "alpha_spread": getattr(params, "alpha_spread", 0.0),
        "qim": params.qim, "density": params.density,
        "secret_bytes": secret_bytes,
    }
    return out


# ---------------------------------------------------------------------------
# Phase-magnitude JOINT residual warden (doc/ATTACKS.md §2c's "one honest
# open line": the write preserves bin magnitudes exactly while re-rolling
# phases, and exploiting that needs a cover model). The cover model here is
# LOCAL SPECTRAL PHASE COHERENCE: a natural image's energy at a given
# frequency is dominated by spatially localized structure, so the phase of
# F(k) is locally a linear ramp in k (envelope x carrier) — its discrete
# curvature u(k)^2 conj(u(k-1)) conj(u(k+1)) concentrates near angle 0
# wherever the magnitude is high. Synthetic/Gaussian covers have iid bin
# phases (no coherence); the walk re-rolls one bin's phase at a time, so a
# written high-magnitude bin breaks the curvature triple it anchors. The
# JOINT part: coherence is stratified by magnitude quantile — the natural
# coupling (coherence rises with magnitude) is exactly what the
# magnitude-blind walk (reference disables mag_ok,
# the reference's steganosaur.cpp:797-799) cannot fake.
# ---------------------------------------------------------------------------


def _annulus_curvature(img: np.ndarray, params: Params
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(rho, mag) at the walk-annulus bins: rho[(2, N)] is the discrete
    phase curvature along the two spectral axes (angle of
    u(k)^2 conj(u(k-dy)) conj(u(k+dy)), 0 for a locally linear phase ramp),
    mag[(N,)] the bin magnitudes; 3 planes concatenated. Neighbors come
    from the full grid (they need not be annulus-eligible themselves)."""
    H, W = img.shape[:2]
    planes = img.astype(np.float64).transpose(2, 0, 1)
    spec = np.conj(np.fft.fft2(planes))  # reference forward convention
    mag = np.abs(spec)
    u = spec / np.maximum(mag, 1e-300)
    rlo = params.rmin * min(H, W)
    rhi = params.rmax * min(H, W)
    yy = np.arange(H)[:, None]
    xx = np.arange(W)[None, :]
    r = np.hypot(yy, xx)
    mask = (r >= rlo) & (r <= rhi) & (yy > 0) & (xx > 0)
    if H % 2 == 0:
        mask &= yy != H // 2
    if W % 2 == 0:
        mask &= xx != W // 2
    rows = []
    for ax in (1, 2):  # spectral y, x
        c = u * u * np.conj(np.roll(u, 1, axis=ax)) \
            * np.conj(np.roll(u, -1, axis=ax))
        rows.append(np.angle(c)[:, mask].ravel())
    return np.stack(rows), mag[:, mask].ravel()


def joint_residual_report(img: np.ndarray, params: Params = Params(),
                          n_bands: int = 8,
                          cover: np.ndarray | None = None) -> dict:
    """JOINT phase-magnitude warden statistics for one image.

    Per magnitude-quantile band of the annulus population, the phase
    coherence C = mean cos(rho) along each spectral axis (rho = discrete
    phase curvature; C -> 0 for iid phases, C -> 1 for a locally linear
    natural-structure ramp). Returns:
      bands: [{mag_lo, mag_hi, n, coherence: [C_y, C_x]}] over quantiles.
      top_coherence: max band/axis C — the COVER-SCREENING number: a
        high-coherence cover couples phase to magnitude, and any phase
        re-roll at its high-magnitude bins is statistically visible to a
        warden with this cover model (doc/ATTACKS.md §2f). Near-zero
        coherence (iid-phase covers) means there is nothing to break.
    With a paired `cover`, adds per-band drop z-scores
    (z = (C_cover - C_stego)/se, one per axis) and max_z — the paired
    diagnostic; the keyless corpus protocol lives in
    joint_residual_study."""
    rho, mag = _annulus_curvature(img, params)
    qs = np.quantile(mag, np.linspace(0.0, 1.0, n_bands + 1))
    qs[-1] = np.inf
    if cover is not None:
        crho, cmag = _annulus_curvature(cover, params)
        cqs = np.quantile(cmag, np.linspace(0.0, 1.0, n_bands + 1))
        cqs[-1] = np.inf
    bands, zs = [], []
    for b in range(n_bands):
        sel = (mag >= qs[b]) & (mag < qs[b + 1])
        cos = np.cos(rho[:, sel])
        n = int(sel.sum())
        band = {"mag_lo": float(qs[b]),
                "mag_hi": float(min(qs[b + 1], np.finfo(np.float64).max)),
                "n": n,
                "coherence": [float(c) for c in cos.mean(axis=1)]}
        if cover is not None and n > 16:
            csel = (cmag >= cqs[b]) & (cmag < cqs[b + 1])
            ccos = np.cos(crho[:, csel])
            cn = int(csel.sum())
            se = np.sqrt(cos.var(axis=1) / n + ccos.var(axis=1) / cn)
            z = (ccos.mean(axis=1) - cos.mean(axis=1)) / np.maximum(se,
                                                                    1e-12)
            band["drop_z"] = [float(v) for v in z]
            zs.extend(band["drop_z"])
        bands.append(band)
    out = {
        "bands": bands,
        "top_coherence": float(max(max(b["coherence"]) for b in bands)),
    }
    if cover is not None:
        out["max_z"] = float(max(zs)) if zs else None
    return out


def joint_residual_features(img: np.ndarray, params: Params = Params(),
                            n_bands: int = 8) -> np.ndarray:
    """(2*n_bands,)-dim feature vector for the corpus protocol: per-band
    mean-cos phase-curvature coherence along each spectral axis."""
    rho, mag = _annulus_curvature(img, params)
    qs = np.quantile(mag, np.linspace(0.0, 1.0, n_bands + 1))
    qs[-1] = np.inf
    feats = []
    for ax in range(2):
        cos = np.cos(rho[ax])
        for b in range(n_bands):
            sel = (mag >= qs[b]) & (mag < qs[b + 1])
            feats.append(float(cos[sel].mean()) if sel.any() else 0.0)
    return np.array(feats, dtype=np.float64)


def joint_residual_study(params: Params = Params(), secret_bytes: int = 240,
                         n: int = 32, hw: tuple[int, int] = (256, 256),
                         seed: int = 7,
                         master_key: bytes | None = None,
                         device=None) -> dict:
    """Keyless corpus AUC of the joint phase-magnitude warden per cover
    family (same-source protocol, mirrors srm_study/cross_channel_study):
    embed a fresh secret per cover, train/evaluate a paired-CV Fisher
    discriminant on joint_residual_features. Expected shape (measured,
    doc/ATTACKS.md §2f): iid-phase families (gradient/texture) are blind
    by construction — there is no coherence to break; photographs expose
    the footprint under every mitigation because QIM/spread/jitter all
    re-roll written phases, which is precisely what the cover model
    detects. Unlike the §2e cross-channel warden this one is
    WITHIN-channel: channel-independent sensor noise does not hide it."""
    mk = master_key if master_key is not None else bytes(range(32))
    rng = np.random.default_rng(seed + 1)
    out = {"families": {}}
    for kind in ("gradient", "texture", "photo"):
        covers = srm_corpus(n, hw, seed, kind=kind)
        secrets = [bytes(rng.integers(0, 256, secret_bytes, dtype=np.uint8))
                   for _ in range(n)]
        salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
                 for _ in range(n)]
        stegos = _study_embed(covers, secrets, salts, mk, params,
                              device)
        X0 = np.stack([joint_residual_features(c, params) for c in covers])
        X1 = np.stack([joint_residual_features(s, params) for s in stegos])
        out["families"][kind] = _paired_eval(X0, X1, folds=4, seed=0)
    reps = out["families"].values()
    out["max_accuracy"] = float(max(r["accuracy"] for r in reps))
    out["max_auc"] = float(max(r["auc"] for r in reps))
    out["params"] = {
        "alpha": params.alpha, "jitter": params.jitter,
        "alpha_spread": getattr(params, "alpha_spread", 0.0),
        "qim": params.qim, "density": params.density,
        "secret_bytes": secret_bytes,
    }
    return out


# ---------------------------------------------------------------------------
# SRM-lite: learned spatial-residual warden (reference doc/TODO.md Tier-3
# "Empirical Detection Testing Framework" — the last unbuilt line of that
# roadmap). A small Spatial-Rich-Model-class detector: high-pass residuals
# -> quantize/truncate -> co-occurrence features -> Fisher linear
# discriminant trained on a self-generated cover corpus (gen_png-class
# gradients + synthetic textures), cross-validated cover-vs-stego. This is
# the learned complement to the five analytical wardens above: it sees the
# SPATIAL side of the u8 rounding footprint rather than the spectral
# phase histogram.
# ---------------------------------------------------------------------------


_SRM_T = 3  # residual truncation threshold: values clipped to [-T, T]


def _cooc2(q: np.ndarray, axis: int) -> np.ndarray:
    """Sign-symmetrized 2nd-order co-occurrence histogram of a quantized
    residual plane along `axis` -> ((2T+1)^2,) normalized counts. Pairs
    (a, b) and (-a, -b) are pooled (the stego signal is sign-symmetric)."""
    a = np.take(q, np.arange(q.shape[axis] - 1), axis=axis).ravel()
    b = np.take(q, np.arange(1, q.shape[axis]), axis=axis).ravel()
    k = 2 * _SRM_T + 1
    ia, ib = a + _SRM_T, b + _SRM_T
    ja, jb = -a + _SRM_T, -b + _SRM_T
    h = (np.bincount(ia * k + ib, minlength=k * k)
         + np.bincount(ja * k + jb, minlength=k * k)).astype(np.float64)
    return h / max(h.sum(), 1.0)


def srm_features(img: np.ndarray) -> np.ndarray:
    """SRM-lite feature vector of one RGB u8 image.

    Residuals (per luma-ish mean plane, f64): 1st-order horizontal/
    vertical differences, 2nd-order horizontal/vertical, and the 3x3 "KB"
    predictor residual — the classic SRM first-submodel family. Each is
    quantized (q=1) and truncated to [-T, T], then summarized by
    horizontal+vertical sign-symmetrized 2nd-order co-occurrences.
    Dimension: 5 residuals x 2 directions x 49 bins = 490."""
    x = img.astype(np.float64).mean(axis=2)
    res = []
    res.append(x[:, 1:] - x[:, :-1])                       # D1 horizontal
    res.append(x[1:, :] - x[:-1, :])                       # D1 vertical
    res.append(x[:, :-2] - 2.0 * x[:, 1:-1] + x[:, 2:])    # D2 horizontal
    res.append(x[:-2, :] - 2.0 * x[1:-1, :] + x[2:, :])    # D2 vertical
    # KB kernel: predict center from 8-neighborhood (Ker-Boehme)
    kb = (-x[:-2, :-2] + 2 * x[:-2, 1:-1] - x[:-2, 2:]
          + 2 * x[1:-1, :-2] - 4 * x[1:-1, 1:-1] + 2 * x[1:-1, 2:]
          - x[2:, :-2] + 2 * x[2:, 1:-1] - x[2:, 2:]) / 4.0
    res.append(kb)
    feats = []
    for r in res:
        q = np.clip(np.round(r), -_SRM_T, _SRM_T).astype(np.int64)
        feats.append(_cooc2(q, 1))
        feats.append(_cooc2(q, 0))
    return np.concatenate(feats)


def _fld_train(X0: np.ndarray, X1: np.ndarray, ridge: float = 1e-6):
    """Regularized Fisher linear discriminant: returns (w, threshold) with
    score = f @ w; score > threshold classifies stego. Threshold at the
    midpoint of the projected class means (equal priors)."""
    mu0, mu1 = X0.mean(axis=0), X1.mean(axis=0)
    C = np.cov(np.vstack([X0 - mu0, X1 - mu1]).T)
    C += ridge * np.trace(C) / C.shape[0] * np.eye(C.shape[0])
    w = np.linalg.solve(C, mu1 - mu0)
    thr = 0.5 * (X0 @ w).mean() + 0.5 * (X1 @ w).mean()
    return w, thr


def srm_corpus(n: int = 32, hw: tuple[int, int] = (256, 256),
               seed: int = 7, kind: str = "gradient") -> np.ndarray:
    """Self-generated SAME-SOURCE cover corpus, (n, H, W, 3) u8.

    kind="gradient": gen_png-class gradient + iid noise (tools/gen_png.py
    family — fixed base/amplitude, only the noise seed varies).
    kind="texture": multi-scale smoothed noise (natural-image-like spatial
    correlation), fixed mixing weights.
    kind="photo": random crops of a real photograph (matplotlib's
    grace_hopper.jpg sample — the one natural image shipped with the
    baked-in libraries). NOTE: the source is JPEG-decoded, so the family
    models the common "cover was once JPEG-compressed" case — its
    high-frequency residuals are quantization-sparse and any white write
    noise is maximally exposed (doc/ATTACKS.md §2d measures AUC 1.0 for
    EVERY mode at every payload on it). Crops of one photo overlap;
    pair-held-out CV stays valid (a cover and its stego never split),
    but test crops share content with training crops — the same-source
    protocol at its strictest.

    Same-source matters: a warden studying a channel knows the cover
    distribution, and the standard steganalysis protocol trains cover-vs-
    stego on one source. A heterogeneous corpus buries the embedding
    signature under cover variance and reports fake blindness (measured:
    +-1-per-pixel noise — far louder than any embed here — detects at
    AUC 0.91 on a same-source corpus but 0.45 on a mixed one)."""
    H, W = hw
    rng = np.random.default_rng(seed)
    out = np.empty((n, H, W, 3), dtype=np.uint8)
    if kind == "photo":
        import os

        import matplotlib
        from PIL import Image

        path = os.path.join(matplotlib.get_data_path(), "sample_data",
                            "grace_hopper.jpg")
        img = np.asarray(Image.open(path).convert("RGB"))
        if img.shape[0] <= H or img.shape[1] <= W:
            raise ValueError(f"photo corpus needs crops smaller than "
                             f"{img.shape[:2]}, got {hw}")
        ys = rng.integers(0, img.shape[0] - H, n)
        xs = rng.integers(0, img.shape[1] - W, n)
        for i, (y, x) in enumerate(zip(ys, xs)):
            out[i] = img[y:y + H, x:x + W]
        return out
    for i in range(n):
        if kind == "gradient":
            base = np.linspace(180, 220, W)[None, :, None]
            img = base + rng.uniform(-10, 10, (H, W, 3))
        elif kind == "texture":
            img = np.zeros((H, W, 3))
            for scale, amp in ((1, 10.0), (4, 14.0), (16, 18.0)):
                z = rng.normal(0, 1, (H // scale + 2, W // scale + 2, 3))
                z = np.cumsum(np.cumsum(z, 0), 1) if scale >= 16 else z
                zi = np.kron(z, np.ones((scale, scale, 1)))[:H, :W]
                zi = (zi - zi.mean()) / max(zi.std(), 1e-9)
                img += zi * amp
            img += 128.0
        else:
            raise ValueError(f"unknown corpus kind {kind!r}")
        out[i] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return out


def srm_report(covers: np.ndarray, stegos: np.ndarray, folds: int = 4,
               seed: int = 0) -> dict:
    """Train/evaluate the SRM-lite detector on paired (covers, stegos).

    K-fold cross-validation over PAIRS (a cover and its stego never split
    across train/test — the standard steganalysis protocol). Returns:
      accuracy: mean held-out classification accuracy (0.5 = blind).
      p_e: min-error probability 0.5*(FA + MD) at the trained threshold.
      auc: held-out ROC area (rank statistic of the projected scores).
      n_pairs, feature_dim, folds.
    A detector at accuracy ~0.5 / auc ~0.5 is BLIND to the embedding on
    this corpus; values near 1.0 mean the mode is spatially detectable."""
    covers = np.asarray(covers)
    stegos = np.asarray(stegos)
    assert covers.shape == stegos.shape and covers.ndim == 4
    X0 = np.stack([srm_features(c) for c in covers])
    X1 = np.stack([srm_features(s) for s in stegos])
    return _paired_eval(X0, X1, folds=folds, seed=seed)


def _paired_eval(X0: np.ndarray, X1: np.ndarray, folds: int = 4,
                 seed: int = 0) -> dict:
    """Pair-held-out K-fold FLD evaluation of (cover, stego) feature rows
    (a cover and its stego never split across train/test — the standard
    steganalysis protocol). Shared by srm_report and cross_channel_study."""
    n = X0.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    folds = max(2, min(folds, n // 2))
    accs, aucs, pes = [], [], []
    for f in range(folds):
        test = order[f::folds]
        train = np.setdiff1d(order, test)
        w, thr = _fld_train(X0[train], X1[train])
        s0, s1 = X0[test] @ w, X1[test] @ w
        fa = float(np.mean(s0 > thr))
        md = float(np.mean(s1 <= thr))
        accs.append(1.0 - 0.5 * (fa + md))
        pes.append(0.5 * (fa + md))
        # AUC: P(score_stego > score_cover) + 0.5 P(tie)
        diff = s1[:, None] - s0[None, :]
        aucs.append(float(np.mean(diff > 0) + 0.5 * np.mean(diff == 0)))
    return {
        "accuracy": float(np.mean(accs)),
        "p_e": float(np.mean(pes)),
        "auc": float(np.mean(aucs)),
        "n_pairs": int(n),
        "feature_dim": int(X0.shape[1]),
        "folds": int(folds),
    }


def srm_study(params: Params = Params(), secret_bytes: int = 240,
              n: int = 32, hw: tuple[int, int] = (256, 256),
              seed: int = 7, master_key: bytes | None = None,
              device=None) -> dict:
    """End-to-end SRM-lite study for one embedding config: per cover
    FAMILY (same-source protocol — see srm_corpus), embed a fresh random
    secret per cover (fresh salts, the bulk threat model), train and
    evaluate. Returns per-family reports plus the warden's best case
    (max accuracy/auc across families). Convenience entry point for
    doc/ATTACKS.md section 2d's table; heavy (2n embeds + feature
    extraction + folds x FLD solves)."""
    mk = master_key if master_key is not None else bytes(range(32))
    rng = np.random.default_rng(seed + 1)
    out = {"families": {}}
    for kind in ("gradient", "texture", "photo"):
        covers = srm_corpus(n, hw, seed, kind=kind)
        secrets = [bytes(rng.integers(0, 256, secret_bytes, dtype=np.uint8))
                   for _ in range(n)]
        salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
                 for _ in range(n)]
        stegos = _study_embed(covers, secrets, salts, mk, params,
                              device)
        out["families"][kind] = srm_report(covers, stegos)
    reps = out["families"].values()
    out["max_accuracy"] = float(max(r["accuracy"] for r in reps))
    out["max_auc"] = float(max(r["auc"] for r in reps))
    out["params"] = {
        "alpha": params.alpha, "jitter": params.jitter,
        "alpha_spread": getattr(params, "alpha_spread", 0.0),
        "qim": params.qim, "density": params.density,
        "secret_bytes": secret_bytes,
    }
    return out
