"""Device compute cores of the single-image embed/extract pipelines (the
port's twin of steganosaurus_tpu/pipeline/device.py).

Three operations per backend:
- analyze:     planes -> (spectrum, medians, capacity_bits, cover_features)
- embed_apply: spectrum + bit/bin arrays -> stego u8 image
- read_bits / read_values (and their QIM and coherent forms): spectrum +
  bin arrays -> raw bits or decision values on the host

Backends:
- TorchBackend: complex64 on a torch device (cuFFT on the card), or
  complex128 under Params.fft_dtype="complex128" on a CUDA device (cuFFT's
  Z2Z). The spectrum stays on the device between analyze and the reads;
  only the index arrays go up and the bits, values or u8 stego come back.
  Index arrays have their exact lengths (the JAX backend pads them to 4096
  multiples only so jax.jit compiles fewer graphs).
- NumpyBackend: Params.fft_dtype="complex128" on the CPU, a copy of the
  JAX package's f64 backend — the reference's arithmetic and the parity
  arbiter (tests/test_torch_single.py holds the copy equal to the
  original, and the card's f64 TorchBackend to the copy).

backend_input picks the backend for an image: its device is the tensor's
own, else the caller's `device`, else CUDA (runtime.resolve_device), and
the work runs there; nothing moves to the host on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from steganosaurus_tpu_torch import runtime, spectral
from steganosaurus_tpu_torch.keystream._pure import conj_idx
from steganosaurus_tpu_torch.ops import mask as mask_ops
from steganosaurus_tpu_torch.ops import phase as phase_ops


class TorchBackend:
    name = "torch"

    def __init__(self, device, dtype: torch.dtype = torch.complex64):
        self.device = torch.device(device)
        self.dtype = dtype
        # host arrays of angles and amplitudes go up in the spectrum's
        # real precision
        self._real = (np.float64 if dtype == torch.complex128
                      else np.float32)

    def _up(self, a, dtype) -> torch.Tensor:
        return runtime.upload(np.asarray(a, dtype), self.device)

    def _idx(self, arrs) -> list[torch.Tensor]:
        return [self._up(a, np.int64) for a in arrs]

    def _angles(self, a) -> torch.Tensor:
        return self._up(a, self._real)

    def _alpha(self, alpha):
        """A scalar alpha stays a Python float (a device fill in the phase
        ops); a per-bit array (Params.alpha_spread) goes up as angles."""
        return self._angles(alpha) if np.ndim(alpha) else float(alpha)

    def analyze(self, planes, params, lazy: bool = False):
        """(spectrum, medians, capacity, cover features) of (3, H, W)
        planes (a tensor on this backend's device, or a host array). The
        spectrum and medians stay on the device, and without lazy the
        capacity and features are pulled as an int and a (3, r, r) u8
        array. lazy=True is extraction's and the coherent refine's call:
        the medians and the capacity are left out (None) unless
        Params.adaptive_alpha reads the medians, and the features stay on
        the device (they are hashed only under cover_dependent_path)."""
        if not isinstance(planes, torch.Tensor):
            planes = self._up(planes, self._real)
        H, W = planes.shape[-2:]
        PH, PW = spectral.fft_dims(H, W)
        real = (torch.float64 if self.dtype == torch.complex128
                else torch.float32)
        # u8-valued planes are exact in f32
        p = spectral.apply_center(planes.to(real), params.center)
        spec = spectral.fft2(spectral.pad_planes(p, PH, PW), self.dtype)
        feat = spectral.cover_hash_features(spec)
        if lazy and not params.adaptive_alpha:
            return spec, None, None, feat
        med = spectral.median_abs(spec)
        if lazy:
            return spec, med, None, feat
        thr = params.magmin * med
        cap = mask_ops.capacity_bits(spec, thr, params.rmin, params.rmax)
        return spec, med, int(cap), feat.cpu().numpy()

    def embed_apply(self, spec, med, idx, bits, jitters, alpha, params, H, W,
                    qim_dithers=None, hdr_bits=0) -> torch.Tensor:
        """Write the frame at the walk bins and return the (H, W, 3) u8
        stego on the device: the plain (hard/soft) rule, the QIM split
        (header slots [0, hdr_bits) plain, payload QIM), or the coherent
        split (header and payload common-mode, payload QIM under
        Params.qim), then the inverse FFT, centering and u8 rounding."""
        PH, PW = spectral.fft_dims(H, W)
        kw = dict(gain=(H * W) / (PH * PW), floor=params.write_floor,
                  img_pixels=float(H) * W)
        plane, y, x = self._idx(idx)
        bits = self._up(bits, np.uint8)
        jit = self._angles(jitters)
        alpha = self._alpha(alpha)
        dith = (self._angles(qim_dithers) if params.qim else None)
        h, p = slice(0, hdr_bits), slice(hdr_bits, None)

        def part(a, s):
            return a[s] if isinstance(a, torch.Tensor) else a

        if params.coherent:
            # header AND payload take the common-mode write; extraction
            # finds the header by a two-rule trial (pipeline/extract.py)
            spec2 = phase_ops.embed_phases_coherent(
                spec, y[h], x[h], bits[h], jit[h], part(alpha, h),
                soft=params.soft_write, **kw)
            if params.qim:
                spec2 = phase_ops.embed_phases_coherent_qim(
                    spec2, y[p], x[p], bits[p], dith[p], params.qim, **kw)
            else:
                spec2 = phase_ops.embed_phases_coherent(
                    spec2, y[p], x[p], bits[p], jit[p], part(alpha, p),
                    soft=params.soft_write, **kw)
        elif params.qim:
            # header slots keep the plain write (the header must decode
            # before any mode is known); each split write clears the floor
            # on its own
            spec2 = phase_ops.embed_phases(
                spec, plane[h], y[h], x[h], bits[h], jit[h], part(alpha, h),
                med, params.adaptive_alpha, soft=params.soft_write, **kw)
            spec2 = phase_ops.embed_phases_qim(
                spec2, plane[p], y[p], x[p], bits[p], dith[p], params.qim,
                **kw)
        else:
            spec2 = phase_ops.embed_phases(
                spec, plane, y, x, bits, jit, alpha, med,
                params.adaptive_alpha, soft=params.soft_write, **kw)
        planes2 = spectral.ifft2_real(spec2)[..., :H, :W]
        planes2 = spectral.apply_center(planes2, params.center)
        return spectral.from_planes(planes2)

    @staticmethod
    def _bits(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.uint8)

    @staticmethod
    def _values(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.float64)

    def read_bits(self, spec, med, idx, jitters, alpha, params):
        plane, y, x = self._idx(idx)
        return self._bits(phase_ops.read_phases(
            spec, plane, y, x, self._angles(jitters), float(alpha),
            med, params.adaptive_alpha))

    def read_values(self, spec, med, idx, jitters, alpha, params):
        """Per-bin decision values (ops.phase.read_values): the soft
        decode's input."""
        plane, y, x = self._idx(idx)
        return self._values(phase_ops.read_values(
            spec, plane, y, x, self._angles(jitters), float(alpha),
            med, params.adaptive_alpha))

    def read_bits_qim(self, spec, idx, dithers, L):
        """QIM payload read (ops.phase.read_phases_qim); dithers are the
        payload slots' keyed angles (pipeline/qim.py)."""
        plane, y, x = self._idx(idx)
        return self._bits(phase_ops.read_phases_qim(
            spec, plane, y, x, self._angles(dithers), L))

    def read_values_qim(self, spec, idx, dithers, L):
        plane, y, x = self._idx(idx)
        return self._values(phase_ops.read_values_qim(
            spec, plane, y, x, self._angles(dithers), L))

    def read_bits_coherent(self, spec, idx_yx, jitters, alpha):
        """Coherent read (ops.phase.read_phases_coherent): bits from the
        common-mode phase at the (y, x) sites (Params.coherent)."""
        y, x = self._idx(idx_yx)
        return self._bits(phase_ops.read_phases_coherent(
            spec, y, x, self._angles(jitters), float(alpha)))

    def read_values_coherent(self, spec, idx_yx, jitters, alpha):
        y, x = self._idx(idx_yx)
        return self._values(phase_ops.read_values_coherent(
            spec, y, x, self._angles(jitters), float(alpha)))

    def read_bits_coherent_qim(self, spec, idx_yx, dithers, L):
        y, x = self._idx(idx_yx)
        return self._bits(phase_ops.read_phases_coherent_qim(
            spec, y, x, self._angles(dithers), L))

    def read_values_coherent_qim(self, spec, idx_yx, dithers, L):
        y, x = self._idx(idx_yx)
        return self._values(phase_ops.read_values_coherent_qim(
            spec, y, x, self._angles(dithers), L))


# ---------------------------------------------------------------------------
# numpy (f64) backend — reference-exact arithmetic, the parity arbiter; a
# copy of the JAX package's NumpyBackend (pipeline/device.py there)
# ---------------------------------------------------------------------------


class NumpyBackend:
    name = "numpy"

    def analyze(self, planes_f64: np.ndarray, params, lazy: bool = False):
        # `lazy` is a JaxBackend pull optimization; everything is already
        # host-resident here, so it is accepted and ignored.
        H, W = planes_f64.shape[-2:]
        PH, PW = spectral.fft_dims(H, W)
        p = planes_f64
        if params.center:
            yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
            p = p * np.where((yy + xx) % 2 == 1, -1.0, 1.0)
        padded = np.zeros((3, PH, PW), dtype=np.float64)
        padded[:, :H, :W] = p
        # conj: reference forward-FFT sign convention (see spectral.fft2)
        spec = np.conj(np.fft.fft2(padded))
        mags = np.abs(spec).reshape(3, -1)
        n = mags.shape[-1]
        med = np.partition(mags, n // 2, axis=-1)[:, n // 2]
        thr = params.magmin * med
        cap = self._capacity(spec, thr, params.rmin, params.rmax)
        region = min(8, min(PH, PW) // 8)
        feat = np.clip(
            np.floor(np.log1p(np.abs(spec[:, :region, :region])) / 2.0), 0, 7
        ).astype(np.uint8)
        return spec, med, cap, feat

    @staticmethod
    def _capacity(spec, thr, rmin, rmax):
        _, H, W = spec.shape
        yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
        axis = (yy == 0) | (xx == 0)
        if H % 2 == 0:
            axis |= yy == H // 2
        if W % 2 == 0:
            axis |= xx == W // 2
        r = np.hypot(yy.astype(np.float64), xx.astype(np.float64))
        ok = (~axis) & (r >= rmin * min(H, W)) & (r <= rmax * min(H, W))
        magok = np.abs(spec) >= thr[:, None, None]
        return int(((ok[None] & magok).sum(axis=(1, 2)) // 2).sum())

    def embed_apply(self, spec, med, idx, bits, jitters, alpha, params, H, W,
                    qim_dithers=None, hdr_bits=0, return_targets=False):
        """f64 oracle embed. return_targets=True additionally returns the
        complex TARGET values written at the walk bins (pre conjugate-mirror,
        pre IFFT/quantize) — the intended channel input that
        utils.channel.requantization_noise_report compares the re-FFT'd
        stego against."""
        plane, y, x = (np.asarray(a) for a in idx)
        PH, PW = spec.shape[-2:]
        spec = spec.copy()
        if getattr(params, "coherent", False):
            return self._embed_coherent(spec, plane, y, x, bits, jitters,
                                        alpha, med, params, H, W,
                                        qim_dithers, hdr_bits,
                                        return_targets)
        v = spec[plane, y, x]
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        jit_arr = np.asarray(jitters)
        if params.qim:
            # f64 oracle of the split write: header slots hard/soft, payload
            # slots dithered QIM (pipeline/qim.py; ops/phase.py qim fns).
            s_sign = np.where(np.asarray(bits, bool), 1.0, -1.0)
            theta = np.where(np.asarray(bits, bool), a, -a) + jit_arr
            if params.soft_write:
                sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
                phi = np.angle(v) - jit_arr
                valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
                t_sin = s_sign * sigma * np.abs(np.sin(a))
                t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                    np.cos(a))
                theta = np.arctan2(t_sin, t_cos) + jit_arr
                nv_h = np.where(valid, v, mag * np.exp(1j * theta))
            else:
                nv_h = mag * np.exp(1j * theta)
            delta = 2.0 * np.pi / params.qim
            d = np.asarray(qim_dithers, np.float64)
            half_b = np.asarray(bits, np.float64) * 0.5
            q = (np.angle(v) - d) / delta - half_b
            th_q = d + (np.round(q) + half_b) * delta
            nv = np.where(np.arange(len(v)) < hdr_bits, nv_h,
                          mag * np.exp(1j * th_q))
            out = self._finish_embed(spec, plane, y, x, v, nv, params, H, W)
            return (out, nv) if return_targets else out
        if params.soft_write:
            # f64 oracle of the minimal-energy write (ops/phase.py): keep
            # bins already decoding with margin >= a, clamp the rest to the
            # margin boundary in the correct half-plane.
            s_sign = np.where(np.asarray(bits, bool), 1.0, -1.0)
            sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
            phi = np.angle(v) - jit_arr
            valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
            t_sin = s_sign * sigma * np.abs(np.sin(a))
            t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(np.cos(a))
            theta = np.arctan2(t_sin, t_cos) + jit_arr
            nv = np.where(valid, v, mag * np.exp(1j * theta))
        else:
            theta = np.where(np.asarray(bits, bool), a, -a) + jit_arr
            nv = mag * np.exp(1j * theta)
        out = self._finish_embed(spec, plane, y, x, v, nv, params, H, W)
        return (out, nv) if return_targets else out

    @staticmethod
    def _apply_write_floor(v, nv, params, H, W):
        """f64 oracle of the quantization write floor (Params.write_floor;
        ops.phase.write_floor_boost): magnitude-boost every MOVED bin's
        target so the spatial delta survives u8 rounding. nv == v bins
        (soft-write valid) stay untouched; b == 1 whenever the write is
        already above the floor."""
        floor = params.write_floor
        if not floor:
            return nv
        wm = nv != v
        A = float(np.sum(np.abs(nv[wm]) ** 2))
        C = float(np.sum((nv[wm] * np.conj(v[wm])).real))
        V = float(np.sum(np.abs(v[wm]) ** 2))
        e_star = 1.5 * (floor * H * W) ** 2
        disc = max(C * C - A * (V - e_star), 0.0)
        b = np.clip((C + np.sqrt(disc)) / max(A, 1e-20), 1.0, 32.0)
        return np.where(wm, b * nv, nv)

    @staticmethod
    def _ifft_quantize(spec, params, H, W):
        """Embed tail: inverse FFT, center, round-half-away-from-zero
        quantize (reference from_planes_u8, :387-392)."""
        planes2 = np.fft.ifft2(np.conj(spec)).real[:, :H, :W]
        if params.center:
            yy2, xx2 = np.arange(H)[:, None], np.arange(W)[None, :]
            planes2 = planes2 * np.where((yy2 + xx2) % 2 == 1, -1.0, 1.0)
        q = np.clip(np.floor(planes2 + 0.5), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(q.transpose(1, 2, 0))

    @staticmethod
    def _finish_embed(spec, plane, y, x, v, nv, params, H, W):
        """Common embed tail: write-floor boost, gain pre-compensation,
        conjugate-mirror scatter, inverse FFT, center,
        round-half-away-from-zero quantize."""
        PH, PW = spec.shape[-2:]
        nv = NumpyBackend._apply_write_floor(v, nv, params, H, W)
        gain = (H * W) / (PH * PW)  # crop retention; see phase_ops.embed_phases
        if gain != 1.0:
            nv = v + (nv - v) / gain
        cys, cxs = zip(*(conj_idx(int(yy), int(xxx), PH, PW) for yy, xxx in zip(y, x)))
        spec[plane, y, x] = nv
        spec[plane, np.asarray(cys), np.asarray(cxs)] = np.conj(nv)
        return NumpyBackend._ifft_quantize(spec, params, H, W)

    @staticmethod
    def _coherent_theta(spec, y, x):
        """f64 oracle of ops.phase._coherent_common: (v3 (3, n), mag3,
        common-mode phase theta = angle(sum_c v_c/|v_c|), resultant S)."""
        v3 = spec[:, y, x]
        mag3 = np.maximum(1e-12, np.abs(v3))
        S = (v3 / mag3).sum(axis=0)
        return v3, mag3, S, np.angle(S)

    def _embed_coherent(self, spec, plane, y, x, bits, jitters, alpha, med,
                        params, H, W, qim_dithers, hdr_bits, return_targets):
        """f64 oracle of the coherent split write (_jit_embed_apply
        coherent branch; ops/phase.py embed_phases_coherent[_qim]): header
        AND payload rotate ALL THREE planes at each (y, x) site by one
        common delta — the header on the plain hard/soft target (read
        back by the two-rule header trial, pipeline/extract.py), the
        payload on the hard/soft/QIM target. Each section clears the
        write floor independently (jax twin semantics). return_targets
        yields the payload's (3, n) complex targets (pre-mirror,
        pre-IFFT)."""
        PH, PW = spec.shape[-2:]
        gain = (H * W) / (PH * PW)
        bbits = np.asarray(bits, bool)
        jit_arr = np.asarray(jitters, np.float64)
        a_all = np.broadcast_to(np.asarray(alpha, np.float64), bbits.shape)
        h = slice(0, hdr_bits)
        # --- header: coherent plain (hard/soft) common-mode write ---
        if hdr_bits:
            yh, xh = y[h], x[h]
            v3h, _m3, _Sh, th_h = self._coherent_theta(spec, yh, xh)
            a = a_all[h]
            if params.soft_write:
                s_sign = np.where(bbits[h], 1.0, -1.0)
                sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
                phi = th_h - jit_arr[h]
                valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
                t_sin = s_sign * sigma * np.abs(np.sin(a))
                t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                    np.cos(a))
                tgt = np.arctan2(t_sin, t_cos) + jit_arr[h]
                dlt = np.where(valid, 0.0, tgt - th_h)
            else:
                tgt = np.where(bbits[h], a, -a) + jit_arr[h]
                dlt = tgt - th_h
            nv3h = v3h * np.exp(1j * dlt)[None, :]
            nv3h = self._apply_write_floor(
                v3h.ravel(), nv3h.ravel(), params, H, W).reshape(v3h.shape)
            if gain != 1.0:
                nv3h = v3h + (nv3h - v3h) / gain
            cys, cxs = zip(*(conj_idx(int(a_), int(b_), PH, PW)
                             for a_, b_ in zip(yh, xh)))
            spec[:, yh, xh] = nv3h
            spec[:, np.asarray(cys), np.asarray(cxs)] = np.conj(nv3h)
        # --- payload: coherent all-plane common-mode write ---
        p = slice(hdr_bits, None)
        yp, xp = y[p], x[p]
        v3, _mag3, _S, th = self._coherent_theta(spec, yp, xp)
        ap = a_all[p]
        if params.qim:
            delta_l = 2.0 * np.pi / params.qim
            d = np.asarray(qim_dithers, np.float64)[p]
            half_b = bbits[p].astype(np.float64) * 0.5
            q = (th - d) / delta_l - half_b
            tgt = d + (np.round(q) + half_b) * delta_l
            delta = tgt - th
        elif params.soft_write:
            s_p = np.where(bbits[p], 1.0, -1.0)
            sigma = np.where(np.sin(ap) < 0, -1.0, 1.0)
            phi = th - jit_arr[p]
            valid = s_p * sigma * np.sin(phi) >= np.abs(np.sin(ap))
            t_sin = s_p * sigma * np.abs(np.sin(ap))
            t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                np.cos(ap))
            tgt = np.arctan2(t_sin, t_cos) + jit_arr[p]
            delta = np.where(valid, 0.0, tgt - th)
        else:
            tgt = np.where(bbits[p], ap, -ap) + jit_arr[p]
            delta = tgt - th
        nv3 = v3 * np.exp(1j * delta)[None, :]
        nv3 = self._apply_write_floor(v3.ravel(), nv3.ravel(), params, H, W
                                      ).reshape(v3.shape)
        if gain != 1.0:
            nv3 = v3 + (nv3 - v3) / gain
        cys, cxs = zip(*(conj_idx(int(a_), int(b_), PH, PW)
                         for a_, b_ in zip(yp, xp)))
        spec[:, yp, xp] = nv3
        spec[:, np.asarray(cys), np.asarray(cxs)] = np.conj(nv3)
        out = self._ifft_quantize(spec, params, H, W)
        return (out, nv3) if return_targets else out

    @staticmethod
    def _alpha(base, mag, med, adaptive):
        base = np.broadcast_to(np.asarray(base, mag.dtype), mag.shape)
        if not adaptive:
            return base
        return base * np.clip(mag / np.maximum(1e-12, med), 0.5, 2.0)

    def read_bits(self, spec, med, idx, jitters, alpha, params):
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        th = np.angle(v)
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        base = th - np.asarray(jitters)
        return (np.cos(base - a) >= np.cos(base + a)).astype(np.uint8)

    def read_values(self, spec, med, idx, jitters, alpha, params):
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        th = np.angle(v)
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        return mag * np.sin(th - np.asarray(jitters)) * np.sign(np.sin(a))

    def read_values_qim(self, spec, idx, dithers, L):
        """f64 oracle of ops.phase.read_values_qim."""
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        mag = np.maximum(1e-12, np.abs(v))
        return -np.cos(L * (np.angle(v) - np.asarray(dithers))) * mag

    def read_bits_qim(self, spec, idx, dithers, L):
        return (self.read_values_qim(spec, idx, dithers, L) >= 0).astype(
            np.uint8)

    def read_values_coherent(self, spec, idx_yx, jitters, alpha):
        """f64 oracle of ops.phase.read_values_coherent."""
        y, x = (np.asarray(a) for a in idx_yx)
        _v3, mag3, S, th = self._coherent_theta(spec, y, x)
        w = np.abs(S) * mag3.mean(axis=0)
        base = th - np.asarray(jitters)
        return w * np.sin(base) * np.sign(np.sin(alpha))

    def read_bits_coherent(self, spec, idx_yx, jitters, alpha):
        return (self.read_values_coherent(spec, idx_yx, jitters, alpha)
                >= 0).astype(np.uint8)

    def read_values_coherent_qim(self, spec, idx_yx, dithers, L):
        """f64 oracle of ops.phase.read_values_coherent_qim."""
        y, x = (np.asarray(a) for a in idx_yx)
        _v3, mag3, S, th = self._coherent_theta(spec, y, x)
        w = np.abs(S) * mag3.mean(axis=0)
        return -np.cos(L * (th - np.asarray(dithers))) * w

    def read_bits_coherent_qim(self, spec, idx_yx, dithers, L):
        return (self.read_values_coherent_qim(spec, idx_yx, dithers, L)
                >= 0).astype(np.uint8)


def _backend_on(params, dev: torch.device) -> TorchBackend | NumpyBackend:
    if params.fft_dtype == "complex128":
        if dev.type == "cpu":
            return NumpyBackend()
        return TorchBackend(dev, torch.complex128)
    return TorchBackend(dev)


def get_backend(params, device=None) -> TorchBackend | NumpyBackend:
    """The backend on `device` (default CUDA; runtime.resolve_device): the
    f32 torch backend, or under Params.fft_dtype="complex128" the f64 host
    backend on the CPU and the f64 torch backend on a card."""
    return _backend_on(params, runtime.resolve_device(device))


def backend_input(img, params, device=None):
    """(backend, the image as that backend takes it, H, W) for an (H, W, 3)
    u8 image: a tensor runs on its own device, a numpy image on `device`
    (default CUDA), through get_backend's choice there."""
    dev = runtime.resolve_device(device, like=img)
    backend = _backend_on(params, dev)
    if isinstance(backend, NumpyBackend):
        host = img.numpy() if isinstance(img, torch.Tensor) else img
        src = np.asarray(host)
    else:
        src = runtime.to_device(img, dev)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {tuple(src.shape)}")
    return backend, src, *src.shape[:2]
