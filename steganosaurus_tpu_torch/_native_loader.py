"""Loader for the C++ native host library (native/) — the port's copy of
steganosaurus_tpu/_native_loader.py.

The library provides the hot host-side paths: ChaCha20-Poly1305 AEAD, the
mlock'd key vault, the sequential turtle-walk expansion (the reference's
only truly sequential component, steganosaur.cpp:665-810) and the RS codec.
The port loads only its own build of the repository's native/*.cc sources
(``_build.native_library_path``, compiled by ``_build.ensure_native``);
until that exists, or with STEGANOSAURUS_NO_NATIVE=1, get() returns None and
the callers take their pure-Python twins.
"""

from __future__ import annotations

import ctypes
import os
import threading

_lock = threading.Lock()
_loaded = False
_lib = None


class NativeLib:
    """ctypes wrapper around native/capi.cc."""

    def __init__(self, path):
        self._dll = ctypes.CDLL(str(path))
        d = self._dll
        u8p = ctypes.POINTER(ctypes.c_uint8)

        d.stego_aead_seal.restype = ctypes.c_int
        d.stego_aead_seal.argtypes = [u8p, u8p, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, u8p, u8p, ctypes.c_int]
        d.stego_aead_open.restype = ctypes.c_int
        d.stego_aead_open.argtypes = [u8p, u8p, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, u8p, u8p, ctypes.c_int]
        d.stego_turtle_expand.restype = ctypes.c_longlong
        d.stego_turtle_expand.argtypes = [
            u8p, u8p, u8p, u8p,                       # walk/r/g/b keys (32B each)
            ctypes.c_int, ctypes.c_int,               # H, W (padded)
            ctypes.c_double, ctypes.c_double,         # rmin, rmax
            ctypes.c_double, ctypes.c_double,         # density, jitter_max
            ctypes.c_longlong, ctypes.c_longlong,     # nbits, max_steps
            ctypes.c_int,                             # allow_short
            ctypes.POINTER(ctypes.c_int32),           # out plane
            ctypes.POINTER(ctypes.c_int32),           # out y
            ctypes.POINTER(ctypes.c_int32),           # out x
            ctypes.POINTER(ctypes.c_double),          # out jitter
        ]
        # visited-bitmap chaining (per-image walks)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        ea = d.stego_turtle_expand.argtypes
        d.stego_turtle_expand_v.restype = ctypes.c_longlong
        d.stego_turtle_expand_v.argtypes = ea + [u64p, u64p]
        # coherent site semantics (Params.coherent): the expand args with
        # `int coherent` inserted after allow_short (index 12), then the two
        # visited-bitmap pointers
        d.stego_turtle_expand_vc.restype = ctypes.c_longlong
        d.stego_turtle_expand_vc.argtypes = (
            ea[:13] + [ctypes.c_int] + ea[13:] + [u64p, u64p])
        # key vault (native/keyvault.cc): mlock'd derived-key slots
        sz = ctypes.c_size_t
        d.stego_kv_derive_pass.restype = ctypes.c_int
        d.stego_kv_derive_pass.argtypes = [u8p, sz, u8p, sz,
                                           ctypes.c_uint32, u8p]
        d.stego_kv_derive_raw.restype = ctypes.c_int
        d.stego_kv_derive_raw.argtypes = [u8p, sz, u8p, sz, u8p]
        d.stego_kv_seal.restype = ctypes.c_int
        d.stego_kv_seal.argtypes = [ctypes.c_int, u8p, sz, u8p, sz,
                                    u8p, u8p, ctypes.c_int]
        d.stego_kv_open.restype = ctypes.c_int
        d.stego_kv_open.argtypes = [ctypes.c_int, u8p, sz, u8p, sz,
                                    u8p, u8p, ctypes.c_int]
        d.stego_kv_hkdf.restype = ctypes.c_int
        d.stego_kv_hkdf.argtypes = [ctypes.c_int, u8p, sz, u8p, sz]
        d.stego_kv_destroy.restype = ctypes.c_int
        d.stego_kv_destroy.argtypes = [ctypes.c_int]
        # RS codec (native/rs.cc)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        ll = ctypes.c_longlong
        d.stego_rs_encode.restype = ctypes.c_int
        d.stego_rs_encode.argtypes = [u8p, ll, ll, u8p]
        d.stego_rs_decode.restype = ctypes.c_int
        d.stego_rs_decode.argtypes = [u8p, ll, ll, u8p, i32p, i32p]
        d.stego_rs_decode_soft.restype = ctypes.c_int
        d.stego_rs_decode_soft.argtypes = [u8p, f32p, ll, ll, u8p, i32p]

    @staticmethod
    def _buf(b: bytes):
        return ctypes.cast(ctypes.create_string_buffer(b, len(b)), ctypes.POINTER(ctypes.c_uint8))

    def aead_seal(self, key: bytes, nonce: bytes, aad: bytes, pt: bytes,
                  ref_compat: bool = True) -> tuple[bytes, bytes]:
        ct = ctypes.create_string_buffer(max(len(pt), 1))
        tag = ctypes.create_string_buffer(16)
        rc = self._dll.stego_aead_seal(
            self._buf(key), self._buf(nonce),
            self._buf(aad), len(aad),
            self._buf(pt), len(pt),
            ctypes.cast(ct, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.cast(tag, ctypes.POINTER(ctypes.c_uint8)),
            int(ref_compat),
        )
        if rc != 0:
            raise RuntimeError("native aead_seal failed")
        return ct.raw[: len(pt)], tag.raw[:16]

    def aead_open(self, key: bytes, nonce: bytes, aad: bytes, ct: bytes, tag: bytes,
                  ref_compat: bool = True) -> bytes | None:
        pt = ctypes.create_string_buffer(max(len(ct), 1))
        rc = self._dll.stego_aead_open(
            self._buf(key), self._buf(nonce),
            self._buf(aad), len(aad),
            self._buf(ct), len(ct),
            self._buf(tag),
            ctypes.cast(pt, ctypes.POINTER(ctypes.c_uint8)),
            int(ref_compat),
        )
        if rc != 0:
            return None
        return pt.raw[: len(ct)]

    def turtle_expand(self, walk_key, plane_keys, H, W, rmin, rmax, density,
                      jitter_max, nbits, max_steps, allow_short=False):
        import numpy as np

        plane = np.empty(nbits, dtype=np.int32)
        y = np.empty(nbits, dtype=np.int32)
        x = np.empty(nbits, dtype=np.int32)
        jit = np.empty(nbits, dtype=np.float64)
        rc = self._dll.stego_turtle_expand(
            self._buf(walk_key), self._buf(plane_keys[0]),
            self._buf(plane_keys[1]), self._buf(plane_keys[2]),
            H, W, rmin, rmax, density, jitter_max, nbits, max_steps,
            int(allow_short),
            plane.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            jit.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if rc < 0:
            raise RuntimeError(
                f"native turtle_expand failed (rc={rc}): walk exhausted the "
                f"step budget — image too small for the requested bit count?"
            )
        return plane, y, x, jit, int(rc)

    def kv_derive_pass(self, password: bytes, salt: bytes, iters: int):
        """Derive into a vault slot from a passphrase -> (handle, nonce)."""
        nonce = ctypes.create_string_buffer(12)
        h = self._dll.stego_kv_derive_pass(
            self._buf(password), len(password), self._buf(salt), len(salt),
            iters, ctypes.cast(nonce, ctypes.POINTER(ctypes.c_uint8)))
        return h, nonce.raw[:12]

    def kv_derive_raw(self, master: bytes, salt: bytes):
        nonce = ctypes.create_string_buffer(12)
        h = self._dll.stego_kv_derive_raw(
            self._buf(master), len(master), self._buf(salt), len(salt),
            ctypes.cast(nonce, ctypes.POINTER(ctypes.c_uint8)))
        return h, nonce.raw[:12]

    def kv_seal(self, h: int, aad: bytes, pt: bytes,
                ref_compat: bool = True):
        ct = ctypes.create_string_buffer(max(len(pt), 1))
        tag = ctypes.create_string_buffer(16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = self._dll.stego_kv_seal(
            h, self._buf(aad), len(aad), self._buf(pt), len(pt),
            ctypes.cast(ct, u8p), ctypes.cast(tag, u8p), int(ref_compat))
        if rc != 0:
            raise RuntimeError(f"native kv_seal failed (rc={rc})")
        return ct.raw[: len(pt)], tag.raw[:16]

    def kv_open(self, h: int, aad: bytes, ct: bytes, tag: bytes,
                ref_compat: bool = True):
        pt = ctypes.create_string_buffer(max(len(ct), 1))
        rc = self._dll.stego_kv_open(
            h, self._buf(aad), len(aad), self._buf(ct), len(ct),
            self._buf(tag),
            ctypes.cast(pt, ctypes.POINTER(ctypes.c_uint8)),
            int(ref_compat))
        if rc == -2:
            raise RuntimeError("native kv_open: bad vault handle")
        if rc != 0:
            return None
        return pt.raw[: len(ct)]

    def kv_hkdf(self, h: int, info: bytes, n: int) -> bytes:
        out = ctypes.create_string_buffer(max(n, 1))
        rc = self._dll.stego_kv_hkdf(
            h, self._buf(info), len(info),
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), n)
        if rc != 0:
            raise RuntimeError(f"native kv_hkdf failed (rc={rc})")
        return out.raw[:n]

    def kv_destroy(self, h: int) -> None:
        self._dll.stego_kv_destroy(h)

    def rs_encode(self, msgs, m: int):
        """RS(255,223)-interleave-encode nmsg messages of m bytes each.
        `msgs`: contiguous uint8 array (nmsg*m,). Returns (nmsg*coded_len,)."""
        import numpy as np

        msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
        nmsg = msgs.size // m
        cl = m + 32 * max(1, -(-m // 223))
        out = np.empty(nmsg * cl, dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = self._dll.stego_rs_encode(
            msgs.ctypes.data_as(u8p), nmsg, m, out.ctypes.data_as(u8p))
        if rc != 0:
            raise RuntimeError(f"native rs_encode failed (rc={rc})")
        return out

    def rs_decode(self, coded, m: int, conf=None):
        """Decode nmsg interleaved streams; errors-and-erasures when `conf`
        (float32, one per coded byte) is given. Returns (msgs, ok, nerr) —
        nerr is None on the soft path."""
        import numpy as np

        coded = np.ascontiguousarray(coded, dtype=np.uint8)
        cl = m + 32 * max(1, -(-m // 223))
        nmsg = coded.size // cl
        out = np.empty(nmsg * m, dtype=np.uint8)
        ok = np.empty(nmsg, dtype=np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        if conf is None:
            nerr = np.empty(nmsg, dtype=np.int32)
            rc = self._dll.stego_rs_decode(
                coded.ctypes.data_as(u8p), nmsg, m,
                out.ctypes.data_as(u8p), ok.ctypes.data_as(i32p),
                nerr.ctypes.data_as(i32p))
        else:
            nerr = None
            conf = np.ascontiguousarray(conf, dtype=np.float32)
            rc = self._dll.stego_rs_decode_soft(
                coded.ctypes.data_as(u8p),
                conf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                nmsg, m, out.ctypes.data_as(u8p),
                ok.ctypes.data_as(i32p))
        if rc != 0:
            raise RuntimeError(f"native rs_decode failed (rc={rc})")
        return out, ok.astype(bool), nerr

    def turtle_expand_v(self, walk_key, plane_keys, H, W, rmin, rmax,
                        density, jitter_max, nbits, max_steps,
                        allow_short=False, init_visited=None,
                        want_visited=False, coherent=False):
        """turtle_expand with visited-bitmap chaining (per-image-walk mode).

        init_visited: uint64 array of (3*H*W + 63)//64 words, or None.
        want_visited=True appends the final visited bitmap to the return:
        (plane, y, x, jitter, nproduced[, visited]).
        coherent=True selects the coherent site semantics (Params.coherent;
        stego_turtle_expand_vc).
        """
        import numpy as np

        nwords = (3 * H * W + 63) // 64
        plane = np.empty(nbits, dtype=np.int32)
        y = np.empty(nbits, dtype=np.int32)
        x = np.empty(nbits, dtype=np.int32)
        jit = np.empty(nbits, dtype=np.float64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        if init_visited is not None:
            init_visited = np.ascontiguousarray(init_visited, dtype=np.uint64)
            assert init_visited.shape == (nwords,)
            init_p = init_visited.ctypes.data_as(u64p)
        else:
            init_p = None
        out_vis = np.zeros(nwords, dtype=np.uint64) if want_visited else None
        args = [
            self._buf(walk_key), self._buf(plane_keys[0]),
            self._buf(plane_keys[1]), self._buf(plane_keys[2]),
            H, W, rmin, rmax, density, jitter_max, nbits, max_steps,
            int(allow_short),
        ]
        if coherent:
            args.append(1)
        args += [
            plane.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            jit.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            init_p,
            out_vis.ctypes.data_as(u64p) if want_visited else None,
        ]
        fn = (self._dll.stego_turtle_expand_vc if coherent
              else self._dll.stego_turtle_expand_v)
        rc = fn(*args)
        if rc < 0:
            raise RuntimeError(
                f"native turtle_expand_v failed (rc={rc}): walk exhausted "
                f"the step budget"
            )
        out = (plane, y, x, jit, int(rc))
        return out + (out_vis,) if want_visited else out


def get() -> NativeLib | None:
    """The loaded native library, or None while the port's build of it does
    not exist yet (or STEGANOSAURUS_NO_NATIVE is set). Never builds."""
    global _loaded, _lib
    if os.environ.get("STEGANOSAURUS_NO_NATIVE"):
        return None
    with _lock:
        if not _loaded:
            from steganosaurus_tpu_torch import _build

            path = _build.native_library_path()
            if path.exists():
                _lib = NativeLib(path)
                _loaded = True
        return _lib
