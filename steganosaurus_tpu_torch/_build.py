"""Builds what the port needs on the card's machine, from this checkout only.

1. The CUDA kernels: each ``csrc/*.cu`` is compiled by nvcc for sm_90a into
   a shared library of its own with a plain C interface, all nvcc runs
   started together, each named by a hash of its source and the flags,
   under ``build/kernels/`` (gitignored), and loaded with ctypes. A source
   edit changes the hash, so a stale library is never loaded. The wgmma
   kernel reaches the driver's cuTensorMapEncodeTiled through
   cudaGetDriverEntryPoint, so no library links against libcuda.
2. The host native library (native/: AEAD, key vault, turtle walk, RS).
   Without it the pure-Python turtle walk is ~1000x slower, which at
   4K/16 KB eats any time budget. g++ compiles the repository's native/*.cc
   into ``build/native/<digest>/`` (gitignored), named by a hash of the
   sources, headers and flags, and the port's own _native_loader loads it.
   The JAX package's build directory (native/build/) is never touched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

PKG = pathlib.Path(__file__).resolve().parent
REPO = PKG.parent
CSRC = PKG / "csrc"
BUILD = REPO / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Flags of one source on top of NVCC_FLAGS: the elementwise kernels must
# round op by op as torch's eager ops do, so nvcc may not contract a
# product and a sum into one FMA there.
NVCC_SOURCE_FLAGS = {"corner_write_floor.cu": ["-fmad=false"],
                     "corner_epilogue.cu": ["-fmad=false"],
                     "corner_ifft_epilogue.cu": ["-fmad=false"],
                     "corner_stage2.cu": ["-fmad=false"],
                     "corner_read_decode.cu": ["-fmad=false"]}
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_kernels: "Kernels | None" = None

# C entry points of csrc/*.cu: name -> argtypes. Pointers and the stream are
# c_void_p (a bare int would be cut to 32 bits), sizes and flags c_int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "corner_stage1_wgmma": [_P] * 7 + [_I] * 10 + [_P],
    "corner_write_floor": [_P] * 15 + [_I] * 6 + [_F, _F, _I, _F, _F, _F,
                                              _I, _I, _I, _P],
    "corner_write_floor_grid": [_I, _I],
    "corner_floor_only": [_P] * 8 + [_I, _I, _I, _F, _F, _F, _P],
    "corner_epilogue": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "corner_ifft_epilogue": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    "corner_ifft_epilogue_grid": [_I, _I, _I, _I],
    "corner_stage2_prep": [_P] * 5 + [_I] * 4 + [_P],
    "corner_stage2_prep_reduce": [_P] * 2 + [_I] * 3 + [_P],
    "corner_stage2_band": [_P] * 5 + [_I] * 4 + [_P],
    "corner_stage2": [_P] * 8 + [_I] * 10 + [_P],
    "corner_stage2_grid": [_I] * 5,
    "corner_ifft_y": [_P] * 5 + [_I] * 8 + [_P],
    "corner_read_decode": [_P] * 11 + [_I] * 8 + [_F, _P],
}


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of nvcc: on PATH, else the CUDA toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _compile(cmds: list[tuple[list[str], pathlib.Path]]) -> None:
    """Run the compilers, all at once, each into a temporary name, then
    rename: a cut-off build never leaves a half-written library under the
    final name."""
    procs = []
    for cmd, out in cmds:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        procs.append((cmd, out, tmp, subprocess.Popen(
            cmd + ["-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, out, tmp, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"build failed: {' '.join(cmd)}\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


class Kernels:
    """The loaded kernel libraries: each C entry point of _SIGNATURES as an
    attribute, and the path of the library that holds it."""

    def __init__(self, libs: dict[str, pathlib.Path]):
        self.paths = {}
        for src, path in libs.items():
            dll = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name, None)
                if fn is None:
                    continue
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name, fn)
                self.paths[name] = path
        missing = set(_SIGNATURES) - set(self.paths)
        if missing:
            raise RuntimeError(f"kernel entry points not found: {missing}")


def kernel_library() -> Kernels:
    """The loaded CUDA kernel libraries, built on first use."""
    global _kernels
    with _lock:
        if _kernels is None:
            flags = {src: NVCC_FLAGS + NVCC_SOURCE_FLAGS.get(src.name, [])
                     for src in sorted(CSRC.glob("*.cu"))}
            libs = {src: BUILD / "kernels" / (
                f"lib{src.stem}_{_digest([src], f)}.so")
                for src, f in flags.items()}
            _compile([([nvcc(), *flags[src], str(src)], lib)
                      for src, lib in libs.items() if not lib.exists()])
            _kernels = Kernels(libs)
        return _kernels


def build_variants(source: str, variants: dict, work: pathlib.Path) -> tuple:
    """Build variants of one csrc/*.cu (`source`, its file name): each of
    `variants` (name -> the variant's .cu path) with that source's flags
    and ptxas's report, all nvcc runs at once, into work/<name>.so. Returns
    (name -> Kernels whose entry points of the variant come from it and
    every other one from the committed build, name -> ptxas's report).
    Raises if a build fails."""
    base = kernel_library()
    flags = NVCC_FLAGS + NVCC_SOURCE_FLAGS.get(source, []) + ["-Xptxas", "-v"]
    work.mkdir(parents=True, exist_ok=True)
    libs = {name: work / (re.sub(r"\W+", "_", name) + ".so")
            for name in variants}
    procs = {name: subprocess.Popen(
        [nvcc(), *flags, str(cu), "-o", str(libs[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cu in variants.items()}
    reports = {}
    for name, proc in procs.items():
        reports[name], _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed\n"
                               f"{reports[name][-4000:]}")
    committed = {q: q for q in base.paths.values()}
    return ({name: Kernels({**committed, lib: lib})
             for name, lib in libs.items()}, reports)


def sass_counts(name: str, function: str,
                opcodes=("HGMMA", "UTMALDG", "LDL", "STL")) -> dict:
    """How often each SASS opcode occurs in the kernels whose (mangled) name
    holds `function`, in the built library that holds the C entry point
    `name` (cuobjdump -sass, beside nvcc). Raises if no kernel matches."""
    lib = kernel_library().paths[name]
    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", out, flags=re.M)
    code = "".join(body for fn, body in zip(parts[1::2], parts[2::2])
                   if function in fn)
    if not code:
        raise RuntimeError(f"no kernel named like {function!r} in {lib}")
    return {op: len(re.findall(rf"\b{op}\b", code)) for op in opcodes}


@functools.lru_cache(maxsize=1)
def native_library_path() -> pathlib.Path:
    """Where the port's build of native/ lives (it may not exist yet)."""
    native = REPO / "native"
    srcs = sorted(native.glob("*.cc")) + sorted(native.glob("*.h"))
    return (BUILD / "native" / _digest(srcs, GXX_FLAGS)
            / "libsteganosaurus_native.so")


def ensure_native():
    """The loaded host native library (the port's _native_loader), compiled
    from native/*.cc with g++ if missing. Raises if it cannot be built or
    loaded."""
    from steganosaurus_tpu_torch import _native_loader

    if os.environ.get("STEGANOSAURUS_NO_NATIVE"):
        raise RuntimeError("STEGANOSAURUS_NO_NATIVE is set: the port needs "
                           "the native host library")
    with _lock:
        so = native_library_path()
        if not so.exists():
            srcs = sorted((REPO / "native").glob("*.cc"))
            _compile([(["g++", *GXX_FLAGS, *map(str, srcs)], so)])
    lib = _native_loader.get()
    if lib is None:
        raise RuntimeError(f"host native library {so} failed to load")
    return lib
