"""Another commit's kernel sources, for timing and comparing them with the
committed ones on a CUDA card.

    python3 tools/parent_kernels_torch.py REV [NAME ...]

copies steganosaurus_tpu_torch/csrc/NAME (default: corner_ifft_y.cu,
corner_stage2.cu and corner_ifft_epilogue.cu) of commit REV out of git into
build/parents/REV/ (gitignored), where `--parent REV` of
tools/k{2,4,5,6}_ablation_torch.py, and the card tests that hold K6, K2 and
K4 to BITS_OF, find them in a copy of the checkout that has no git
history. A source put there by hand, build/parents/NAME/corner_ifft_y.cu,
is taken as revision NAME's. A parent's C entry whose signature has
changed since (OLD_SIGNATURES) is bound by old_entry.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PARENTS = REPO / "build" / "parents"
# the commit whose K6, K2 and K4 outputs their redesigns keep bit for bit
# (its K4 source is the first version's, unchanged until the redesign)
BITS_OF = "19a22bf762a2ba9d61f18feb16665e24a98a277f"
SOURCES = ("corner_ifft_y.cu", "corner_stage2.cu", "corner_ifft_epilogue.cu")
# C entries that parent commits export under another signature than the
# committed one, name -> argtypes: K5's corner_read_decode up to d14bcd8
# (the gather, which read the walk's int64 plane/y/x and took its image
# groups, grid.y, in place of a read plan); K2's corner_stage2, its band
# pass and its grid up to 4f717a6 (a band of one group of 64 columns, and
# the bulk, always: no nb and no bulk flag); K1's corner_stage1_wgmma up to
# 5b99743 (an exr-then-exi table of 2 Kxp rows, no prep in its epilogue)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {"corner_read_decode": [_P] * 9 + [_I] * 8 + [_F, _P],
                  "corner_stage1_wgmma": [_P] * 4 + [_I] * 8 + [_P],
                  "corner_stage2": [_P] * 8 + [_I] * 8 + [_P],
                  "corner_stage2_band": [_P] * 5 + [_I] * 3 + [_P],
                  "corner_stage2_grid": [_I] * 3}


def parent_source(rev: str, name: str) -> pathlib.Path | None:
    """csrc/`name` of commit `rev`: build/parents/<rev>/<name>, taken out of
    git where it is missing; None where neither has it."""
    path = PARENTS / rev / name
    if not path.exists():
        try:
            text = subprocess.run(
                ["git", "-C", str(REPO), "show",
                 f"{rev}:steganosaurus_tpu_torch/csrc/{name}"],
                capture_output=True, text=True, check=True, timeout=60).stdout
        except (OSError, subprocess.SubprocessError):
            return None
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def parent_kernels(rev: str, name: str):
    """(Kernels whose entry points of csrc/`name` are commit `rev`'s and
    every other one the committed build's, ptxas's report), built into
    build/parents/<rev>/; None where the source cannot be had."""
    from steganosaurus_tpu_torch import _build

    src = parent_source(rev, name)
    if src is None:
        return None
    # one library per source: a process that dlopens a second build under
    # a path it has loaded gets the first library back
    key = f"parent {pathlib.Path(name).stem}"
    libs, reports = _build.build_variants(name, {key: src}, src.parent)
    return libs[key], reports[key]


def c_kinds(text: str, name: str) -> list:
    """"p", "i" or "f" for each argument of the C entry `name` in the
    source text `text` (pointer, int, float)."""
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
    if m is None:
        raise ValueError(f"no C entry {name} in the source")
    return ["p" if "*" in a else "f" if a.strip().startswith("float")
            else "i" for a in m.group(1).split(",")]


def kinds_of(argtypes) -> list:
    """c_kinds' letters of a ctypes argtypes list."""
    return ["p" if t is _P else "f" if t is _F else "i" for t in argtypes]


def takes_old_signature(source: pathlib.Path, name: str) -> bool:
    """Whether the C entry `name` in the .cu file `source` has its
    OLD_SIGNATURES signature (bind it with old_entry)."""
    return c_kinds(source.read_text(), name) == kinds_of(
        OLD_SIGNATURES[name])


def old_entry(lib: pathlib.Path, name: str):
    """The C entry `name` of a parent's built library `lib`, bound with its
    old signature (OLD_SIGNATURES[name])."""
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = OLD_SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rev = sys.argv[1]
    for name in sys.argv[2:] or SOURCES:
        path = parent_source(rev, name)
        if path is None:
            print(f"{name} of {rev}: not found", file=sys.stderr)
            return 1
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
