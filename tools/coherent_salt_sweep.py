"""Salt sweep of the coherent write: at which salts each package's own f32
round trip misses, on tests/test_coherent.py's compositions.

    JAX_PLATFORMS=cpu python tools/coherent_salt_sweep.py N [INDEX ...]

For each composition (INDEX into EXTRAS, all nine by default) and each
salt default_rng(1000 + s).bytes(16), s < N: the composition's 256x256
cover (tests/test_coherent.py's seed), its 18-byte secret, pbkdf2_iter=100;
the JAX package's embed_array read back by its extract_array, and the
port's (steganosaurus_tpu_torch, on the CPU) by its own. Prints one JSON
line per composition: the salts where each package missed. Each salt
takes about 0.25 s on one CPU core.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import steganosaurus_tpu_torch as stt  # noqa: E402
from steganosaurus_tpu.config import Params as JParams  # noqa: E402
from steganosaurus_tpu.pipeline import embed as jembed_mod  # noqa: E402
from steganosaurus_tpu.pipeline import errors as jerrors  # noqa: E402
from steganosaurus_tpu.pipeline import extract as jextract_mod  # noqa: E402
from steganosaurus_tpu_torch.config import Params  # noqa: E402
from steganosaurus_tpu_torch.pipeline.errors import StegoError  # noqa: E402

# tests/test_coherent.py's compositions, in its order
EXTRAS = [dict(), dict(soft_write=True), dict(qim=8), dict(rs=True),
          dict(qim=8, rs=True, pad_quantum=32), dict(write_floor=0.45),
          dict(alpha_spread=0.5), dict(jitter=0.25),
          dict(per_image_walk=True)]
SECRET = b"coherent roundtrip"


def misses(extra: dict, n: int) -> dict:
    rng = np.random.default_rng(sum(map(ord, repr(sorted(extra)))))
    cover = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    jp = JParams(pbkdf2_iter=100, coherent=True, **extra)
    tp = Params(pbkdf2_iter=100, coherent=True, **extra)
    out = {"jax": [], "port": []}
    for s in range(n):
        salt = np.random.default_rng(1000 + s).bytes(16)
        stego = np.asarray(jembed_mod.embed_array(
            cover, SECRET, password="pw", params=jp, salt=salt).stego)
        try:
            ok = jextract_mod.extract_array(
                stego, password="pw",
                params=JParams(pbkdf2_iter=100)) == SECRET
        except jerrors.StegoError:
            ok = False
        if not ok:
            out["jax"].append(s)
        stego = stt.embed_array(cover, SECRET, password="pw", params=tp,
                                salt=salt, device="cpu").stego
        try:
            ok = stt.extract_array(stego, password="pw",
                                   params=Params(pbkdf2_iter=100),
                                   device="cpu") == SECRET
        except StegoError:
            ok = False
        if not ok:
            out["port"].append(s)
    return out


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    n = int(argv[0])
    for i in [int(a) for a in argv[1:]] or range(len(EXTRAS)):
        m = misses(EXTRAS[i], n)
        print(json.dumps({"composition": repr(EXTRAS[i]), "salts": n,
                          "jax_f32_misses": m["jax"],
                          "port_f32_misses": m["port"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
