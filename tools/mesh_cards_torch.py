"""The port's mesh over every CUDA card of the machine.

    python3 tools/mesh_cards_torch.py

Runs the 4K UHD B=64 16 KB round trip (chip_smoke.py's covers, secrets,
salts and key) unsharded on card 0, over make_mesh() (every card) and over
as many logical shards of card 0, each twice; then two other wire modes at
4K B=16 16 KB, Params(adaptive_alpha=True) (the full-grid cores, torch.fft
per shard) and Params(per_image_walk=True, rs=True), each unsharded, over
the logical shards and twice over the cards; then a 4-batch stream over
both meshes, then parallel/fft_dist's sharded embed of one 4K cover over
the cards and over the logical shards, five times each, and the sharded
median, five times each. Prints the card names and power limits, every
recovery count, warm times (host clock ending in a synchronize of every
card), K1 launches per run, and the stego and plane differences between
the three placements. A lost secret, a stego over the cards that is not
byte-equal to the logical shards' (or to its own repeat), a sharded embed
that differs from the placement's first, or a sharded median that
differs from the bisection of the gathered spectrum raises. Needs at
least one CUDA card; with one card both meshes are that card.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import parallel, runtime, spectral
    from steganosaurus_tpu_torch.ops import phase as phase_ops
    from steganosaurus_tpu_torch.ops import stats
    from steganosaurus_tpu_torch.parallel import fft_dist
    from steganosaurus_tpu_torch.pipeline import batch as pb
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    runtime.require_cuda()
    runtime.configure_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    cs.phase_build()
    covers = (torch.from_numpy(cs.make_covers(cs.UHD_BASE, cs.UHD_H,
                                              cs.UHD_W)).to(dev)
              .permute(0, 3, 1, 2).repeat(2, 1, 1, 1).contiguous())
    B = covers.shape[0]
    secrets = cs.secrets_for(B, cs.UHD_SECRET)
    salts = [bytes([i]) * 16 for i in range(B)]
    cards = parallel.make_mesh()
    logical = parallel.make_mesh(cards.size, device=dev)
    print(f"cards: {list(cards.devices)}", flush=True)

    def compare(stegos: dict, what: str) -> None:
        """Print the stego differences between the placements; the cards'
        must equal the logical shards' and their own repeat byte for byte
        (the same per-shard work on the same card model)."""
        for a, b in (("cards", "logical"), ("cards", "unsharded"),
                     ("cards", "cards, again")):
            d = (stegos[a].to(torch.int16) - stegos[b].to(torch.int16)).abs()
            print(f"{what}stego {a} vs {b}: {d.count_nonzero().item()} of "
                  f"{d.numel()} bytes differ, max {d.max().item()}",
                  flush=True)
            if b != "unsharded" and d.count_nonzero().item():
                raise AssertionError(f"{what}stego over the cards differs "
                                     f"from {b}")

    stegos = {}
    for name, mesh in (("unsharded", None), ("logical", logical),
                       ("cards", cards), ("cards, again", cards),
                       ("logical, again", logical),
                       ("unsharded, again", None)):
        for k in ck.LAUNCHES:
            ck.LAUNCHES[k] = 0
        sync()
        t0 = time.perf_counter()
        res = stt.embed_batch(covers, secrets, master_key=cs.MASTER_KEY,
                              salts=salts, mesh=mesh, device_resident=True,
                              layout="nchw")
        sync()
        t1 = time.perf_counter()
        got = stt.extract_batch(res.stego, master_key=cs.MASTER_KEY,
                                clen_hint=cs.UHD_SECRET, layout="nchw")
        sync()
        t2 = time.perf_counter()
        n_ok = sum(g == s for g, s in zip(got, secrets))
        stegos[name] = res.stego if mesh is None else res.stego.gather(dev)
        print(f"{name}: recovered {n_ok}/{B}, embed {(t1 - t0) * 1e3!r} ms, "
              f"extract {(t2 - t1) * 1e3!r} ms, round trip "
              f"{(t2 - t0) * 1e3!r} ms, K1 {dict(ck.LAUNCHES)}", flush=True)
        if n_ok != B:
            raise AssertionError(f"{name} recovered {n_ok}/{B}")
    compare(stegos, "")

    for mode, p, layout in (
            ("adaptive_alpha", stt.Params(adaptive_alpha=True), "nhwc"),
            ("per_image_walk + rs", stt.Params(per_image_walk=True, rs=True),
             "nchw")):
        n = cs.ADAPTIVE_B
        imgs = covers[:n] if layout == "nchw" else (
            covers[:n].permute(0, 2, 3, 1).contiguous())
        out = {}
        for name, mesh in (("unsharded", None), ("logical", logical),
                           ("cards", cards), ("cards, again", cards)):
            for k in ck.LAUNCHES:
                ck.LAUNCHES[k] = 0
            sync()
            t0 = time.perf_counter()
            res = stt.embed_batch(imgs, secrets[:n], master_key=cs.MASTER_KEY,
                                  params=p, salts=salts[:n], mesh=mesh,
                                  device_resident=True, layout=layout)
            got = stt.extract_batch(res.stego, master_key=cs.MASTER_KEY,
                                    params=p, layout=layout,
                                    clen_hint=pb._wire_clen(cs.UHD_SECRET, p))
            sync()
            dt = time.perf_counter() - t0
            n_ok = sum(g == s for g, s in zip(got, secrets))
            out[name] = res.stego if mesh is None else res.stego.gather(dev)
            print(f"{mode} 4K B={n}, {name}: recovered {n_ok}/{n}, round "
                  f"trip {dt * 1e3!r} ms, K1 {dict(ck.LAUNCHES)}", flush=True)
            if n_ok != n:
                raise AssertionError(f"{mode} {name} recovered {n_ok}/{n}")
        compare(out, f"{mode} ")

    for name, mesh in (("cards", cards), ("logical", logical)):
        sync()
        t = time.perf_counter()
        embeds = stt.embed_stream(((covers, secrets, salts) for _ in range(4)),
                                  master_key=cs.MASTER_KEY, mesh=mesh,
                                  depth=2, layout="nchw")
        n_ok = [sum(g == s for g, s in zip(got, secrets))
                for got in stt.extract_stream(
                    (r.stego for r in embeds), master_key=cs.MASTER_KEY,
                    mesh=mesh, clen_hint=cs.UHD_SECRET, depth=2,
                    layout="nchw")]
        sync()
        dt = time.perf_counter() - t
        print(f"stream over {name}, 4 batches of {B}: recovered {n_ok}, "
              f"{4 * B / dt!r} img/s", flush=True)
        if n_ok != [B] * 4:
            raise AssertionError(f"stream over {name} recovered {n_ok}")

    p = stt.Params()
    planes = covers[0].to(torch.float32)
    H, W = planes.shape[-2:]
    nbits = 912 + (cs.UHD_SECRET + 16) * 8 * 7
    walk = pb._walk_indices(None, cs.MASTER_KEY, p, H, W, nbits,
                            allow_short=True)[:4]
    pl, yy, xx = (torch.from_numpy(np.array(a[:nbits])).to(dev).long()
                  for a in walk[:3])
    jj = torch.from_numpy(np.array(walk[3][:nbits])).to(dev)
    bits = torch.from_numpy(np.random.default_rng(9).integers(
        0, 2, nbits, dtype=np.uint8)).to(dev)
    kw = dict(floor=p.write_floor, img_pixels=float(H * W))
    planes_of = {}
    for name, mesh in (("cards", parallel.make_mesh(axis="image")),
                       ("logical", parallel.make_mesh(cards.size,
                                                      axis="image",
                                                      device=dev))):
        def embed(mesh=mesh):
            return fft_dist.embed_core_distributed(
                planes, pl, yy, xx, bits, jj, p.alpha, mesh, **kw).gather(dev)

        planes_of[name] = embed()
        sync()
        t = time.perf_counter()
        runs = [embed() for _ in range(5)]
        sync()
        ms = (time.perf_counter() - t) / 5 * 1e3
        same = [torch.equal(r, planes_of[name]) for r in runs]
        spec = fft_dist.fft2_distributed(planes, mesh)
        mags = spec.gather(dev).abs().reshape(3, -1)
        ref = stats.kth_smallest_nonneg(mags, mags.shape[-1] // 2)
        meds = [fft_dist.median_abs_distributed(spec, mesh) for _ in range(5)]
        print(f"fft_dist embed over {name}: {ms!r} ms a call (host clock, "
              f"5 calls), equal to the first: {same}; median "
              f"{[m.tolist() for m in meds]}, bisection of the gathered "
              f"spectrum {ref.tolist()}", flush=True)
        if not all(same) or not all(torch.equal(m, ref) for m in meds):
            raise AssertionError(f"fft_dist over {name} is not repeatable")
    ref = spectral.ifft2_real(phase_ops.embed_phases(
        spectral.fft2(planes), pl, yy, xx, bits, jj, p.alpha, None, False,
        **kw))
    print(f"fft_dist planes: cards vs logical max "
          f"{(planes_of['cards'] - planes_of['logical']).abs().max().item()!r}"
          f", cards vs unsharded "
          f"{(planes_of['cards'] - ref).abs().max().item()!r}", flush=True)
    return 0


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="stt_walk_") as walk_cache:
        os.environ["STEGANOSAURUS_WALK_CACHE"] = walk_cache
        sys.exit(main())
