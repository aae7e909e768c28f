"""The channel's bit error rate under each precision of forward stage 2's
band, or under each precision mode, on one CUDA card.

    python3 tools/band_ber_torch.py [--mode NAME ...] [OUT]

chip_smoke.py's 4K workload (2160x3840, B=64, 16 KB; seed-42 bench covers,
rng(7) secrets) embedded and read at three salt sets (bytes([i + s])*16
for s = 0, 64, 128; s = 0 is the stego phase 5c reports on), with forward
stage 2, at the embed and at every read, computed four ways on the card:

- "f32": corner._fwd_y_split, the eager chain K2 replaced (the band's
  columns in f32 products; band_columns' f32 energies);
- "bf16x3", "bf16x6": the plain versions of the prep and K2
  (corner_kernels.stage2_prep_plain, then fwd_stage2_plain with that band:
  split bf16 with two terms a value and three products, the TPU's
  Precision.HIGH, or three terms and six products, its HIGHEST);
- "kernel": the prep and K2 kernels, the default path.

and once more at s = 0 with the bf16x3 embed read by the f32 chain, which
tells a write's error from a read's. With --mode NAME (more than once for
several) it runs the card's path instead under each mode named
(STEGANOSAURUS_MM_PRECISION=NAME, embed and reads), beside mix_adaptive's
at the same salt sets, and the same qualification is taken against
mix_adaptive's BER. For each run: every secret read back
(extract_batch, with its soft-decision retry), channel_report's payload
and header raw and post-ECC BER with the images whose hard decode keeps a
wrong bit, and for the main salts quality_device's PSNR and SSIM. A band
precision qualifies where its payload raw BER is within 1% of the f32
band's and its payload post-ECC BER is 0 at every salt set, as the smoke's
5c requires of its stego. Prints one line each with the card's name and
power limit, and writes them to OUT (default build/band_ber.txt).
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
BER_REL = 0.01
SALT_SETS = (0, 64, 128)


def _args(argv):
    """(the modes of each --mode NAME, in order; the other arguments)."""
    modes, rest = [], []
    it = iter(argv)
    for a in it:
        if a == "--mode":
            modes.append(next(it))
        else:
            rest.append(a)
    return modes, rest


def main(argv=None) -> int:
    import os

    import torch

    names, rest = _args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(REPO))
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    for name in names:
        corner.resolve(name)   # an unknown name raises before any work
    if not torch.cuda.is_available():
        print("band_ber_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime

    out = pathlib.Path(rest[0]) if rest else (
        REPO / "build" / "band_ber.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    runtime.configure_precision()
    _build.ensure_native()
    card = chip_smoke.phase_probe()
    dev = torch.device("cuda", 0)
    B, n = chip_smoke.UHD_B, chip_smoke.UHD_SECRET
    base = chip_smoke.make_covers(chip_smoke.UHD_BASE, chip_smoke.UHD_H,
                                  chip_smoke.UHD_W)
    covers = torch.from_numpy(base).to(dev).permute(0, 3, 1, 2)
    covers = covers.repeat(-(-B // base.shape[0]), 1, 1, 1)[:B].contiguous()
    secrets = chip_smoke.secrets_for(B, n)
    mk = chip_smoke.MASTER_KEY

    def plain(band):
        def stage2(ar, ai, tabs, X0, adaptive, prep=None):
            prep = ck.stage2_prep_plain(ar, ai)
            idx = (corner.band_topk(prep[2], X0) if adaptive else
                   ck.static_band(ar.shape[0], X0, ar.device))
            return ck.fwd_stage2_plain(ar, ai, idx, tabs, band, prep)
        return stage2

    # forward stage 2's card route (corner._fwd_y_kernels) replaced by each
    # band precision; under --mode, the card route itself under each mode
    real = corner._fwd_y_kernels
    if names:
        modes = {name: real for name in ("mix_adaptive", *names)}
        runs = [(s, m, m) for s in SALT_SETS for m in modes]
        base = "mix_adaptive"
    else:
        def f32(ar, ai, tabs, X0, adaptive, prep=None):
            return corner._fwd_y_split(ar, ai, tabs, X0, adaptive)

        modes = {"f32": f32, "bf16x3": plain("bf16x3"),
                 "bf16x6": plain("bf16x6"), "kernel": real}
        runs = [(s, m, m) for s in SALT_SETS for m in modes]
        runs.insert(len(modes), (0, "bf16x3", "f32"))
        base = "f32"
    env = os.environ.get("STEGANOSAURUS_MM_PRECISION")
    raw, post = {}, {}
    f32_stego = None
    try:
        for s, em, rd in runs:
            salts = [bytes([(i + s) % 256]) * 16 for i in range(B)]
            if names:
                os.environ["STEGANOSAURUS_MM_PRECISION"] = em
            corner._fwd_y_kernels = modes[em]
            stego = stt.embed_batch(covers, secrets, master_key=mk,
                                    salts=salts, device_resident=True,
                                    layout="nchw").stego
            corner._fwd_y_kernels = modes[rd]
            got = stt.extract_batch(stego, master_key=mk, clen_hint=n,
                                    layout="nchw")
            rep = stt.channel_report(stego, secrets, salts, master_key=mk,
                                     layout="nchw", per_image=True)
            per = rep.pop("per_image")
            torch.cuda.synchronize()
            ok = sum(g == x for g, x in zip(got, secrets))
            bad_p = [i for i, r in enumerate(per)
                     if r["payload_ber_post_ecc"] > 0]
            bad_h = [i for i, r in enumerate(per)
                     if r["header_ber_post_ecc"] > 0]
            extra = ""
            if s == 0 and em == rd:
                psnr, ssim = stt.quality_device(covers, stego)
                if em == base:
                    f32_stego = stego
                diff = int((stego != f32_stego).sum().item())
                extra = (f"; PSNR {psnr!r} dB, SSIM {ssim!r}; stego bytes "
                         f"that differ from the {base} run's {diff} of "
                         f"{stego.numel()}")
            if em == rd:
                raw.setdefault(em, []).append(rep["payload_ber_raw"])
                post.setdefault(em, []).append(rep["payload_ber_post_ecc"])
            say(f"salts +{s} embed {em} read {rd} ({card}): recovered "
                f"{ok}/{B}; payload raw BER {rep['payload_ber_raw']!r}, "
                f"post-ECC {rep['payload_ber_post_ecc']!r} (images "
                f"{bad_p}); header raw BER {rep['header_ber_raw']!r}, "
                f"post-ECC {rep['header_ber_post_ecc']!r} (images {bad_h})"
                + extra)
            del stego
    finally:
        corner._fwd_y_kernels = real
        if env is None:
            os.environ.pop("STEGANOSAURUS_MM_PRECISION", None)
        else:
            os.environ["STEGANOSAURUS_MM_PRECISION"] = env
    for mode in modes:
        rel = [(b - f) / f for b, f in zip(raw[mode], raw[base])]
        ok = all(abs(r) <= BER_REL for r in rel) and not any(post[mode])
        say(f"{'mode' if names else 'band'} {mode}: payload raw BER against "
            f"the {base} run's at salts "
            f"{SALT_SETS}: " + ", ".join(f"{r:+.4%}" for r in rel)
            + f"; payload post-ECC {post[mode]}; qualifies (within "
            f"{BER_REL:.0%}, post-ECC 0 everywhere): {ok}")
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
