"""The channel's bit error rate under each precision of forward stage 2's
band, on one CUDA card.

    python3 tools/band_ber_torch.py [OUT]

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
tells a write's error from a read's. For each run: every secret read back
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("band_ber_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import steganosaurus_tpu_torch as stt
    from steganosaurus_tpu_torch import _build, runtime
    from steganosaurus_tpu_torch.spectral import corner
    from steganosaurus_tpu_torch.spectral import corner_kernels as ck

    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else (
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
        def stage2(ar, ai, tabs):
            prep = ck.stage2_prep_plain(ar, ai)
            idx = corner.band_topk(prep[2], corner.SPLIT_X0)
            return ck.fwd_stage2_plain(ar, ai, idx, tabs, band, prep)
        return stage2

    modes = {"f32": corner._fwd_y_split, "bf16x3": plain("bf16x3"),
             "bf16x6": plain("bf16x6"), "kernel": corner._fwd_y_adaptive}
    runs = [(s, m, m) for s in SALT_SETS for m in modes]
    runs.insert(len(modes), (0, "bf16x3", "f32"))
    real = corner._fwd_y_adaptive
    raw, post = {}, {}
    f32_stego = None
    try:
        for s, em, rd in runs:
            salts = [bytes([(i + s) % 256]) * 16 for i in range(B)]
            corner._fwd_y_adaptive = modes[em]
            stego = stt.embed_batch(covers, secrets, master_key=mk,
                                    salts=salts, device_resident=True,
                                    layout="nchw").stego
            corner._fwd_y_adaptive = modes[rd]
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
                if em == "f32":
                    f32_stego = stego
                diff = int((stego != f32_stego).sum().item())
                extra = (f"; PSNR {psnr!r} dB, SSIM {ssim!r}; stego bytes "
                         f"that differ from the f32 band's {diff} of "
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
        corner._fwd_y_adaptive = real
    for mode in modes:
        rel = [(b - f) / f for b, f in zip(raw[mode], raw["f32"])]
        ok = all(abs(r) <= BER_REL for r in rel) and not any(post[mode])
        say(f"band {mode}: payload raw BER against the f32 band's at salts "
            f"{SALT_SETS}: " + ", ".join(f"{r:+.4%}" for r in rel)
            + f"; payload post-ECC {post[mode]}; qualifies (within "
            f"{BER_REL:.0%}, post-ECC 0 everywhere): {ok}")
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
