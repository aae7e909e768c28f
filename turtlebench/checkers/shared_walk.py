"""The check of a configuration whose cells embed on the shared walk with
the hard write (Rep-3 header, Rep-7 payload, no padding), as default Params
do: the plain float64 reference in turtlebench/reference/ walks, seals,
frames and embeds the sampled secrets itself, and judges the program's
stegos and its read against its own.

A checker is named by a configuration's "checker" key and loaded by the
harness (harness.load_checker); its contract is in harness.py's docstring.
It imports reference/ and torch, and nothing of the harness.
"""

from __future__ import annotations

import os

import torch

from turtlebench.reference import stego as ref_stego
from turtlebench.reference import walk as ref_walk

# the column bands spec_err compares (equal numbers of walk bins, by x)
SPEC_BANDS = 64


def check(stt, service, sample, wrong: int, read_precision: str | None,
          cache) -> tuple[dict, dict]:
    """Each number the check compares, as [value, limit], and what else the
    reference read, for the record:
    - wrong: answers that were another secret than the one embedded, or that
      never came (exact: 0);
    - unread: images the program answered None for whose stego the plain
      reference reads decisively, every Rep-3 group of its header unanimous
      and its hard read opening (exact: 0). A stego whose header the u8
      rounding has made ambiguous, as on a cover with weak bins under the
      shared walk, is no one's to read and is not counted;
    - spec_err: the sampled stegos against the reference's stegos of the
      same cover, secret, salt and key: the spectrum of their difference at
      the walk's bins, |E|^2 over the plane's flipped-byte energy (1 where
      the two differ by rounding alone), averaged in SPEC_BANDS bands of the
      walk's bins ordered by column; the worst band. Where the error sits;
    - bytes_off: the same stegos, the bytes that differ from the
      reference's by more than one u8 step. Rounding alone moves a byte by
      one step, and mix_adaptive's bf16 inverse DFT by two at a few points
      where its table's roundings add up. How large the error is, wherever
      it sits;
    - read_gap: the program's read (its channel_report: the extract's
      forward DFT and raw read, at the cell's batch, the sampled stegos
      repeated to fill it) against the reference's float64 read of the same
      stegos: the raw bit errors over every row's frame, |program -
      reference| / reference.
    read_precision: the corner DFT precision the program's read runs under
    (the control's), else the one in force; cache: where the reference's
    walk is kept between runs."""
    shape, cfg = service.shape, service.cell.config
    p = cfg["params"]
    dev = service.covers.device
    walk = ref_walk.cached_walk(
        cache, ref_walk.walk_key(service.key),
        shape["H"], shape["W"], p["rmin"], p["rmax"], p["density"],
        shape["slots"])
    walk_d = tuple(torch.as_tensor(a, device=dev).long() for a in walk)
    unread = 0
    for _, secret, _, prog in service.unread:
        d = ref_stego.decision_values(prog, walk_d, p["alpha"])
        if ref_stego.read_decisive(d, service.key) == secret:
            unread += 1
    items = sample.drawn()
    norm_sum = torch.zeros(shape["slots"], dtype=torch.float64, device=dev)
    norm_cnt = torch.zeros(shape["slots"], dtype=torch.float64, device=dev)
    rms, off, ref_err = [], 0, []
    for cover, secret, salt, prog in items:
        bits = ref_stego.frame_bits(
            ref_stego.seal_stream(service.key, salt, secret))
        ref = ref_stego.embed(cover, bits, walk_d, alpha=p["alpha"],
                              floor=p["write_floor"])
        diff = prog.to(torch.float64) - ref.to(torch.float64)
        rms.append(diff.square().mean().sqrt().item())
        off += int((diff.abs() > 1).sum())
        flips = (diff * diff).sum((1, 2))
        e2 = torch.fft.fft2(diff)[walk_d].abs() ** 2
        fl = flips[walk_d[0]]
        has = fl > 0
        norm_sum += torch.where(has, e2 / fl.clamp_min(1.0), 0.0)
        norm_cnt += has.to(torch.float64)
        del ref, diff, e2
        d = ref_stego.decision_values(prog, walk_d, p["alpha"])
        ref_err.append(int(((d >= 0) != bits.astype(bool)).sum()))
    order = torch.argsort(walk_d[2], stable=True)
    bands = [(norm_sum[g].sum() / norm_cnt[g].sum()).item()
             for g in torch.tensor_split(order, SPEC_BANDS)
             if norm_cnt[g].sum() > 0]
    spec_err = max(bands) if bands else 0.0
    prog_err = program_read_errors(stt, service, items, read_precision)
    rows = [ref_err[j % len(items)] for j in range(len(prog_err))]
    gap = abs(sum(prog_err) - sum(rows)) / max(sum(rows), 1)
    lim = service.cell.check["limits"]
    numbers = {"wrong": [wrong, 0], "unread": [unread, 0],
               "spec_err": [spec_err, lim["spec_err"]],
               "bytes_off": [off, lim["bytes_off"]],
               "read_gap": [gap, lim["read_gap"]]}
    info = {"images": len(items), "rows": len(prog_err),
            "ref_raw_errors": sum(rows), "prog_raw_errors": sum(prog_err),
            "worst_row_gap": max(abs(a - b) / max(b, 1)
                                 for a, b in zip(prog_err, rows)),
            "stego_rms": [min(rms), max(rms)]}
    return numbers, info


def program_read_errors(stt, service, items: list,
                        read_precision: str | None) -> list[int]:
    """Raw bit errors over each row's frame as the program reads the
    sampled stegos back, in one channel_report of the cell's batch (the
    samples repeated to fill it), served in the driver's layout."""
    B = service.shape["B"]
    pick = [items[j % len(items)] for j in range(B)]
    batch = torch.stack([it[3] for it in pick])
    layout = service.layout
    if layout == "nhwc":
        batch = batch.permute(0, 2, 3, 1).contiguous()
    saved = os.environ.get("STEGANOSAURUS_MM_PRECISION")
    if read_precision is not None:
        os.environ["STEGANOSAURUS_MM_PRECISION"] = read_precision
    try:
        rep = stt.channel_report(
            batch, [it[1] for it in pick], [it[2] for it in pick],
            master_key=service.key, params=service.params, layout=layout,
            per_image=True)
    finally:
        if read_precision is not None:
            if saved is None:
                del os.environ["STEGANOSAURUS_MM_PRECISION"]
            else:
                os.environ["STEGANOSAURUS_MM_PRECISION"] = saved
    nh = ref_stego.HEADER_SLOTS
    npay = service.shape["slots"] - nh
    return [round(r["header_ber_raw"] * nh + r["payload_ber_raw"] * npay)
            for r in rep["per_image"]]
