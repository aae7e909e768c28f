"""Faults planted under the timed path, for showing that the check sees
them: the program's namespace with its stream broken underneath. The
benchmark's own runs never plant one; the tests do on the CPU, and
turtlebench/readings.py does on the card (--fault).

- unchanged: the embed returns its cover, the step leaving its input as it
  was;
- half_write: the write at half strength;
- wrong_column: the stego's last column built on the cover's column before
  it, as an epilogue reading a wrong cover pixel would;
- half_batch: half of each batch's answers left out;
- altered: one answer of each batch altered where it is produced;
- unanswered: the read giving up on every image.
"""

from __future__ import annotations

import types

import torch

FAULTS = ("unchanged", "half_write", "wrong_column", "half_batch",
          "altered", "unanswered")


def broken(stt, fault: str):
    """The program's namespace with its stream broken by `fault` ("none":
    the program as it is)."""
    if fault == "none":
        return stt
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")

    def embed_stream(batches, **kw):
        covers = []

        def seen():
            for item in batches:
                covers.append(item[0])
                yield item
        for res in stt.embed_stream(seen(), **kw):
            cover = covers.pop(0)
            if fault == "unchanged":
                res.stego = cover.clone()
            elif fault == "half_write":
                d = res.stego.to(torch.int16) - cover.to(torch.int16)
                res.stego = (cover.to(torch.int16) + d // 2).to(torch.uint8)
            elif fault == "wrong_column":
                s = res.stego.to(torch.int16)
                c = cover.to(torch.int16)
                if kw.get("layout", "nhwc") == "nchw":
                    s[..., -1] += c[..., -2] - c[..., -1]
                else:
                    s[..., -1, :] += c[..., -2, :] - c[..., -1, :]
                res.stego = s.clamp_(0, 255).to(torch.uint8)
            yield res

    def extract_stream(stegos, **kw):
        for got in stt.extract_stream(stegos, **kw):
            if fault == "half_batch":
                got = got[:len(got) // 2]
            elif fault == "altered" and got and got[0]:
                got = [bytes([got[0][0] ^ 1]) + got[0][1:]] + got[1:]
            elif fault == "unanswered":
                got = [None] * len(got)
            yield got

    return types.SimpleNamespace(
        Params=stt.Params, extract_batch=stt.extract_batch,
        channel_report=stt.channel_report, embed_stream=embed_stream,
        extract_stream=extract_stream)
