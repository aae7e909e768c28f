"""The stream driver: a bulk service that embeds and extracts batch after
batch through embed_stream -> extract_stream, closed-loop (the next batch
is submitted as soon as the stream takes it), with the cell's covers
resident on the card and each batch's secrets and salts fresh from the
seed.

Knobs, from the mix's JSON:
- depth: batches in flight on each side (embed_stream's and
  extract_stream's `depth`);
- layout: "nchw" or "nhwc", how the covers are held and served;
- clen_hint: true to hand the extract the secrets' length, false to let it
  probe each header first;
- warmup_batches: batches streamed in set-up before the window;
- crop_right, trace_seconds: read by the harness (the covers' width, the
  traced stretch).

What the check reads of a driver: `shape`, `params`, `key`, `covers` (the
pool, NCHW), `layout` (how the program is served) and `unread` (the stegos
of images answered None, with their covers, secrets and salts).
"""

from __future__ import annotations

import time

import torch

from turtlebench.harness import Feed, Stream, make_covers, service_key, \
    shape_of


class Driver:
    """The system under test as the cell deploys it: the program, its
    parameters, the service key, the resident covers and the feed."""

    # stegos kept of images the program answered None for, for the check
    KEEP_UNREAD = 32

    def __init__(self, stt, cell, seed: int, device):
        self.stt = stt
        self.cell = cell
        self.shape = shape_of(cell)
        self.params = stt.Params(**cell.config["params"])
        self.key = service_key(cell)
        mix = cell.traffic
        self.depth = int(mix["depth"])
        self.layout = mix.get("layout", "nchw")
        self.hint = (self.shape["secret_bytes"] if mix.get("clen_hint", True)
                     else None)
        # NCHW, as the reference reads them; served in the mix's layout
        self.covers = make_covers(cell, seed, device)
        self.served = (self.covers if self.layout == "nchw" else
                       self.covers.permute(0, 2, 3, 1).contiguous())
        self.feed = Feed(seed, self.shape["B"], self.shape["secret_bytes"])
        self.next_k = 0
        self.unread: list = []

    def nchw(self, stego: torch.Tensor) -> torch.Tensor:
        return stego if self.layout == "nchw" else stego.permute(0, 3, 1, 2)

    def warm(self) -> None:
        """Every shape the window uses, and the rare path a long-running
        service has warm: the extract's read at its cap (see cap_read)."""
        self.stream(count=int(self.cell.traffic["warmup_batches"]))
        self.cap_read()

    def cap_read(self) -> None:
        """One extract of an unembedded cover under a clen hint past any
        capacity. Its read asks for the walk up to the extract's cap, as a
        soft retry does under a header whose clen the rounding corrupted
        (expanding it there costs tens of seconds and a run's window), and
        the row, unreadable, takes the single-image fallback that
        unreadable rows take."""
        H, W = self.shape["H"], self.shape["W"]
        self.stt.extract_batch(self.served[:1], master_key=self.key,
                               params=self.params, clen_hint=3 * H * W,
                               layout=self.layout)

    def stream(self, *, until: float | None = None, count: int | None = None,
               sample=None) -> Stream:
        """Run embed_stream -> extract_stream until the clock passes `until`
        (no batch is submitted after it) or `count` batches were submitted;
        every batch submitted is waited for and every answer compared."""
        stt, out = self.stt, Stream()
        pending: dict = {}
        first = self.next_k

        def batches():
            while True:
                k = self.next_k
                if until is not None and time.perf_counter() >= until:
                    return
                if count is not None and k - first >= count:
                    return
                secrets, salts = self.feed.batch(k)
                self.next_k += 1
                pending[k] = [time.perf_counter(), secrets, salts, None]
                yield self.served, secrets, salts

        def stegos():
            for j, res in enumerate(stt.embed_stream(
                    batches(), master_key=self.key, params=self.params,
                    depth=self.depth, layout=self.layout)):
                entry = pending[first + j]
                entry[3] = res.stego
                if sample is not None:
                    sample.offer(self.nchw(res.stego), self.covers,
                                 entry[1], entry[2])
                yield res.stego

        t0 = time.perf_counter()
        for j, got in enumerate(stt.extract_stream(
                stegos(), master_key=self.key, params=self.params,
                clen_hint=self.hint, depth=self.depth, layout=self.layout)):
            t = time.perf_counter()
            t_sub, secrets, salts, stego = pending.pop(first + j)
            out.latencies_s.append(t - t_sub)
            out.batches += 1
            out.images += len(secrets)
            got = list(got) + [False] * (len(secrets) - len(got))
            for i, (g, s) in enumerate(zip(got, secrets)):
                if g == s:
                    out.ok += 1
                elif g is None:
                    if len(self.unread) < self.KEEP_UNREAD:
                        self.unread.append(
                            (self.covers[i], s, salts[i],
                             self.nchw(stego)[i].clone()))
                else:
                    out.wrong += 1
        for _, secrets, _, _ in pending.values():   # batches never answered
            out.images += len(secrets)
            out.wrong += len(secrets)
        out.seconds = time.perf_counter() - t0
        return out
