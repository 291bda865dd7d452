"""The one general generator: turns a traffic file's parameters and a seed
into a cell's inputs.

A traffic file (``traffic/<name>.json``) names its ``kind``:

- ``detect``: a pool of reads in the engine's layout, each a (rows, F)
  feature block with ``pad`` context rows on each side of its aligned
  events, and batches of ``reads_per_batch`` drawn from it in seeded
  order;
- ``train``: batches of (B, T, F) windows with one-hot labels, staged on
  the device, and the order the steps take them in.

Every seed gets the same set of sizes: read lengths are the quantiles
(i + 0.5) / N of the stated distribution, and only their order and the
feature values come from the seed. So two seeds do the same work.

Feature rows (F = 7, the engine's layout): columns 0-3 the one-hot of the
reference base (aligned rows only; a share of them have no base, as
insertions do), then the event's normalised mean, its stdv and its length
in samples.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterator, List

import numpy as np
import torch

from bench_h100.seeds import rng, stream_seed


def read_lengths(events: Dict, count: int) -> np.ndarray:
    """Aligned-event counts of ``count`` reads: the quantiles of a
    log-normal (``median``, ``sigma``) at (i + 0.5) / count, rounded and
    clipped to [``min``, ``max``]."""
    if events.get("dist") != "lognormal":
        raise ValueError(f"events.dist {events.get('dist')!r}: expected lognormal")
    norm = statistics.NormalDist()
    mu = math.log(events["median"])
    out = [math.exp(mu + events["sigma"] * norm.inv_cdf((i + 0.5) / count))
           for i in range(count)]
    return np.clip(np.rint(out), events["min"], events["max"]).astype(np.int64)


def _rows(n: int, aligned: torch.Tensor, spec: Dict,
          gen: torch.Generator, device) -> torch.Tensor:
    """(n, 7) fp32 feature rows; ``aligned`` (n,) bool marks the rows
    that carry a reference base."""
    u = torch.rand(n, 4, generator=gen, device=device)
    base = (u[:, 0] * 4).long().clamp_(max=3)
    has_base = aligned & (u[:, 1] >= spec["no_base_share"])
    out = torch.zeros(n, 7, device=device)
    out[:, :4] = torch.nn.functional.one_hot(base, 4).float()
    out[:, :4] *= has_base[:, None].float()
    mean, stdv, length = spec["mean"], spec["stdv"], spec["length"]
    out[:, 4] = torch.randn(n, generator=gen, device=device) * mean["sd"] + mean["mu"]
    out[:, 5] = stdv["min"] + u[:, 2] * (stdv["max"] - stdv["min"])
    # the samples of an event: min plus a geometric number of extra ones
    p = 1.0 / (1.0 + length["mean"] - length["min"])
    extra = torch.floor(torch.log1p(-u[:, 3]) / math.log1p(-p))
    out[:, 6] = length["min"] + extra.clamp_(max=length["max"] - length["min"])
    return out


class ReadPool:
    """``reads`` feature blocks, one big host array and each read a view
    of it; ``n_aligned[i]`` aligned events of read ``i``, whose windows
    center on rows ``pad .. pad + n_aligned[i] - 1`` of its block."""

    def __init__(self, traffic: Dict, seed: int, device):
        count = traffic["pool_reads"]
        self.pad = traffic["pad"]
        lengths = read_lengths(traffic["events"], count)
        self.n_aligned = lengths[rng(seed, "pool").permutation(count)]
        rows = self.n_aligned + 2 * self.pad
        self.offsets = np.concatenate([[0], np.cumsum(rows)])
        total = int(self.offsets[-1])
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, "rows"))
        dev_rows = torch.as_tensor(rows, device=device)
        read_of = torch.repeat_interleave(
            torch.arange(count, device=device), dev_rows)
        start = torch.as_tensor(self.offsets[:-1], device=device)[read_of]
        pos = torch.arange(total, device=device) - start
        aligned = (pos >= self.pad) & (
            pos < self.pad + torch.as_tensor(self.n_aligned, device=device)[read_of])
        self.features = _rows(total, aligned, traffic["features"], gen,
                              device).cpu().numpy()
        self.blocks: List[np.ndarray] = [
            self.features[self.offsets[i] : self.offsets[i + 1]]
            for i in range(count)]


def balanced_batches(n_aligned: np.ndarray, per: int) -> List[np.ndarray]:
    """The pool cut into batches of ``per`` reads whose windows are as
    even as the lengths allow: the reads from longest to shortest, each
    round of one read a batch going lightest batch first. The batches'
    sizes depend on the set of lengths alone, which every seed shares, so
    every seed does the same work; which read sits where is the seed's."""
    count = len(n_aligned)
    if count % per:
        raise ValueError(f"pool_reads {count} is not a multiple of "
                         f"reads_per_batch {per}")
    nb = count // per
    longest = np.argsort(-n_aligned, kind="stable")
    sums = np.zeros(nb, np.int64)
    members: List[List[int]] = [[] for _ in range(nb)]
    for lo in range(0, count, nb):
        for read, b in zip(longest[lo : lo + nb], np.argsort(sums, kind="stable")):
            members[b].append(int(read))
            sums[b] += n_aligned[read]
    return [np.array(m) for m in members]


def read_batches(traffic: Dict, seed: int,
                 n_aligned: np.ndarray) -> Iterator[np.ndarray]:
    """Read indices of each batch, endlessly: every epoch the pool's
    ``balanced_batches`` in a seeded order, each batch's reads in a seeded
    order (no read twice in a batch, every read once an epoch)."""
    batches = balanced_batches(np.asarray(n_aligned), traffic["reads_per_batch"])
    order = rng(seed, "order")
    while True:
        for b in order.permutation(len(batches)):
            yield batches[b][order.permutation(len(batches[b]))]


class TrainFeed:
    """``staged_batches`` batches of (batch, T, F) fp32 windows, their
    one-hot labels (classes alternate row by row, as the reference
    interleaves its groups) and an all-ones mask, on the device."""

    def __init__(self, traffic: Dict, cfg: Dict, seed: int, device):
        n, b = traffic["staged_batches"], traffic["batch"]
        t, f = cfg["timesteps"], cfg["num_input"]
        if f != 7:
            raise ValueError(f"train traffic builds 7-feature rows, not {f}")
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, "rows"))
        rows = n * b * t
        self.x = _rows(rows, torch.ones(rows, dtype=torch.bool, device=device),
                       traffic["features"], gen, device).view(n, b, t, f)
        cls = torch.arange(b, device=device) % cfg["num_classes"]
        self.y = torch.nn.functional.one_hot(cls, cfg["num_classes"]).float()
        self.mask = torch.ones(b, device=device)
        self.count = n
        self._order = rng(seed, "order")

    def order(self) -> Iterator[int]:
        """Staged batch indices, endlessly: a seeded permutation each
        epoch, so the first ``staged_batches`` steps see rows that all
        differ."""
        while True:
            yield from (int(i) for i in self._order.permutation(self.count))
