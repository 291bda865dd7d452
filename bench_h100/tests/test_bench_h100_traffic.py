"""The one generator is deterministic by seed, gives every seed the same
set of sizes, and matches its parameters."""

import json
import os

import numpy as np
import pytest
import torch

from bench_h100 import traffic as gen
from conftest import BENCH, SMALL_READS, SMALL_TRAIN


def load(name, **over):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        out = json.load(fh)
    out.update(over)
    return out


def config():
    with open(os.path.join(BENCH, "configs", "deepmod_f7_fp32.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["long_reads", "cfdna_reads"])
def test_read_lengths_follow_the_stated_distribution(name):
    t = load(name)
    n = gen.read_lengths(t["events"], t["pool_reads"])
    ev = t["events"]
    assert n.min() >= ev["min"] and n.max() <= ev["max"]
    assert abs(np.median(n) - ev["median"]) <= 0.01 * ev["median"]
    # log-normal: the log's spread is sigma where nothing is clipped
    mid = np.log(n[(n > ev["min"]) & (n < ev["max"])])
    q1, q3 = np.quantile(mid, [0.25, 0.75])
    assert abs((q3 - q1) / 1.349 - ev["sigma"]) < 0.05 * ev["sigma"] + 0.02
    # detect's own batch of 1,000 reads: about 6.4 M and 0.18 M windows
    assert t["reads_per_batch"] == 1000
    per_batch = n.mean() * t["reads_per_batch"]
    want = {"long_reads": 6.4e6, "cfdna_reads": 0.18e6}[name]
    assert abs(per_batch - want) < 0.05 * want


def test_pool_is_deterministic_and_every_seed_has_the_same_sizes():
    t = load("long_reads", **SMALL_READS)
    a, b = gen.ReadPool(t, 7, "cpu"), gen.ReadPool(t, 7, "cpu")
    c = gen.ReadPool(t, 8, "cpu")
    assert np.array_equal(a.features, b.features)
    assert np.array_equal(a.n_aligned, b.n_aligned)
    assert not np.array_equal(a.features[:100], c.features[:100])
    assert sorted(a.n_aligned) == sorted(c.n_aligned)
    assert not np.array_equal(a.n_aligned, c.n_aligned)


def test_pool_rows_are_the_engine_layout():
    t = load("long_reads", **SMALL_READS)
    pool = gen.ReadPool(t, 3, "cpu")
    pad = t["pad"]
    spec = t["features"]
    for block, n in zip(pool.blocks, pool.n_aligned):
        assert block.shape == (n + 2 * pad, 7) and block.dtype == np.float32
        onehot = block[:, :4]
        assert set(np.unique(onehot)) <= {0.0, 1.0}
        assert (onehot.sum(axis=1) <= 1).all()
        # the pad rows carry no reference base; most aligned rows do
        assert onehot[:pad].sum() == 0 and onehot[pad + n :].sum() == 0
        share = 1 - onehot[pad : pad + n].sum() / n
        assert share < spec["no_base_share"] + 0.1
        length = block[:, 6]
        assert length.min() >= spec["length"]["min"]
        assert length.max() <= spec["length"]["max"]
        assert (length == np.floor(length)).all()
        stdv = block[:, 5]
        assert stdv.min() >= spec["stdv"]["min"] and stdv.max() <= spec["stdv"]["max"]
    rows = pool.features
    assert abs(rows[:, 6].mean() - spec["length"]["mean"]) < 1.0
    assert abs(rows[:, 4].std() - spec["mean"]["sd"]) < 0.05


def test_batches_draw_every_read_once_an_epoch():
    t = load("long_reads", **SMALL_READS)
    n = gen.ReadPool(t, 5, "cpu").n_aligned
    it = gen.read_batches(t, 5, n)
    per_epoch = t["pool_reads"] // t["reads_per_batch"]
    for _ in range(3):
        epoch = [next(it) for _ in range(per_epoch)]
        for batch in epoch:
            assert len(batch) == t["reads_per_batch"]
            assert len(set(batch.tolist())) == len(batch)
        assert sorted(np.concatenate(epoch).tolist()) == list(range(t["pool_reads"]))
    first = next(gen.read_batches(t, 5, n))
    assert np.array_equal(first, next(gen.read_batches(t, 5, n)))
    assert not np.array_equal(first, next(gen.read_batches(t, 6, n)))


@pytest.mark.parametrize("name", ["long_reads", "cfdna_reads"])
def test_every_seed_has_the_same_batch_sizes(name):
    t = load(name)
    lengths = gen.read_lengths(t["events"], t["pool_reads"])
    sizes = []
    for seed in (1, 2):
        n = lengths[np.random.default_rng(seed).permutation(len(lengths))]
        batches = gen.balanced_batches(n, t["reads_per_batch"])
        assert sorted(np.concatenate(batches).tolist()) == list(range(len(n)))
        sizes.append(sorted(int(n[b].sum()) for b in batches))
    assert sizes[0] == sizes[1]
    # as even as the longest read allows
    assert max(sizes[0]) <= max(np.mean(sizes[0]), lengths.max()) * 1.15
    assert min(sizes[0]) >= 0.95 * np.mean(sizes[0])


def test_train_feed_is_deterministic_and_balanced():
    t = load("train_b2048", **SMALL_TRAIN)
    cfg = config()
    a, b = gen.TrainFeed(t, cfg, 9, "cpu"), gen.TrainFeed(t, cfg, 9, "cpu")
    assert a.x.shape == (t["staged_batches"], t["batch"], 21, 7)
    assert torch.equal(a.x, b.x)
    assert a.y.sum(dim=0).tolist() == [t["batch"] / 2] * 2
    assert torch.equal(a.mask, torch.ones(t["batch"]))
    order = a.order()
    first = [next(order) for _ in range(t["staged_batches"])]
    assert sorted(first) == list(range(t["staged_batches"]))
    order_b = b.order()
    assert first == [next(order_b) for _ in range(t["staged_batches"])]
