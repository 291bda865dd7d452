"""The yardstick's counts reproduce the kernels table's bounds (PERF.md
§6): K1 at 262,144 windows, H=100, 3 layers, F=7, T=21."""

import json
import os

import pytest

from bench_h100 import yardstick
from conftest import BENCH


def config(name="deepmod_f7_fp32"):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("precision,ms", [("fp32", 34.913), ("bf16", 2.365)])
def test_k1_bound(precision, ms):
    cfg = config()
    n = 262144
    least, by = yardstick.least_seconds(
        yardstick.cone_flops(cfg) * n, yardstick.k1_bytes(cfg, n, precision),
        precision)
    assert by == "operations"
    assert round(least * 1e3, 3) == ms


def test_cone_and_train_counts():
    cfg = config()
    assert yardstick.cone_steps(21) == (11, 11)
    assert yardstick.cone_steps(20) == (11, 10)
    # a step of the three layers: (7 + 100) and twice (100 + 100) rows
    assert yardstick.cone_flops(cfg) == 22 * 2 * 400 * (107 + 200 + 200)
    assert yardstick.projection_flops(cfg) == 800
    # the backward is the forward's products twice over, plus the bias adds
    assert yardstick.backward_flops(cfg) == \
        2 * yardstick.cone_flops(cfg) + 22 * 3 * 400
    assert yardstick.train_flops(cfg) == (
        yardstick.detect_flops(cfg) + yardstick.backward_flops(cfg) + 1602)
    # K2 at batch 2048: the kernels table's 0.2728 ms
    least, _ = yardstick.least_seconds(
        yardstick.cone_flops(cfg) * 2048, yardstick.k2_bytes(cfg, 2048), "fp32")
    assert round(least * 1e3, 4) == 0.2728


def test_weight_count_matches_the_leaves():
    from bench_h100.weights import leaf_shapes
    import numpy as np

    cfg = config()
    assert yardstick.weight_count(cfg) == sum(
        int(np.prod(s)) for _, s in leaf_shapes(cfg))
