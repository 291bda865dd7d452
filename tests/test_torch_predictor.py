"""The port's WindowPredictor on the CPU: bucket schedule, compact
transfer (fp32 rows cast where they land), its bytes and counter, guards
and sparse routing (mirroring the JAX package's tests/test_detect_e2e.py
predictor tests), then identical fp32 predictions to the JAX
WindowPredictor on the same weights and features.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmod_tpu.engine.detect import WindowPredictor as JaxPredictor
from deepmod_tpu.models import bilstm as jb
from deepmod_tpu_torch.engine.detect import WindowPredictor
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_to_numpy
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.utils import profiling


CFG = tb.BiLSTMConfig(num_input=7)


@pytest.fixture(scope="module")
def params():
    return params_to_numpy(tb.init_bilstm_params(5, CFG, device="cpu"))


def _engine_features(rng, rows):
    """Engine-shaped feature rows: a 0/1 one-hot (or none) + 3 numbers."""
    feats = np.zeros((rows, 7), np.float32)
    hot = rng.integers(0, 5, rows)  # 4 = no base ('-'/'N'/pad rows)
    for b in range(4):
        feats[hot == b, b] = 1.0
    feats[:, 4] = (rng.standard_normal(rows) * 2).round(3)
    feats[:, 5] = np.abs(rng.standard_normal(rows) * 2).round(3)
    feats[:, 6] = rng.integers(1, 40, rows)
    return feats


def test_predictor_greedy_bucket_remainder(params):
    pred = WindowPredictor(params, CFG, buckets=(8, 64, 256), device="cpu")
    for n in (1, 7, 8, 9, 255, 256, 300, 583):
        x = np.random.default_rng(n).standard_normal((n, 21, 7)).astype(
            np.float32)
        want = tb.bilstm_predict(pred.params, torch.from_numpy(x), CFG).numpy()
        np.testing.assert_array_equal(pred.predict(x), want, err_msg=f"n={n}")


def test_predictor_bounded_waste_schedule(params):
    pred = WindowPredictor(params, CFG, buckets=(8, 64, 256), device="cpu")
    calls = []

    def fake_fn(x):
        calls.append(int(x.shape[0]))
        return torch.zeros(x.shape[0], dtype=torch.int8)

    pred._fn = fake_fn
    out = pred.predict(np.zeros((4436, 21, 7), np.float32))
    assert len(out) == 4436
    assert calls == [256] * 17 + [64, 64]
    calls.clear()
    pred.predict(np.zeros((256, 21, 7), np.float32))
    assert calls == [256]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_compact_transfer_equals_window_transfer(params, precision):
    kw = dict(buckets=(64, 256), device="cpu", precision=precision)
    ref = WindowPredictor(params, CFG, compact_transfer=False, **kw)
    cmp = WindowPredictor(params, CFG, compact_transfer=True, **kw)
    rng = np.random.default_rng(3)
    for n_rows, mode in ((80, "all"), (300, "all"), (700, "scatter"),
                         (1200, "sparse")):
        feats = rng.standard_normal((n_rows, 7)).astype(np.float32)
        lo, hi = 10, n_rows - 11
        if mode == "all":
            centers = np.arange(lo, hi, dtype=np.int64)
        elif mode == "scatter":
            centers = np.arange(lo, hi, 4, dtype=np.int64)
        else:
            centers = np.unique(rng.integers(lo, hi, size=37).astype(np.int64))
        np.testing.assert_array_equal(
            cmp.predict_from_features(feats, centers),
            ref.predict_from_features(feats, centers),
            err_msg=f"{n_rows} {mode}",
        )
    # a bucket list smaller than the window must still advance
    tiny = WindowPredictor(params, CFG, buckets=(8,), device="cpu",
                           compact_transfer=True, precision=precision)
    feats = rng.standard_normal((60, 7)).astype(np.float32)
    centers = np.arange(10, 50, dtype=np.int64)
    np.testing.assert_array_equal(
        tiny.predict_from_features(feats, centers),
        ref.predict_from_features(feats, centers),
    )


@pytest.mark.parametrize("window", [20, 64])
def test_compact_transfer_at_layered_window_sizes(window):
    """Window sizes the layered path serves (even, and past the 32-step
    unroll): the row-chunk arithmetic (chunk - T + 1 windows, centers at
    T//2 of each) gives the predictions of materialized windows."""
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=16, timesteps=window,
                          num_layers=2)
    p = params_to_numpy(tb.init_bilstm_params(window, cfg, device="cpu"))
    kw = dict(buckets=(64, 256), device="cpu", precision="fp32")
    ref = WindowPredictor(p, cfg, compact_transfer=False, **kw)
    cmp = WindowPredictor(p, cfg, compact_transfer=True, **kw)
    rng = np.random.default_rng(window)
    feats = _engine_features(rng, 400)
    half = window // 2
    centers = np.arange(half, 400 - half, dtype=np.int64)
    got = cmp.predict_from_features(feats, centers, window)
    np.testing.assert_array_equal(
        got, ref.predict_from_features(feats, centers, window))


# the hand count of the compact chunks at buckets (64, 256), T=21, the
# centers every row with a full window: 290 rows, a 256-row chunk (236
# windows) and one of the 54 rows left (34 windows); 600 rows, two
# 256-row chunks (236 windows each) and one of the 128 rows left (108
# windows). A chunk holds the rows its windows read, no bucket's tail
ROW_CHUNKS = {290: (2, 236 + 34), 600: (3, 2 * 236 + 108)}
CAST_ROWS = "detect.rows_cast_on_device"


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_default_compact_ships_fp32_rows_cast_on_device(precision, shards):
    """The default compact path ships the caller's fp32 rows as they stand
    and casts them to the kernel's dtype where they land: predictions equal
    the materialized windows' bit for bit, over ragged last chunks, on
    one shard and two; ``transfer_bytes`` is 4 B a column of every row
    shipped (each shard's T-1 rows of halo included); the counter of rows
    cast on the device counts those rows under a profiler and stands still
    without one."""
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=16)
    p = params_to_numpy(tb.init_bilstm_params(8, cfg, device="cpu"))
    kw = dict(buckets=(64, 256), device="cpu", precision=precision,
              devices=["cpu"] * shards)
    plain = WindowPredictor(p, cfg, compact_transfer=True, **kw)
    win = WindowPredictor(p, cfg, compact_transfer=False, **kw)
    fed = set()
    real_fn = plain._fn

    def spy_fn(x):
        fed.add(x.dtype)
        return real_fn(x)

    plain._fn = spy_fn
    rng = np.random.default_rng(17)
    for rows, (chunks, windows) in ROW_CHUNKS.items():
        feats = _engine_features(rng, rows)
        feats[:, 4:6] = rng.standard_normal((rows, 2))  # bf16 rounds them
        centers = np.arange(10, rows - 10, dtype=np.int64)
        bytes0 = plain.transfer_bytes
        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU]):
            got = plain.predict_from_features(feats, centers)
        after = profiling.counters()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in (CAST_ROWS, "detect.windows_run")}
        shipped = windows + chunks * shards * 20
        assert plain.transfer_bytes - bytes0 == 4 * 7 * shipped
        assert delta == {CAST_ROWS: shipped, "detect.windows_run": windows}
        np.testing.assert_array_equal(
            got, win.predict_from_features(feats, centers))
        assert 0 < int(got.sum()) < len(got)
        untraced = profiling.counters()
        np.testing.assert_array_equal(
            plain.predict_from_features(feats, centers), got)
        assert profiling.counters() == untraced
    assert fed == {plain._dtype}


def test_compact_transfer_guards(params):
    pred = WindowPredictor(params, CFG, buckets=(64,), device="cpu",
                           compact_transfer=True)
    feats = np.zeros((50, 7), np.float32)
    with pytest.raises(ValueError, match="full window"):
        pred.predict_from_features(feats, np.arange(5, 45, dtype=np.int64))
    with pytest.raises(ValueError, match="full window"):
        pred.predict_from_features(feats, np.arange(10, 45, dtype=np.int64))
    with pytest.raises(ValueError, match="ascending"):
        pred.predict_from_features(
            np.zeros((200, 7), np.float32),
            np.asarray([30, 20] + list(range(40, 160)), np.int64),
        )


def test_sparse_selection_routes_to_window_transfer(params):
    pred = WindowPredictor(params, CFG, buckets=(64, 256), device="cpu",
                           compact_transfer=True)
    calls = {"compact": 0, "window": 0}
    real_compact, real_window = pred._predict_compact, pred.predict

    def spy_compact(*a, **kw):
        calls["compact"] += 1
        return real_compact(*a, **kw)

    def spy_window(*a, **kw):
        calls["window"] += 1
        return real_window(*a, **kw)

    pred._predict_compact = spy_compact
    pred.predict = spy_window
    feats = np.random.default_rng(0).standard_normal((2100, 7)).astype(
        np.float32)
    pred.predict_from_features(feats, np.linspace(20, 2000, 40).astype(np.int64))
    assert calls == {"compact": 0, "window": 1}
    pred.predict_from_features(feats, np.arange(10, 2090, dtype=np.int64))
    assert calls == {"compact": 1, "window": 1}


@pytest.mark.parametrize("compact", [False, True])
def test_predictions_identical_to_jax_predictor(params, compact,
                                                monkeypatch):
    """Same numpy weights and engine-shaped features through the JAX
    predictor (scan path, fp32), with its one-hot pack off and on, and the
    port's one compact path (plain version, fp32): the same predictions.
    With the JAX pack off, the same host->device bytes a row: a compact
    chunk of the port ships the 2,820 rows its windows read (rows
    90..2909), the JAX predictor's the 4,096 of its bucket; window
    transfer ships the same bytes. The port reads no pack setting: its
    bytes stay those whatever the JAX package's pack is set to."""
    rng = np.random.default_rng(21)
    feats = _engine_features(rng, 3000)
    centers = np.arange(100, 2900, dtype=np.int64)
    plain_bytes = None
    for pack in ("0", "1") if compact else ("0",):
        monkeypatch.setenv("DMT_COMPACT_PACK", pack)
        jp = JaxPredictor(params, jb.BiLSTMConfig(num_input=7),
                          buckets=(512, 4096), use_pallas=False,
                          data_parallel=False, precision="fp32",
                          compact_transfer=compact)
        tp = WindowPredictor(params, CFG, buckets=(512, 4096), device="cpu",
                             precision="fp32", compact_transfer=compact)
        want = jp.predict_from_features(feats, centers, assume_packable=True)
        got = tp.predict_from_features(feats, centers)
        assert 0 < int(want.sum()) < len(want)
        np.testing.assert_array_equal(got, want)
        if pack == "0":
            rows, bucket = (2820, 4096) if compact else (1, 1)
            assert tp.transfer_bytes * bucket == jp.transfer_bytes * rows
            plain_bytes = tp.transfer_bytes
        assert tp.transfer_bytes == plain_bytes, pack
