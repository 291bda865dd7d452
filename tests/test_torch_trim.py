"""Detect's device stage reads each read's block trimmed to the rows its
windows read, on the CPU.

``engine.outputs.batch_blocks`` hands each block on as a view of the
read's features that keeps, of the +-``FEATURE_PAD`` pad, only the
T//2 rows before the first event and the T - 1 - T//2 after the last that
a T-row window centred on an event reads; a compact chunk then holds the
rows its asked windows read and no bucket's tail. The predictions of
``predict_batch_windows`` (the blocks) and of ``build_batch_request``
(the HostPool worker's concatenation) equal, bit for bit, those of the
untrimmed blocks' concatenation at centers ``start + FEATURE_PAD + i``,
at T = 21 (K1's route) and T = 20 (K4's), with and without
``--targetOnly``, on the compact and the materialized path; and the
windows K1 runs on a cfDNA-shaped batch are the hand count of the trimmed
rows.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmod_tpu_torch.engine.detect import (
    WindowPredictor,
    predict_batch_windows,
)
from deepmod_tpu_torch.engine.host_worker import HostReadResult
from deepmod_tpu_torch.engine.outputs import (
    FEATURE_PAD,
    batch_blocks,
    build_batch_request,
    run_centers,
    scatter_selected_preds,
)
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_to_numpy
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.utils import profiling

WINDOWS = {21: "k1", 20: "k4"}


def _config(window):
    return tb.BiLSTMConfig(num_input=7, num_hidden=16, timesteps=window,
                           num_layers=2)


@pytest.fixture(scope="module")
def models():
    """Seeded weights a window length, the last bias shifted so that the
    two classes split the windows of ``_rows`` about evenly: a window read
    from misplaced rows could then change its answer."""
    out = {}
    for window in WINDOWS:
        cfg = _config(window)
        tree = tb.init_bilstm_params(window, cfg, device="cpu")
        feats = _rows(np.random.default_rng(0), 2000)
        x = np.lib.stride_tricks.sliding_window_view(feats, window, axis=0)
        logits = tb.bilstm_logits(
            tree, torch.from_numpy(x.transpose(0, 2, 1).copy()), cfg)
        tree["out_b"][1] -= (logits[:, 1] - logits[:, 0]).median()
        out[window] = (cfg, params_to_numpy(tree))
    return out


def _rows(rng, rows):
    """Engine-shaped feature rows: a 0/1 one-hot (or none), then numbers."""
    feats = np.zeros((rows, 7), np.float32)
    hot = rng.integers(0, 5, rows)
    for b in range(4):
        feats[hot == b, b] = 1.0
    feats[:, 4:6] = rng.standard_normal((rows, 2))
    feats[:, 6] = rng.integers(1, 40, rows)
    return feats


def _reads(rng, events):
    """Host results of reads with ``events`` aligned events each, every
    block with its +-100 pad, its pad rows as random as its events."""
    out = []
    for i, n in enumerate(events):
        base_map = np.zeros(n, dtype=[("refbase", "U1"), ("readbase", "U1")])
        base_map["refbase"] = rng.choice(list("ACGT"), n)
        base_map["readbase"] = "A"
        out.append(HostReadResult(
            read_id=f"r{i}", path="", rname="chr1", strand="+", pos0=0,
            base_map=base_map, left_clip=0, right_clip=0, first_match_pos=0,
            num_match=n, num_mismatch=0, num_insert=0, num_del=0,
            features=_rows(rng, n + 2 * FEATURE_PAD), n_aligned=n,
            chrom_length=0))
    return out


def _untrimmed(results, predictor, window, target):
    """The batch as it stood before the trim: the whole blocks
    concatenated, event i of a block at its row ``FEATURE_PAD + i``."""
    blocks = [r.features for r in results]
    lengths = np.array([len(b) for b in blocks])
    starts = np.cumsum(lengths) - lengths
    if target is None:
        selections = None
        picked = [np.arange(r.n_aligned) for r in results]
    else:
        selections = picked = [np.flatnonzero(r.base_map["refbase"] == target)
                               for r in results]
    centers = np.concatenate([s + FEATURE_PAD + idx
                              for s, idx in zip(starts, picked)])
    preds = predictor.predict_from_features(np.concatenate(blocks), centers,
                                            window)
    return scatter_selected_preds(results, selections, preds,
                                  sum(r.n_aligned for r in results))


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "materialized"])
@pytest.mark.parametrize("target", [None, "C"], ids=["all", "target_only"])
@pytest.mark.parametrize("window", list(WINDOWS), ids=list(WINDOWS.values()))
def test_trimmed_blocks_equal_the_untrimmed_route(models, window, target,
                                                  compact):
    cfg, params = models[window]
    pred = WindowPredictor(params, cfg, buckets=(64, 256), device="cpu",
                           precision="fp32", compact_transfer=compact)
    rng = np.random.default_rng(window + 2 * (target is None) + compact)
    for batch in range(2):
        events = [1] + [int(n) for n in rng.integers(1, 300, 6)]
        results = _reads(rng, events)
        want = _untrimmed(results, pred, window, target)
        assert 0 < int(want.sum()) < len(want)
        got = predict_batch_windows(results, pred, target_base=target)
        np.testing.assert_array_equal(got, want, err_msg=f"batch {batch}")
        # the HostPool worker's route: the trimmed blocks concatenated
        feats, centers, selections, n_total = build_batch_request(
            results, target, window)
        assert len(feats) == sum(n + window - 1 for n in events)
        preds = pred.predict_from_features(feats, centers, window)
        np.testing.assert_array_equal(
            scatter_selected_preds(results, selections, preds, n_total),
            want, err_msg=f"batch {batch}")


@pytest.mark.parametrize("target", [None, "C"], ids=["all", "target_only"])
@pytest.mark.parametrize("window", list(WINDOWS), ids=list(WINDOWS.values()))
def test_blocks_are_views_of_the_rows_their_windows_read(window, target):
    """Each block is a view of its read's features (no copy), from row
    FEATURE_PAD - T//2, with T - 1 rows more than its events; each asked
    center is its event's row of the view, ``T//2 + i``."""
    rng = np.random.default_rng(4)
    results = _reads(rng, [1, 57, 230, 12])
    half = window // 2
    blocks, firsts, counts, selections, n_total = batch_blocks(
        results, target, window)
    assert n_total == 1 + 57 + 230 + 12
    start = 0
    centers = run_centers(firsts, counts)
    for i, (r, b) in enumerate(zip(results, blocks)):
        assert np.shares_memory(b, r.features)
        assert len(b) == r.n_aligned + window - 1
        np.testing.assert_array_equal(
            b, r.features[FEATURE_PAD - half:][: len(b)])
        events = (np.arange(r.n_aligned) if target is None
                  else selections[i])
        mine = centers[(centers >= start) & (centers < start + len(b))]
        np.testing.assert_array_equal(mine - start - half, events)
        start += len(b)


@pytest.mark.parametrize("window", list(WINDOWS), ids=list(WINDOWS.values()))
def test_cfdna_batch_runs_the_trimmed_rows_windows(models, window):
    """A cfDNA-shaped batch (60-600 events a read) in one chunk: the
    windows run are the trimmed rows less T - 1, the asked windows and
    the T - 1 between each two reads' runs, and the rows cast on the
    device are the trimmed rows; the predictions are the untrimmed
    route's."""
    cfg, params = models[window]
    pred = WindowPredictor(params, cfg, buckets=(512, 65536), device="cpu",
                           precision="fp32", compact_transfer=True)
    rng = np.random.default_rng(30 + window)
    events = [60, 600] + [int(n) for n in rng.integers(60, 601, 28)]
    results = _reads(rng, events)
    keys = ("detect.windows_asked", "detect.windows_run",
            "detect.rows_cast_on_device")
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = predict_batch_windows(results, pred)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    rows = sum(events) + (window - 1) * len(events)
    assert rows < 65536
    assert delta == {
        "detect.windows_asked": sum(events),
        "detect.windows_run": sum(events) + (window - 1) * (len(events) - 1),
        "detect.rows_cast_on_device": rows,
    }
    np.testing.assert_array_equal(got, _untrimmed(results, pred, window,
                                                  None))
