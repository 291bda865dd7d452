"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Under ``torch.profiler``, a detect batch through ``predict_batch_windows``
exports its spans nested in the batch span ``device_inference``, on the
compact path (each chunk's staging, ``detect.stage``, inside its
``detect.chunk``) and on the materialized one, and the counters of windows
asked and windows run match a hand count of the bucket layout;
with no profiler nothing records, no ``record_function`` is made and the
counters stand still; the predictions keep their bits either way. A train
step, on one device and over a mesh, shows its forward, backward and Adam
spans, one after another.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmod_tpu_torch.engine.detect import (
    WindowPredictor,
    predict_batch_windows,
)
from deepmod_tpu_torch.engine.host_worker import HostReadResult
from deepmod_tpu_torch.engine.outputs import FEATURE_PAD
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import (
    params_from_numpy,
    params_to_numpy,
)
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.train import trainer
from deepmod_tpu_torch.utils import profiling

CFG = tb.BiLSTMConfig(num_input=7, num_hidden=16)
# two reads of 50 and 30 aligned events, each block with its +-100 pad
EVENTS = (50, 30)
BUCKETS = (64, 256)
DETECT_SPANS = ("detect.request", "detect.pack", "detect.chunk",
                "detect.dispatch", "detect.fetch", "detect.scatter")
COUNTERS = ("detect.windows_asked", "detect.windows_run")
# the hand count of each path over the two reads (80 windows asked):
# compact: the blocks trimmed to the rows their windows read (50 + 20 and
# 30 + 20), one chunk of their 120 rows (under the 256-row bucket), 100
# windows: the 80 asked and the 20 between the two reads' runs;
# materialized: one bucket of 64 windows, then the 16 left in a bucket of
# 64 (64 - 16 <= the waste allowed, max(64, 80 >> 6))
HAND_COUNT = {True: (80, 100), False: (80, 64 + 64)}


@pytest.fixture(scope="module")
def params():
    return params_to_numpy(tb.init_bilstm_params(3, CFG, device="cpu"))


def _reads():
    rng = np.random.default_rng(7)
    out = []
    for i, n in enumerate(EVENTS):
        rows = n + 2 * FEATURE_PAD
        feats = np.zeros((rows, 7), np.float32)
        hot = rng.integers(0, 5, rows)
        for b in range(4):
            feats[hot == b, b] = 1.0
        feats[:, 4:] = rng.standard_normal((rows, 3)).round(3)
        out.append(HostReadResult(
            read_id=f"r{i}", path="", rname="chr1", strand="+", pos0=0,
            base_map=None, left_clip=0, right_clip=0, first_match_pos=0,
            num_match=n, num_mismatch=0, num_insert=0, num_del=0,
            features=feats, n_aligned=n, chrom_length=0))
    return out


def _predictor(params, compact):
    return WindowPredictor(params, CFG, buckets=BUCKETS, device="cpu",
                           compact_transfer=compact)


def _spans(path):
    """(name, start, end) of every program span in a chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, child, parent):
    """Every ``child`` span lies inside some ``parent`` span (at least one
    child)."""
    kids = [(a, b) for n, a, b in spans if n == child]
    outer = [(a, b) for n, a, b in spans if n == parent]
    return bool(kids) and all(any(pa <= a and b <= pb for pa, pb in outer)
                              for a, b in kids)


def _traced_batch(predictor, tmp_path):
    """(predictions, spans, counter deltas) of one batch under the CPU
    profiler."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        preds = predict_batch_windows(_reads(), predictor)
    after = profiling.counters()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    return preds, _spans(path), deltas


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "materialized"])
def test_detect_spans_nest_in_the_batch_span(params, compact, tmp_path):
    _, spans, _ = _traced_batch(_predictor(params, compact), tmp_path)
    assert sum(n == "device_inference" for n, _, _ in spans) == 1
    for name in DETECT_SPANS:
        assert _inside(spans, name, "device_inference"), name
    assert _inside(spans, "detect.h2d", "detect.dispatch")
    # the compact path stages each chunk's rows inside its chunk span
    assert _inside(spans, "detect.stage", "detect.chunk") == compact


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "materialized"])
def test_detect_counters_match_the_bucket_layout(params, compact, tmp_path):
    _, _, deltas = _traced_batch(_predictor(params, compact), tmp_path)
    assert tuple(deltas[k] for k in COUNTERS) == HAND_COUNT[compact]


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "materialized"])
def test_predictions_keep_their_bits_under_the_profiler(params, compact,
                                                        tmp_path):
    predictor = _predictor(params, compact)
    traced, _, _ = _traced_batch(predictor, tmp_path)
    plain = predict_batch_windows(_reads(), predictor)
    assert traced.dtype == plain.dtype and len(plain) == sum(EVENTS)
    np.testing.assert_array_equal(traced, plain)


def test_nothing_records_without_a_profiler(params, monkeypatch):
    """No profiler: a span makes no ``record_function`` and the counters
    stand still; a span with a timer still adds its seconds there."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refused)
    before = profiling.counters()
    timer = profiling.StageTimer()
    for compact in (True, False):
        predict_batch_windows(_reads(), _predictor(params, compact), timer)
    assert profiling.counters() == before
    assert set(timer.as_dict()) == {"device_inference"}
    assert timer.as_dict()["device_inference"] > 0


def _mesh_step():
    from deepmod_tpu_torch.parallel.mesh import make_mesh
    from deepmod_tpu_torch.parallel.shardings import make_sharded_train_step

    return make_sharded_train_step(CFG, 1e-3, make_mesh(devices=["cpu"] * 2))


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device", "mesh"])
def test_train_step_spans(params, mesh, tmp_path):
    """A step runs its forward and backward spans, one pair a shard, then
    one Adam span after the last backward."""
    step = _mesh_step() if mesh else trainer.make_train_step(CFG, False)
    tree = params_from_numpy(params, "cpu")
    state = trainer.adam_init(tree)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((32, 21, 7)).astype(np.float32))
    y = torch.eye(2)[torch.from_numpy(rng.integers(0, 2, 32))]
    mask = torch.ones(32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tree, state, x, y, mask)
    path = str(tmp_path / "train.json")
    prof.export_chrome_trace(path)
    spans = sorted(_spans(path), key=lambda s: s[1])
    shards = 2 if mesh else 1
    assert [n for n, _, _ in spans] == (
        ["train.forward", "train.backward"] * shards + ["train.adam"])
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
