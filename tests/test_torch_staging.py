"""Detect's compact path staged from the reads' own blocks, on the CPU.

``predict_batch_windows`` hands ``WindowPredictor.predict_from_blocks`` the
batch's feature blocks and its asked windows as runs of consecutive
centers; each chunk's rows are gathered from the blocks into a host buffer
of its own. Its predictions equal, bit for bit, those of the concatenated
array through ``predict_from_features`` (the one-block case) and of
materialized windows, at fp32 and bf16, and those of the JAX package's
predictor at fp32: over seeded block lengths, tiny buckets (many chunks a
batch), a block longer than the largest bucket, a batch of one read, asked
runs narrower than their blocks (``--targetOnly``), many blocks of a few
rows, several batches through one predictor and a predictor over three CPU
shards.
"""

import numpy as np
import pytest
import torch

from deepmod_tpu.engine.detect import WindowPredictor as JaxPredictor
from deepmod_tpu.engine.detect import (
    predict_batch_windows as jax_predict_batch_windows,
)
from deepmod_tpu.models import bilstm as jb
from deepmod_tpu_torch.engine import detect
from deepmod_tpu_torch.engine.detect import (
    WindowPredictor,
    predict_batch_windows,
)
from deepmod_tpu_torch.engine.host_worker import HostReadResult
from deepmod_tpu_torch.engine.outputs import (
    FEATURE_PAD,
    build_batch_request,
    center_runs,
    run_centers,
    scatter_selected_preds,
)
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_to_numpy
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

CFG = tb.BiLSTMConfig(num_input=7, num_hidden=16)

# case: (buckets, shards, target base, aligned events of each read of
# each batch: a list of ints, or (low, high, reads) drawn from the seed)
CASES = {
    "random_lengths": ((64, 256), 1, None, (1, 400, 9)),
    "tiny_buckets": ((8, 16), 1, None, (1, 120, 5)),
    "block_past_largest_bucket": ((64, 256), 1, None, [40, 900, 7]),
    "one_read": ((64, 256), 1, None, [333]),
    "target_only": ((64, 256), 1, "C", (1, 400, 7)),
    "three_shards": ((64, 256), 3, None, (1, 400, 8)),
}
BATCHES = 3


@pytest.fixture(scope="module")
def params():
    """Seeded weights whose last bias is shifted so that the two classes
    split the windows of ``_rows`` about evenly: unshifted, they give one
    class nearly everywhere, and predictions of misplaced rows could not
    differ."""
    tree = tb.init_bilstm_params(9, CFG, device="cpu")
    feats = _rows(np.random.default_rng(0), 2000)
    windows = np.lib.stride_tricks.sliding_window_view(feats, 21, axis=0)
    logits = tb.bilstm_logits(
        tree, torch.from_numpy(windows.transpose(0, 2, 1).copy()), CFG)
    tree["out_b"][1] -= (logits[:, 1] - logits[:, 0]).median()
    return params_to_numpy(tree)


def _rows(rng, rows):
    """Engine-shaped feature rows: a 0/1 one-hot (or none), then numbers
    that bf16 rounds."""
    feats = np.zeros((rows, 7), np.float32)
    hot = rng.integers(0, 5, rows)
    for b in range(4):
        feats[hot == b, b] = 1.0
    feats[:, 4:6] = rng.standard_normal((rows, 2))
    feats[:, 6] = rng.integers(1, 40, rows)
    return feats


def _reads(rng, events):
    """Host results of reads with ``events`` aligned events each, every
    block with its +-100 pad; the base map's reference bases from the seed
    (read bases have no gap)."""
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


def _events(rng, spec):
    if isinstance(spec, list):
        return spec
    low, high, reads = spec
    return [int(n) for n in rng.integers(low, high, reads)]


def _concatenated(results, predictor, target):
    """The batch through the array API: the blocks concatenated and every
    asked center listed."""
    feats, centers, selections, n_total = build_batch_request(results,
                                                              target)
    preds = predictor.predict_from_features(feats, centers)
    return scatter_selected_preds(results, selections, preds, n_total)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_staged_blocks_equal_the_concatenated_array(params, case, precision):
    buckets, shards, target, spec = CASES[case]
    kw = dict(buckets=buckets, device="cpu", precision=precision,
              devices=["cpu"] * shards)
    staged = WindowPredictor(params, CFG, compact_transfer=True, **kw)
    windows = WindowPredictor(params, CFG, compact_transfer=False, **kw)
    rng = np.random.default_rng(sorted(CASES).index(case))
    for batch in range(BATCHES):
        results = _reads(rng, _events(rng, spec))
        got = predict_batch_windows(results, staged, target_base=target)
        assert len(got) == sum(r.n_aligned for r in results)
        assert 0 < int(got.sum()) < len(got)
        np.testing.assert_array_equal(
            got, _concatenated(results, staged, target),
            err_msg=f"batch {batch}")
        np.testing.assert_array_equal(
            got, _concatenated(results, windows, target),
            err_msg=f"batch {batch}")


def _small_blocks(seed):
    """Blocks of 0-30 rows and asked centers that skip rows."""
    rng = np.random.default_rng(seed)
    blocks = [_rows(rng, int(n)) for n in rng.integers(0, 31, 60)]
    rows = sum(len(b) for b in blocks)
    asked = np.flatnonzero(rng.random(rows - 20) < 0.8) + 10
    return blocks, asked


@pytest.mark.parametrize("buckets", [(8, 16), (256, 1024)],
                         ids=["tiny", "wide"])
def test_chunks_gather_across_many_small_blocks(params, buckets):
    """Blocks of 0-30 rows and runs that skip rows: a chunk gathers from
    many blocks (wide buckets) or a batch takes many chunks (tiny ones);
    the predictions are the materialized windows' of the concatenation."""
    blocks, asked = _small_blocks(5)
    firsts, counts = center_runs(asked)
    staged = WindowPredictor(params, CFG, buckets=buckets, device="cpu",
                             compact_transfer=True)
    windows = WindowPredictor(params, CFG, buckets=buckets, device="cpu",
                              compact_transfer=False)
    want = windows.predict_from_features(np.concatenate(blocks), asked)
    for _ in range(2):
        np.testing.assert_array_equal(
            staged.predict_from_blocks(blocks, firsts, counts), want)


@pytest.mark.parametrize("case", list(CASES) + ["many_small_blocks"])
def test_staged_blocks_equal_the_jax_predictor(params, case):
    """The same batches through the JAX package's ``predict_batch_windows``
    and its predictor (scan path, fp32, compact transfer, the same buckets,
    one device): the port's staged predictions equal its own, bit for bit,
    ``--targetOnly`` and many blocks of a few rows included."""
    buckets, shards, target, spec = CASES.get(case, ((8, 16), 1, None, None))
    staged = WindowPredictor(params, CFG, buckets=buckets, device="cpu",
                             precision="fp32", devices=["cpu"] * shards,
                             compact_transfer=True)
    jax_pred = JaxPredictor(params, jb.BiLSTMConfig(num_input=7,
                                                    num_hidden=16),
                            buckets=buckets, use_pallas=False,
                            data_parallel=False, precision="fp32",
                            compact_transfer=True)
    if spec is None:
        blocks, asked = _small_blocks(6)
        got = staged.predict_from_blocks(blocks, *center_runs(asked))
        want = jax_pred.predict_from_features(np.concatenate(blocks), asked)
        assert 0 < int(want.sum()) < len(want)
        np.testing.assert_array_equal(got, want)
        return
    rng = np.random.default_rng(100 + sorted(CASES).index(case))
    for batch in range(BATCHES):
        results = _reads(rng, _events(rng, spec))
        got = predict_batch_windows(results, staged, target_base=target)
        want = jax_predict_batch_windows(results, jax_pred,
                                         target_base=target)
        np.testing.assert_array_equal(got, want, err_msg=f"batch {batch}")


def test_each_chunk_is_staged_into_a_buffer_of_its_own(params):
    """``_stage`` gathers a chunk's fp32 rows from the blocks into a new
    buffer of the chunk's rows, zeros past the blocks: staging the next
    chunk leaves the one before, whose copies may still be in flight, as
    it was."""
    rng = np.random.default_rng(8)
    blocks = [_rows(rng, n) for n in (50, 3, 90)]
    whole = np.concatenate(blocks)
    starts = np.array([0, 50, 53])
    pred = WindowPredictor(params, CFG, buckets=(64, 256), device="cpu",
                           compact_transfer=True)
    first = pred._stage(blocks, starts, 0, 64)
    kept = first.clone()
    second = pred._stage(blocks, starts, 100, 64)
    assert first.shape == (64, 7) == second.shape
    assert first.dtype == torch.float32 == second.dtype
    np.testing.assert_array_equal(first.numpy(), whole[:64])
    np.testing.assert_array_equal(second.numpy()[:43], whole[100:])
    assert (second.numpy()[43:] == 0).all()
    assert torch.equal(first, kept)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_gather_reads_blocks_end_to_end_and_fills_past_them(kind):
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal((n, 3)).astype(np.float32)
              for n in (5, 0, 7, 1, 4)]
    whole = np.concatenate(blocks)
    lengths = np.array([len(b) for b in blocks])
    starts = np.cumsum(lengths) - lengths
    if kind == "torch":
        blocks = [torch.from_numpy(b) for b in blocks]
    for row0 in range(len(whole)):
        for rows in (1, 6, 30):
            dst = np.full((rows, 3), np.nan, np.float32)
            detect._gather(blocks, starts, row0,
                           dst if kind == "numpy" else torch.from_numpy(dst))
            want = np.zeros((rows, 3), np.float32)
            part = whole[row0 : row0 + rows]
            want[: len(part)] = part
            np.testing.assert_array_equal(dst, want)


def test_center_runs_round_trip():
    rng = np.random.default_rng(3)
    for centers in (np.arange(0), np.array([4]), np.array([3, 3, 4, 9]),
                    np.sort(rng.integers(0, 500, 300))):
        firsts, counts = center_runs(centers)
        assert (counts > 0).all()
        assert np.all(firsts[1:] != firsts[:-1] + counts[:-1])
        back = run_centers(firsts, counts)
        assert back.dtype == np.int64
        np.testing.assert_array_equal(back, centers)
