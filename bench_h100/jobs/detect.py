"""Detect's device stage: ``engine/detect.py::predict_batch_windows``, one
batch after another as the engine's serial stage runs them, through the
``WindowPredictor`` that ``detect`` builds (compact packed transfer,
default buckets, the configuration's precision).

Set-up makes the weights and a pool of reads from the seed, builds the
predictor and runs every chunk bucket once. The window draws batches from
the pool in seeded order. A seeded sample of the window's batches (a
reservoir of ``check_batches``) is kept with its predictions; once the
window has closed, a seeded sample of their reads, up to
``check_windows`` windows, is classified again by the reference from the
same feature blocks, and the check is the widest gap by which a predicted
class's reference logit lies below the reference's best.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_h100 import reference, traffic as gen
from bench_h100.seeds import rng
from bench_h100.weights import as_port_params, make_weights
from bench_h100.window import (Measurement, free, load_kernels, measure,
                               memory_peak, reset_peak, sync)


def model_config(cfg: Dict):
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig

    return BiLSTMConfig(
        num_input=cfg["num_input"], num_hidden=cfg["num_hidden"],
        timesteps=cfg["timesteps"], num_layers=cfg["num_layers"],
        num_classes=cfg["num_classes"], forget_bias=cfg["forget_bias"],
        output_layer=cfg["output_layer"])


def host_reads(pool: gen.ReadPool) -> List:
    """The pool's reads as the engine's ``HostReadResult``s: the device
    stage reads ``features`` and ``n_aligned``; the fields the output
    stage alone reads are left empty."""
    from deepmod_tpu_torch.engine.host_worker import HostReadResult

    return [HostReadResult(
        read_id=f"read{i}", path="", rname="chr1", strand="+", pos0=0,
        base_map=None, left_clip=0, right_clip=0, first_match_pos=0,
        num_match=int(n), num_mismatch=0, num_insert=0, num_del=0,
        features=block, n_aligned=int(n), chrom_length=0)
        for i, (block, n) in enumerate(zip(pool.blocks, pool.n_aligned))]


class Setup:
    """Everything the window needs: weights, pool, predictor, order."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from deepmod_tpu_torch.engine.detect import WindowPredictor

        load_kernels(device)
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.weights = make_weights(cfg, seed, device)
        self.pool = gen.ReadPool(traffic, seed, device)
        began = time.perf_counter()
        balance_classes(self.weights, self.pool, cfg, seed, device)
        self.reference_s = time.perf_counter() - began
        reset_peak(device)
        self.reads = host_reads(self.pool)
        self.predictor = WindowPredictor(
            as_port_params(self.weights), model_config(cfg), device=device,
            precision=cfg["precision"])
        self.batches = gen.read_batches(traffic, seed, self.pool.n_aligned)

    def warm(self, batches: int = 1) -> None:
        """Every chunk bucket once (a batch's last chunk can take any),
        then ``batches`` batches of the traffic."""
        block = self.pool.features
        t = self.cfg["timesteps"]
        for bucket in self.predictor.buckets:
            rows = min(bucket, len(block))
            centers = np.arange(t // 2, rows - t // 2)
            self.predictor.predict_from_features(
                block[:rows], centers, window=t, assume_packable=True)
        for _ in range(batches):
            self.run_batch(next(self.batches))
        sync(self.device)

    def run_batch(self, idx: np.ndarray) -> np.ndarray:
        from deepmod_tpu_torch.engine.detect import predict_batch_windows

        return predict_batch_windows([self.reads[i] for i in idx],
                                     self.predictor)

    def asked(self, idx: np.ndarray) -> int:
        """Windows a batch asks for: every aligned event of every read."""
        return int(self.pool.n_aligned[idx].sum())


def balance_classes(weights: Dict[str, torch.Tensor], pool: gen.ReadPool,
                    cfg: Dict, seed: int, device, sample: int = 4096) -> None:
    """Shift the last class's projection bias so that the two classes'
    logits tie at the median of a seeded sample of the pool's windows (by
    the reference): random weights otherwise give one class nearly every
    window, and a check over one class cannot see an answer flipped to
    the other. Two classes only."""
    if cfg["num_classes"] != 2:
        raise ValueError("balance_classes: two classes only")
    ends = np.cumsum(pool.n_aligned)
    event = rng(seed, "balance").integers(0, int(ends[-1]), sample)
    read = np.searchsorted(ends, event, side="right")
    centers = pool.offsets[read] + pool.pad + event - (ends[read] - pool.n_aligned[read])
    half = cfg["timesteps"] // 2
    windows = pool.features[centers[:, None] + np.arange(-half, half + 1)]
    with reference._no_tf32():
        ref = reference.logits(weights, torch.from_numpy(windows).to(device),
                               cfg, "fp64")
    weights["out_b"][1] -= float((ref[:, 1] - ref[:, 0]).median())


def reference_logits(weights: Dict[str, torch.Tensor], pool: gen.ReadPool,
                     idx: np.ndarray, cfg: Dict, mode: str,
                     device) -> torch.Tensor:
    """The reference's logits of every window of the batch ``idx``, in
    the engine's order (read by read, event by event), from the pool's
    feature blocks."""
    blocks = [pool.blocks[i] for i in idx]
    rows = torch.from_numpy(np.concatenate(blocks)).to(device)
    starts = np.concatenate([[0], np.cumsum([len(b) for b in blocks])[:-1]])
    centers = np.concatenate([
        s + pool.pad + np.arange(pool.n_aligned[i])
        for s, i in zip(starts, idx)])
    return reference.window_logits(
        weights, rows, torch.from_numpy(centers).to(device), cfg, mode)


def checked_reads(kept: List[Tuple[np.ndarray, np.ndarray]],
                  pool: gen.ReadPool, budget: int,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(read indices, their predictions) that the check compares: the
    reads of the ``kept`` (batch, predictions) pairs in a seeded order, as
    many as fit in ``budget`` windows (one at least), each with its slice
    of its batch's predictions (the engine's order, read by read)."""
    reads: List[Tuple[int, np.ndarray]] = []
    for idx, preds in kept:
        ends = np.cumsum(pool.n_aligned[idx])
        reads += [(int(i), preds[e - n : e]) for i, e, n in
                  zip(idx, ends, pool.n_aligned[idx])]
    picked: List[Tuple[int, np.ndarray]] = []
    windows = 0
    for k in rng(seed, "check_reads").permutation(len(reads)):
        n = int(pool.n_aligned[reads[k][0]])
        if picked and windows + n > budget:
            continue
        picked.append(reads[k])
        windows += n
    return (np.array([i for i, _ in picked]),
            np.concatenate([p for _, p in picked]))


def logit_gap(preds: np.ndarray, ref: torch.Tensor) -> float:
    """The widest gap by which the reference's logit of a predicted class
    lies below its best (0 where every prediction is the reference's
    argmax); infinite where an answer is missing or is no class."""
    preds = np.asarray(preds)
    if len(preds) != len(ref) or len(preds) == 0:
        return float("inf")
    if preds.min() < 0 or preds.max() >= ref.shape[1]:
        return float("inf")
    p = torch.from_numpy(preds.astype(np.int64)).to(ref.device)
    chosen = ref.gather(1, p[:, None])[:, 0]
    return float((ref.max(dim=1).values - chosen).max())


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device, trace_path: str) -> Tuple[Measurement, Dict, int]:
    """Set up, measure, check: (measurement, checks, failed batches)."""
    setup = Setup(cfg, traffic, seed, device)
    setup.warm()
    m = Measurement("detect", cfg, traffic,
                    reference_setup_s=setup.reference_s)
    keep = traffic["check_batches"]
    picker = rng(seed, "check")
    kept: List[Tuple[np.ndarray, np.ndarray]] = []
    failed = 0
    bytes0 = setup.predictor.transfer_bytes

    seen = 0

    def one() -> int:
        nonlocal failed, seen
        idx = next(setup.batches)
        preds = setup.run_batch(idx)
        asked = setup.asked(idx)
        failed += int(len(preds) != asked)
        # reservoir sample of the run's batches, drawn from the seed
        seen += 1
        if len(kept) < keep:
            kept.append((idx, preds))
        else:
            slot = int(picker.integers(0, seen))
            if slot < keep:
                kept[slot] = (idx, preds)
        return asked

    def on_close() -> None:
        m.counters["transfer_bytes"] = setup.predictor.transfer_bytes - bytes0

    measure(m, one, seconds, trace, device, "predict_batch_windows",
            trace_path, on_close)
    peak = memory_peak(device)
    weights, pool = setup.weights, setup.pool
    del setup
    free(device)
    began = time.perf_counter()
    idx, preds = checked_reads(kept, pool, traffic["check_windows"], seed)
    gap = logit_gap(preds, reference_logits(weights, pool, idx, cfg, "fp64",
                                            device))
    m.counters["reference_s"] = time.perf_counter() - began
    limit = cfg["limits"]["detect"]["max_logit_gap"]
    checks = {"max_logit_gap": {"value": gap, "limit": limit}}
    m.counters["memory_peak_bytes"] = peak
    return m, checks, failed
