"""Cluster-effect second-stage 5mC refinement
(DeepMod_tools/hm_cluster_predict.py equivalent), with the MLP on a device.

Counterpart of ``deepmod_tpu/tools/cluster_predict.py``. For every
covered CpG site in a merged per-chromosome BED, builds the 14-dim
neighborhood feature (own meth fraction, opposite-strand partner
fraction, neighbor count, 11-bin histogram of neighbor CpG meth fractions
within +-25 bp, hm_cluster_predict.py:134-154) and rewrites the BED line
with the MLP's refined percentage (:161-170).

The BED readers and the featurization are the JAX package's, unchanged,
so the features are the same bits: neighbor windows are prefix-sum
histogram differences over the position-sorted site array instead of the
reference's per-site +-25 Python scan. The MLP (``models.cluster_mlp``)
runs on the card unless ``device="cpu"`` is given.

``load_cluster_model`` takes an ``.npz`` (the JAX package's
``save_cluster_npz`` layout) or a TF1 checkpoint prefix, read without
TensorFlow (``models.tf_import.load_cluster_checkpoint``). The default
model, as in the JAX package, is the reference's TF1 checkpoint at
``REFERENCE_CLUSTER_CHECKPOINT``, relative to the working directory
(``tests/golden/cluster_weights.npz`` holds the same weights, converted).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepmod_tpu_torch.models.cluster_mlp import (
    cluster_forward,
    cluster_params_from_numpy,
)
from deepmod_tpu_torch.models.tf_import import load_cluster_checkpoint

NB_SIZE = 25          # hm_cluster_predict.py:83
BATCH_SIZE = 4096     # :16
DEFAULT_CHRS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY", "chrM"]
# the JAX package's default model: this TF1 checkpoint of the reference
# repository
REFERENCE_CLUSTER_CHECKPOINT = (
    "train_deepmod/"
    "na12878_cluster_train_mod-keep_prob0.7-nb25-chr1/Cg.cov5.nb25"
)


def load_cluster_model(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Model params (numpy) from a native .npz or a reference TF checkpoint."""
    if path is None:
        path = REFERENCE_CLUSTER_CHECKPOINT
    if path.endswith(".npz"):
        data = np.load(path)
        return {k: data[k] for k in data.files}
    params, _ = load_cluster_checkpoint(path)
    return params


def _read_motif_positions(path: str) -> set:
    """motif_<chr>_C.bed -> {(strand, pos)} (:118-124)."""
    out = set()
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                out.add((parts[2], int(parts[1])))
    return out


def _read_pred_bed(
    path: str, cg_positions: set
) -> Tuple[List[Tuple[str, int]], Dict[Tuple[str, int], float], List[str]]:
    """Merged BED -> (sorted site keys, fraction map, original lines)
    (readpredmod, :43-73): keeps covered sites that are CpG positions."""
    frac: Dict[Tuple[str, int], float] = {}
    lines: Dict[Tuple[str, int], str] = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            parts = line.split()
            if len(parts) < 12:
                continue
            strand, pos = parts[5], int(parts[1])
            if (strand, pos) not in cg_positions:
                continue
            cov = int(parts[9])
            if cov == 0:
                continue
            frac[(strand, pos)] = round(int(parts[10]) / 100.0, 3)
            lines[(strand, pos)] = line
    # the reference sorts (chr, strand, pos) tuples -> strand-major, then
    # position, within one chromosome (:133)
    keys = sorted(frac.keys())
    return keys, frac, [lines[k] for k in keys]


def build_cluster_features(
    keys: Sequence[Tuple[str, int]],
    frac: Dict[Tuple[str, int], float],
) -> np.ndarray:
    """(N, 14) features, vectorized prefix-sum histogram windows."""
    n = len(keys)
    if n == 0:
        return np.empty((0, 14), np.float32)

    # per-position dedup: '+' entry wins over '-' (the reference checks
    # '+' first at each rpos, :146-152)
    by_pos: Dict[int, float] = {}
    for strand in ("+", "-"):
        for (s, p), f in frac.items():
            if s == strand and (strand == "+" or p not in by_pos):
                by_pos[p] = f
    dpos = np.asarray(sorted(by_pos.keys()), np.int64)
    dfrac = np.asarray([by_pos[int(p)] for p in dpos])
    dbins = (dfrac / 0.1 + 0.5).astype(np.int64)
    dbins = np.clip(dbins, 0, 10)
    onehot = np.zeros((len(dpos), 11), np.int64)
    onehot[np.arange(len(dpos)), dbins] = 1
    prefix = np.concatenate([np.zeros((1, 11), np.int64), np.cumsum(onehot, 0)])

    pos_arr = np.asarray([p for (_, p) in keys], np.int64)
    strand_arr = np.asarray([s for (s, _) in keys])
    partner_pos = np.where(strand_arr == "+", pos_arr + 1, pos_arr - 1)

    lo = np.searchsorted(dpos, pos_arr - NB_SIZE, "left")
    hi = np.searchsorted(dpos, pos_arr + NB_SIZE, "right")
    window_hist = prefix[hi] - prefix[lo]

    # subtract the dedup entries at own and partner positions when present
    def sub_at(positions):
        idx = np.searchsorted(dpos, positions)
        idx_c = np.minimum(idx, len(dpos) - 1)
        present = (dpos[idx_c] == positions) & (idx < len(dpos))
        rows = np.flatnonzero(present)
        out = np.zeros_like(window_hist)
        out[rows, dbins[idx_c[rows]]] = 1
        return out

    window_hist = window_hist - sub_at(pos_arr) - sub_at(partner_pos)
    np.clip(window_hist, 0, None, out=window_hist)
    count = window_hist.sum(axis=1)

    own = np.asarray([frac[k] for k in keys])
    partner = np.asarray(
        [
            frac.get(("-" if s == "+" else "+", int(pp)), 0.0)
            for s, pp in zip(strand_arr, partner_pos)
        ]
    )
    hist = window_hist.astype(np.float64)
    nz = count > 0
    hist[nz] = np.round(hist[nz] / count[nz, None], 3)
    feats = np.concatenate(
        [own[:, None], partner[:, None], count[:, None].astype(np.float64), hist],
        axis=1,
    )
    return feats.astype(np.float32)


def predict_sites(params, feats: np.ndarray) -> np.ndarray:
    """(N, 14) features -> (N,) float32 refined fractions: one transfer
    each way, the MLP in BATCH_SIZE rows a call on the params' device."""
    if len(feats) == 0:
        return np.empty(0, np.float32)
    x = torch.as_tensor(feats, device=params["W_1"].device)
    with torch.no_grad():
        pred = torch.cat([cluster_forward(params, x[lo : lo + BATCH_SIZE])
                          for lo in range(0, len(x), BATCH_SIZE)])
    return pred.cpu().numpy()


def write_rewritten(path: str, lines: Sequence[str], pred: np.ndarray) -> None:
    """'<original line> <int(p*100)>' a site (:168-170)."""
    with open(path, "w") as fh:
        for line, p in zip(lines, pred):
            fh.write(f"{line} {int(p * 100)}\n")


def cluster_predict_run(
    pred_prefix: str,
    motif_folder: str,
    model_path: Optional[str] = None,
    chrs: Optional[Sequence[str]] = None,
    base: str = "C",
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Process each chromosome's merged BED; returns total sites rewritten.

    Reads ``<pred_prefix>.<chr>.<base>.bed``, writes
    ``<pred_prefix>_clusterCpG.<chr>.<base>.bed`` with lines
    '<original line> <new_percent>' (:168-170).
    """
    params = cluster_params_from_numpy(load_cluster_model(model_path), device)
    total = 0
    for chrom in chrs if chrs else DEFAULT_CHRS:
        motif_path = os.path.join(motif_folder, f"motif_{chrom}_{base}.bed")
        pred_path = f"{pred_prefix}.{chrom}.{base}.bed"
        if not (os.path.isfile(motif_path) and os.path.isfile(pred_path)):
            continue
        cg_positions = _read_motif_positions(motif_path)
        keys, frac, lines = _read_pred_bed(pred_path, cg_positions)
        if not keys:
            continue
        feats = build_cluster_features(keys, frac)
        pred = predict_sites(params, feats)
        write_rewritten(f"{pred_prefix}_clusterCpG.{chrom}.{base}.bed",
                        lines, pred)
        total += len(keys)
    return total
