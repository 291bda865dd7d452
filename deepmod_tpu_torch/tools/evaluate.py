"""Motif-ground-truth performance evaluation
(DeepMod_tools/cal_EcoliDetPerf.py equivalent; matplotlib only for the
plots — the reference imports rpy2/ggplot2 but plots with matplotlib
anyway).

A copy of ``deepmod_tpu/tools/evaluate.py`` for the PyTorch port, which
needs no sklearn: ``roc_curve``, ``precision_recall_curve``,
``roc_auc_score`` and ``average_precision_score`` below are numpy
functions that follow sklearn's definitions (scores sorted descending
with a stable sort, one curve point per distinct score so ties move
together, cumulative counts in float64, the ROC area by the trapezoid
rule, AP = sum_n (R_n - R_{n-1}) P_n).

Builds per-site ground truth from a motif scan of the reference genome
(methylated run's motif sites = positives; every control-run site and
non-motif site = negatives), scores sites by methylation percentage, and
reports ROC-AUC and average precision at coverage thresholds 1 and 5
(cal_EcoliDetPerf.py:241-281), with ROC/PR PNGs. The reference also
computes a per-site binomial log-pmf column (:114) that nothing — in
the reference either — ever reads back; it is omitted here rather than
paying one scipy call per site for a dead column.
"""

from __future__ import annotations

import glob as globmod
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepmod_tpu_torch.features.labels import scan_motif
from deepmod_tpu_torch.io.fasta import read_fasta

COV_THRESHOLDS = (1, 5)


def _thresholded_counts(
    y_true, y_score
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at each distinct score, highest first."""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score).ravel()
    # the counts are read only at the last row of each run of equal
    # scores, so the order within a run does not matter
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    idx = np.r_[np.flatnonzero(np.diff(y_score)), y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) as sklearn's ``roc_curve`` with
    ``drop_intermediate=True``: collinear points dropped, (0, 0) first at
    threshold inf."""
    fps, tps, thresholds = _thresholded_counts(y_true, y_score)
    if len(fps) > 2:
        keep = np.flatnonzero(np.r_[
            True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(
    y_true, y_score
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds) as sklearn's
    ``precision_recall_curve`` (recall decreasing, ending at (1, 0))."""
    fps, tps, thresholds = _thresholded_counts(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def roc_auc_score(y_true, y_score) -> float:
    """Area under ``roc_curve`` by the trapezoid rule (NaN with one
    class)."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    # numpy's trapezoid rule, written out (numpy 1.x names it trapz)
    return float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def average_precision_score(y_true, y_score) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over ``precision_recall_curve``."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _find_beds(spec: Sequence[str], base: str) -> List[str]:
    """Accept explicit BED files or run folders (globbed like
    cal_EcoliDetPerf.py:193-205)."""
    out: List[str] = []
    for item in spec:
        if os.path.isfile(item):
            out.append(item)
        else:
            for depth in ("", "*/", "*/*/"):
                out.extend(
                    globmod.glob(
                        os.path.join(item, depth + f"mod_pos.*.{base}.bed")
                    )
                )
    return out


def _read_sites(
    paths: Sequence[str],
    start: Optional[int],
    end: Optional[int],
) -> Dict[Tuple[str, int, str], List[int]]:
    """(chr, pos, strand) -> [cov, pct, modcount], re-deriving pct on merge
    (readmodf_dict, cal_EcoliDetPerf.py:78-106)."""
    sites: Dict[Tuple[str, int, str], List[int]] = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 12:
                    continue
                pos = int(parts[1])
                if start is not None and pos < start:
                    continue
                if end is not None and pos > end:
                    continue
                key = (parts[0], pos, parts[5])
                cov, pct, mod = int(parts[9]), int(parts[10]), int(parts[11])
                if key not in sites:
                    sites[key] = [cov, pct, mod]
                else:
                    sites[key][0] += cov
                    sites[key][2] += mod
                    sites[key][1] = (
                        int(sites[key][2] * 100 / sites[key][0])
                        if sites[key][0] > 0 else 0
                    )
    return sites


def ecoli_performance(
    mod_beds: Sequence[str],
    ctrl_beds: Sequence[str],
    ref_fasta: str,
    motif: str = "CG",
    out_prefix: str = "perf",
    mod_offset: int = 0,
    chrom: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
    make_plots: bool = True,
) -> Dict[str, float]:
    base = motif[mod_offset].upper()
    genome = read_fasta(ref_fasta, chrom)
    motif_sites, _ = scan_motif(genome, motif, mod_offset, chrom, start, end)

    mod_sites = _read_sites(_find_beds(mod_beds, base), start, end)
    ctrl_sites = _read_sites(_find_beds(ctrl_beds, base), start, end)

    labels: List[int] = []
    scores: List[int] = []
    coverages: List[int] = []
    tp = fp = tn = fn = 0

    for source, pos_label in ((ctrl_sites, 0), (mod_sites, 1)):
        for (chr_, pos, strand), (cov, pct, mod) in source.items():
            at_motif = (strand, pos) in motif_sites.get(chr_, set())
            label = pos_label if at_motif else 0
            labels.append(label)
            scores.append(pct)
            coverages.append(cov)
            if label == 0:
                tn += cov - mod
                fp += mod
            else:
                tp += mod
                fn += cov - mod

    labels_a = np.asarray(labels)
    scores_a = np.asarray(scores)
    cov_a = np.asarray(coverages)
    metrics: Dict[str, float] = {
        "num_sites": float(len(labels_a)),
        "num_positive_sites": float(labels_a.sum()),
        "read_tp": float(tp),
        "read_fp": float(fp),
        "read_tn": float(tn),
        "read_fn": float(fn),
    }
    curves = {}
    for covt in COV_THRESHOLDS:
        sel = cov_a >= covt
        if sel.sum() == 0 or len(np.unique(labels_a[sel])) < 2:
            metrics[f"auc_cov{covt}"] = float("nan")
            metrics[f"ap_cov{covt}"] = float("nan")
            continue
        metrics[f"auc_cov{covt}"] = float(
            roc_auc_score(labels_a[sel], scores_a[sel])
        )
        metrics[f"ap_cov{covt}"] = float(
            average_precision_score(labels_a[sel], scores_a[sel])
        )
        curves[covt] = (
            roc_curve(labels_a[sel], scores_a[sel]),
            precision_recall_curve(labels_a[sel], scores_a[sel]),
        )

    if make_plots and curves:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        styles = {1: "b-", 5: "r-."}
        fig = plt.figure()
        for covt, ((fpr, tpr, _), _pr) in curves.items():
            plt.plot(
                fpr, tpr, styles.get(covt, "k-"), lw=2,
                label=f"Coverage>={covt} (AUC={metrics[f'auc_cov{covt}']:.3f})",
            )
        plt.plot([0, 1], [0, 1])
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.legend(loc="lower right")
        fig.savefig(f"{out_prefix}_roc.png", dpi=150)
        plt.close(fig)

        fig = plt.figure()
        for covt, (_roc, (precision, recall, _)) in curves.items():
            plt.plot(
                recall, precision, styles.get(covt, "k-"), lw=2,
                label=f"Coverage>={covt} (AP={metrics[f'ap_cov{covt}']:.3f})",
            )
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.legend(loc="lower left")
        fig.savefig(f"{out_prefix}_pr.png", dpi=150)
        plt.close(fig)

    return metrics
