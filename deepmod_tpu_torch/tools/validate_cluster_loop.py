"""The paper's 5mC loop through the port's CLI, scored for value.

    python -m deepmod_tpu_torch.tools.validate_cluster_loop [--out DIR]
        [--small] [--device cuda] [--shift S] [--threads N]

Counterpart of ``scripts/validate_cluster_loop.py`` on the pod5 route (a
pod5 + basecall BAM pair a cohort, so no h5py is needed). The loop
(reference workflow: docs/Usage.md:29-42):

  1. synthesize a cohort whose methylation is cluster-correlated: CpG
     dyads carry per-site methylation probabilities drawn per 250 bp tile
     (``make_clustered_site_prob``), the structure the 14-feature MLP
     conditions on (hm_cluster_predict.py:130-154: +-25 bp neighbor
     histogram), and two first-stage training cohorts on the same genome
     (a CG signal shift on every read, and none);
  2. train the first-stage BiLSTM on them (getfeatures --posneg 1/0 ->
     train, then a class-weighted resume);
  3. detect on the clustered cohort (chrT + chrE);
  4. merge -> per-chromosome BEDs; motif -> CpG index;
  5. clustertrain on chrT's sites against the underlying site
     probabilities (the bisulfite-truth analog);
  6. clusterpred with (a) the chrT-trained model and (b) the bundled
     model (the reference's NA12878 checkpoint, converted:
     ``tests/golden/cluster_weights.npz``);
  7. site-level AUC / average precision on chrE (labels: site prob >=
     0.5) before and after the second stage, from ``tools.evaluate``'s
     numpy functions.

Sites the merged BED drops (modcount 0, sum_chr_mod.py:55-57) keep their
first-stage fraction in the "after" scoring, which is what a user of the
reference workflow gets. Every step with device work runs on ``--device``
(cuda unless asked); the steps are functions, which ``chip_smoke.py``
also drives. Prints one JSON line, ``{"cluster_loop": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUNDLED_MODEL = os.path.join(REPO, "tests", "golden", "cluster_weights.npz")
CHROMS = ("chrT", "chrE")
READ_LENGTH = (1500, 3000)
EPOCHS = 4              # first-stage epochs, plain and then class-weighted
CLUSTER_EPOCHS = 40
SEED = 42


@dataclasses.dataclass
class LoopConfig:
    out: str
    device: str = "cuda"
    chrom_size: int = 60_000
    n_train: int = 400          # reads of each first-stage training cohort
    n_cohort: int = 960         # reads of the clustered cohort
    shift: float = 1.0          # mod signal-level shift
    threads: int = 2


def small_config(out: str, device: str = "cuda") -> LoopConfig:
    """Tiny cohorts need a strong signal to train."""
    return LoopConfig(out=out, device=device, chrom_size=8_000, n_train=60,
                      n_cohort=80, shift=2.5)


def cli(*args: str) -> str:
    """One port CLI command in this process; what it printed."""
    from deepmod_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(args))
    if rc != 0:
        raise RuntimeError(f"{args[0]} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue()


def synth_cohorts(cfg: LoopConfig) -> Dict[str, np.ndarray]:
    """The three pod5 cohorts under ``cfg.out``; returns the landscape."""
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        make_clustered_site_prob,
        make_genome,
        write_move_dataset_pod5,
    )

    rng = np.random.RandomState(SEED)
    genome = make_genome(rng, {c: cfg.chrom_size for c in CHROMS})
    landscape = make_clustered_site_prob(rng, genome, tile=250)
    # the move layout spreads a read's samples evenly over its bases, so
    # every base dwells 8 samples: the move table's base boundaries are
    # then the signal's own (random dwells drift them apart over a read)
    common = dict(genome_sizes={}, read_length=READ_LENGTH,
                  fast5_style="move", samples_per_base=(8, 8))
    for name, n, seed, extra in (
            ("train_mod", cfg.n_train, 11,
             dict(mod_motif="CG", mod_level_shift=cfg.shift)),
            ("train_ctl", cfg.n_train, 12, {}),
            ("clustered", cfg.n_cohort, 13,
             dict(mod_site_prob=landscape, mod_level_shift=cfg.shift))):
        write_move_dataset_pod5(
            os.path.join(cfg.out, name),
            SynthConfig(num_reads=n, seed=seed, **common, **extra),
            genome=genome)
    return landscape


def ref_path(cfg: LoopConfig) -> str:
    return os.path.join(cfg.out, "clustered", "ref.fa")


def _inputs(cfg: LoopConfig, name: str) -> List[str]:
    ds = os.path.join(cfg.out, name)
    return ["--wrkBase", os.path.join(ds, "pod5"), "--basecalls",
            os.path.join(ds, "calls.bam"), "--Ref", os.path.join(ds, "ref.fa"),
            "--alignStr", "builtin"]


def train_first_stage(cfg: LoopConfig) -> str:
    """getfeatures on both training cohorts, EPOCHS plain epochs, then
    EPOCHS class-weighted ones from that checkpoint (plain training
    alone can settle on all-negative over the imbalanced sites); the
    model's path."""
    feats = {}
    for name, posneg in (("train_mod", 1), ("train_ctl", 0)):
        feats[name] = os.path.join(cfg.out, f"feat_{name}")
        cli("getfeatures", *_inputs(cfg, name), "--posneg", str(posneg),
            "--outFolder", feats[name], "--FileID", "f",
            "--threads", str(cfg.threads), "--save_format", "npz",
            "--motifORPos", "1", "--motif", "CG", "--ModinMotif", "0")
    wrk = feats["train_mod"] + ";" + feats["train_ctl"]
    first = os.path.join(cfg.out, "train1")
    flags = ("--epochs", str(EPOCHS), "--device", cfg.device)
    cli("train", "--wrkBase", wrk, "--outFolder", first, "--FileID", "m",
        *flags)
    second = os.path.join(cfg.out, "train2")
    cli("train", "--wrkBase", wrk, "--outFolder", second, "--FileID", "m",
        *flags,
        "--modfile", os.path.join(first, str(EPOCHS), "m.npz"),
        "--unbalanced", "1")
    return os.path.join(second, str(EPOCHS), "m.npz")


def detect(cfg: LoopConfig, cohort: str, model: str, out: str,
           precision: str = "bf16", mod_cluster: int = 0,
           device: Optional[str] = None) -> Tuple[float, str]:
    """detect through the CLI, BEDs only; (wall seconds, what it printed)."""
    t0 = time.perf_counter()
    printed = cli("detect", *_inputs(cfg, cohort), "--modfile", model,
                  "--outFolder", out, "--Base", "C", "--perRead", "0",
                  "--precision", precision, "--mod_cluster", str(mod_cluster),
                  "--threads", str(cfg.threads), "--outLevel", "2",
                  "--device", device or cfg.device)
    return time.perf_counter() - t0, printed


def merge_and_motif(cfg: LoopConfig, runs: str, prefix: str = "pred") -> str:
    """``merge`` every detect run under the folder ``runs`` (one run:
    merge sums all it finds) and write the CpG index once; the merged
    prefix."""
    cli("merge", runs, "C", prefix, ",".join(CHROMS))
    motif = os.path.join(cfg.out, "motif")
    if not os.path.isdir(motif):
        cli("motif", "--ref", ref_path(cfg), "--out", motif, "--motif", "CG")
    return os.path.join(runs, prefix)


def site_truth(probs: np.ndarray) -> Dict[Tuple[str, int], float]:
    """Site probabilities -> {(strand, pos): prob} for both strands of
    every dyad (the - strand C sits at dyad_pos + 1)."""
    truth = {}
    for p in np.flatnonzero(probs):
        truth[("+", int(p))] = float(probs[p])
        truth[("-", int(p) + 1)] = float(probs[p])
    return truth


def write_truth(cfg: LoopConfig, landscape, chrom: str = "chrT") -> str:
    path = os.path.join(cfg.out, f"truth_{chrom}.txt")
    with open(path, "w") as fh:
        for (strand, pos), p in sorted(site_truth(landscape[chrom]).items()):
            fh.write(f"{chrom} {strand} {pos} {p:.4f}\n")
    return path


def cluster_train(cfg: LoopConfig, prefix: str, truth: str,
                  out: str, device: Optional[str] = None) -> str:
    return cli("clustertrain", prefix, os.path.join(cfg.out, "motif"),
               "--truth", truth, "--out", out, "--chrs", "chrT",
               "--epochs", str(CLUSTER_EPOCHS),
               "--device", device or cfg.device)


def cluster_pred(cfg: LoopConfig, prefix: str, model: str,
                 device: Optional[str] = None) -> str:
    return cli("clusterpred", prefix, os.path.join(cfg.out, "motif"),
               "--model", model, "--chrs", *CHROMS,
               "--device", device or cfg.device)


def read_bed_fracs(paths: Sequence[str]) -> Dict[Tuple[str, int],
                                                 Tuple[int, float]]:
    """detect-format BED -> {(strand, pos): (cov, modcount / cov)}."""
    out = {}
    for path in paths:
        if not os.path.isfile(path):
            continue
        with open(path) as fh:
            for line in fh:
                p = line.split()
                if len(p) >= 12 and int(p[9]) > 0:
                    out[(p[5], int(p[1]))] = (int(p[9]), int(p[11]) / int(p[9]))
    return out


def read_rewritten(path: str) -> Dict[Tuple[str, int], float]:
    """clusterpred output: '<merged line> <new_percent>' -> {(strand, pos):
    fraction}."""
    out = {}
    if os.path.isfile(path):
        with open(path) as fh:
            for line in fh:
                p = line.split()
                if len(p) >= 13:
                    out[(p[5], int(p[1]))] = int(p[-1]) / 100.0
    return out


def metrics(truth, before, after, min_cov: int) -> Optional[dict]:
    """AUC/AP over truth sites with coverage >= min_cov; 'after' falls
    back to 'before' where the second stage did not rewrite."""
    from deepmod_tpu_torch.tools.evaluate import (
        average_precision_score,
        roc_auc_score,
    )

    y, s_before, s_after = [], [], []
    for key, true_p in truth.items():
        if key not in before or before[key][0] < min_cov:
            continue
        y.append(1 if true_p >= 0.5 else 0)
        s_before.append(before[key][1])
        s_after.append(after.get(key, before[key][1]))
    if len(set(y)) < 2:
        return None
    return {
        "n_sites": len(y), "n_pos": int(sum(y)),
        "auc_before": roc_auc_score(y, s_before),
        "auc_after": roc_auc_score(y, s_after),
        "ap_before": average_precision_score(y, s_before),
        "ap_after": average_precision_score(y, s_after),
    }


def score(landscape, det: str, prefix: str, bundled_prefix: str) -> dict:
    """The loop's report: chrE (held out of clustertrain) with both
    models, and chrT."""
    def before(chrom):
        return read_bed_fracs([os.path.join(det, f"mod_pos.{chrom}{s}.C.bed")
                               for s in "+-"])

    report = {}
    for tag, chrom, pre, min_cov in (
            ("chrE_cov5_trained", "chrE", prefix, 5),
            ("chrE_cov1_trained", "chrE", prefix, 1),
            ("chrE_cov5_bundled", "chrE", bundled_prefix, 5),
            ("chrT_cov5_train_chrom", "chrT", prefix, 5)):
        report[tag] = metrics(
            site_truth(landscape[chrom]), before(chrom),
            read_rewritten(f"{pre}_clusterCpG.{chrom}.C.bed"), min_cov)
    return report


def run_loop(cfg: LoopConfig) -> dict:
    t0 = time.time()
    shutil.rmtree(cfg.out, ignore_errors=True)
    os.makedirs(cfg.out)
    landscape = synth_cohorts(cfg)
    model = train_first_stage(cfg)
    runs = os.path.join(cfg.out, "runs")
    det = os.path.join(runs, "det")
    detect(cfg, "clustered", model, det)
    prefix = merge_and_motif(cfg, runs)
    for chrom in CHROMS:
        path = f"{prefix}.{chrom}.C.bed"
        n_lines = sum(1 for _ in open(path)) if os.path.isfile(path) else 0
        if n_lines < 20:
            raise SystemExit(
                f"merged BED {path} nearly empty ({n_lines} sites): the "
                "first-stage model detected almost nothing (merge drops "
                "modcount-0 rows); raise --shift or the cohort size")
    cluster_model = os.path.join(cfg.out, "cluster.npz")
    cluster_train(cfg, prefix, write_truth(cfg, landscape), cluster_model)
    cluster_pred(cfg, prefix, cluster_model)
    bundled_prefix = os.path.join(runs, "pred_bundled")
    for chrom in CHROMS:
        shutil.copy(f"{prefix}.{chrom}.C.bed",
                    f"{bundled_prefix}.{chrom}.C.bed")
    cluster_pred(cfg, bundled_prefix, BUNDLED_MODEL)
    report = {"device": cfg.device, "shift": cfg.shift,
              "chrom_size": cfg.chrom_size, "cohort_reads": cfg.n_cohort}
    report.update(score(landscape, det, prefix, bundled_prefix))
    report["total_s"] = time.time() - t0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="cluster_loop")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--shift", type=float, default=None,
                    help="mod signal-level shift (lower = harder first "
                    "stage = more denoising headroom)")
    args = ap.parse_args(argv)
    cfg = (small_config(args.out, args.device) if args.small
           else LoopConfig(out=args.out, device=args.device))
    cfg = dataclasses.replace(cfg, threads=args.threads)
    if args.shift is not None:
        cfg = dataclasses.replace(cfg, shift=args.shift)
    report = run_loop(cfg)
    for key, value in report.items():
        print(f"{key}: {value}", file=sys.stderr)
    print(json.dumps({"cluster_loop": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
