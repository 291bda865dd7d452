"""The whole user workflow through the port's CLI, scored.

    python -m deepmod_tpu_torch.tools.validate_full_loop [--out DIR]
        [--small] [--threads 2] [--fnum 7|57] [--trainPrecision fp32|bf16]
        [--labels motif|pos] [--device cuda] [--epochs 4] [--hidden 100]

Counterpart of ``scripts/validate_full_loop.py`` on the pod5 route (a
pod5 + basecall BAM pair a cohort, so no h5py is needed; detect writes
BEDs only). A methylated and a control cohort share one genome, and the
reference's documented workflow runs on them (bin/DeepMod.py:352-358):

  1. getfeatures --posneg 1 on the methylated cohort and --posneg 0 on
     the control (CG motif labels, or with ``--labels pos`` the
     bisulfite-style position files --motifORPos 2 reads, derived from
     the motif truth: myGetFeatureBasedPos.py:672-698);
  2. train ``--epochs`` epochs, then resume from that checkpoint with
     --unbalanced 1 for as many (the checkpoint resume);
  3. detect on held-out methylated and control cohorts (other seeds);
  4. evaluate: site-level AUC/AP against the CG motif truth with the
     control run as negatives (cal_EcoliDetPerf's method).

Every device step runs on ``--device`` (cuda unless asked). Sizes: a
200 kb genome, 600 + 600 training reads and 1,300 + 1,300 held-out reads
(~20x a site); ``--small``: 20 kb, 40 + 40 and 60 + 60, with a stronger
signal shift (2.5 against 1.2) so that tiny cohorts train. Every base
dwells 8 samples (the move-table route's boundaries then match the
signal's); ``--train-reads`` / ``--test-reads`` set the cohorts' reads.
Prints one JSON line, ``{"full_loop_metrics": {...}, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _probe
from deepmod_tpu_torch.tools.validate_cluster_loop import cli

CHROM = "chrV"


def label_flags(base: str, genome, labels: str) -> list:
    """getfeatures' label flags: the CG motif scan, or position files made
    from the same truth (~10% of CG sites 'partially methylated', left out
    of training both ways; every other target position unmodified)."""
    motif = ["--motif", "CG", "--ModinMotif", "0"]
    if labels == "motif":
        return ["--motifORPos", "1"] + motif
    from deepmod_tpu_torch.features.labels import scan_motif

    fulmod_set, candidates = scan_motif(genome, "CG", 0)
    cg = sorted(fulmod_set.get(CHROM, set()))
    files = {
        "fulmod": [sp for i, sp in enumerate(cg) if i % 10 != 3],
        "anymod": [sp for i, sp in enumerate(cg) if i % 10 == 3],
        "nomod": sorted(candidates.get(CHROM, set())
                        - fulmod_set.get(CHROM, set())),
    }
    posdir = os.path.join(base, "posfiles")
    os.makedirs(posdir)
    flags = ["--motifORPos", "2"] + motif
    for name, rows in files.items():
        path = os.path.join(posdir, f"{name}.txt")
        with open(path, "w") as fh:
            for strand, pos in rows:
                fh.write(f"{CHROM} {strand} {pos}\n")
        flags += [f"--{name}", path]
    print(f"position files: { {k: len(v) for k, v in files.items()} }",
          flush=True)
    return flags


def evaluate(mod_beds, ctl_beds, ref: str, prefix: str) -> dict:
    """The ``evaluate`` command's metrics. It draws its ROC/PR plots with
    matplotlib; where that is not installed (the card's machine), the
    function the command calls runs without the plots."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        from deepmod_tpu_torch.tools.evaluate import ecoli_performance

        print("matplotlib is not installed: evaluate without its plots",
              flush=True)
        return ecoli_performance(mod_beds, ctl_beds, ref, "CG", prefix,
                                 make_plots=False)
    out = cli("evaluate", "--mod-bed", *mod_beds, "--ctrl-bed", *ctl_beds,
              "--ref", ref, "--motif", "CG", "--out-prefix", prefix)
    metrics = {}
    for line in out.splitlines():
        key, _, value = line.partition(":")
        try:
            metrics[key.strip()] = float(value)
        except ValueError:
            pass
    return metrics


def run_loop(args) -> dict:
    from deepmod_tpu_torch.testing.synthetic import make_genome

    genome_size = 20_000 if args.small else 200_000
    n_train = args.train_reads or (40 if args.small else 600)
    n_test = args.test_reads or (60 if args.small else 1300)
    shift = 2.5 if args.small else 1.2
    base = args.out
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    genome = make_genome(np.random.RandomState(42), {CHROM: genome_size})
    t_start = time.time()
    sets = {}
    for name, n, seed, sh in (("train_mod", n_train, 11, shift),
                              ("train_ctl", n_train, 12, 0.0),
                              ("test_mod", n_test, 13, shift),
                              ("test_ctl", n_test, 14, 0.0)):
        sets[name] = _probe.write_cohort(os.path.join(base, name), n, seed,
                                         sh, genome)
    print(f"[synth {time.time() - t_start:.1f}s]", flush=True)
    fnum = ["--fnum", str(args.fnum)]
    labels = label_flags(base, genome, args.labels)
    feats = {}
    for name, posneg in (("train_mod", 1), ("train_ctl", 0)):
        feats[name] = os.path.join(base, f"feat_{name}")
        cli("getfeatures", *_probe.cohort_inputs(sets[name]),
            "--posneg", str(posneg), "--outFolder", feats[name],
            "--FileID", "f", "--threads", str(args.threads),
            "--save_format", "npz", *labels, *fnum)
    print(f"[features {time.time() - t_start:.1f}s]", flush=True)
    wrk = feats["train_mod"] + ";" + feats["train_ctl"]
    common = ["--FileID", "m", "--epochs", str(args.epochs), "--hidden",
              str(args.hidden), "--trainPrecision", args.trainPrecision,
              "--device", args.device, *fnum]
    train1 = os.path.join(base, "train1")
    cli("train", "--wrkBase", wrk, "--outFolder", train1, *common)
    train2 = os.path.join(base, "train2")
    cli("train", "--wrkBase", wrk, "--outFolder", train2, *common,
        "--modfile", os.path.join(train1, str(args.epochs), "m.npz"),
        "--unbalanced", "1")
    model = os.path.join(train2, str(args.epochs), "m.npz")
    print(f"[train {time.time() - t_start:.1f}s]", flush=True)
    for name in ("test_mod", "test_ctl"):
        cli("detect", *_probe.cohort_inputs(sets[name]), "--modfile", model,
            "--outFolder", os.path.join(base, f"det_{name}"),
            "--FileID", "mod", "--Base", "C", "--perRead", "0",
            "--hidden", str(args.hidden), "--threads", str(args.threads),
            "--device", args.device, *fnum)
    print(f"[detect {time.time() - t_start:.1f}s]", flush=True)

    def beds(name):
        return [os.path.join(base, f"det_{name}", f"mod_pos.{CHROM}{s}.C.bed")
                for s in "+-"]

    ref = os.path.join(sets["train_mod"], "ref.fa")
    metrics = evaluate(beds("test_mod"), beds("test_ctl"), ref,
                       os.path.join(base, "perf"))
    return {"full_loop_metrics": metrics, "fnum": args.fnum,
            "labels": args.labels, "train_precision": args.trainPrecision,
            "device": args.device, "hidden": args.hidden,
            "epochs": args.epochs, "total_s": time.time() - t_start}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.validate_full_loop",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dmt_full_loop"))
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes for a smoke run")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--fnum", type=int, default=7, choices=(7, 57),
                    help="57 adds the 50-bin signal histogram features "
                    "(myDetect.py:885-891)")
    ap.add_argument("--trainPrecision", default="fp32",
                    choices=("fp32", "bf16"),
                    help="the training kernels' sequence storage in both "
                    "train phases")
    ap.add_argument("--labels", default="motif", choices=("motif", "pos"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--epochs", type=int, default=4,
                    help="epochs of each train phase (the reference's 4)")
    ap.add_argument("--hidden", type=int, default=100)
    ap.add_argument("--train-reads", type=int, default=None,
                    help="reads of each training cohort (default by size)")
    ap.add_argument("--test-reads", type=int, default=None,
                    help="reads of each held-out cohort (default by size)")
    args = ap.parse_args(argv)
    print(_probe.header(args.device), flush=True)
    print(json.dumps(run_loop(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
