"""Site-level AUC/AP against per-site coverage.

    python -m deepmod_tpu_torch.tools.coverage_scaling [--out DIR]
        [--small] [--threads 2] [--device cuda] [--epochs 4]
        [--hidden 100]

Counterpart of ``scripts/coverage_scaling.py``: aggregating per-read
calls over coverage multiplies discrimination, pushing site-level AUC
toward the per-read ceiling (the reference's 30x protocol assumes it,
docs/Reproducibility.md:38-45). One synthetic cohort at ~30x is trained
on and classified ONCE; lower coverages come from subsampling its READS
and re-aggregating their predictions, so the comparison isolates coverage
itself.

On the pod5 route (pod5 + basecall BAM cohorts, no h5py): the JAX script
thins the per-read predetail HDF5 files of a detect run; here the
held-out cohorts go through detect's own stages in this process (the
host stage ``host_process_files``, ``predict_batch_windows`` on
``--device``, the outputs stage ``write_batch_outputs`` without per-read
files), and each coverage re-runs only the outputs stage over a read
subsample of the same predictions, then writes BEDs and scores them with
``tools.evaluate.ecoli_performance`` (the control cohort as negatives).
Training is ``train_run`` (``--epochs`` epochs, then as many
class-weighted from that checkpoint). Sizes: a 50 kb genome, 400 + 400
training and 670 + 670 held-out reads (~30x); ``--small``: 20 kb, 60,
80, coverages 2x and 4x, a stronger signal shift (2.5 against 1.2);
``--train-reads`` / ``--test-reads`` set the cohorts' reads.
Prints a JSON line a coverage and one at the end, ``{"coverage_scaling":
{coverage: metrics}, ...}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _probe

CHROM = "chrV"


def classify(cohort: str, model: str, device: str, threads: int):
    """(host results, predictions) of every read of a ``write_cohort``
    folder: detect's host and device stages in this process."""
    from deepmod_tpu_torch.engine.detect import (
        DetectConfig,
        WindowPredictor,
        _host_options,
        predict_batch_windows,
    )
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.models.tf_import import load_model

    config = DetectConfig(
        wrk_base=os.path.join(cohort, "pod5"),
        ref=os.path.join(cohort, "ref.fa"), model_path=model,
        out_folder="", align_str="builtin", base="C",
        basecalls=os.path.join(cohort, "calls.bam"), write_per_read=False,
        device=device, threads=threads)
    init_worker(_host_options(config))
    results, _ = host_process_files(
        sorted(glob.glob(os.path.join(cohort, "pod5", "*.pod5"))))
    params, model_config = load_model(model)
    predictor = WindowPredictor(params, model_config, device=device,
                                precision=config.precision)
    return config, results, predict_batch_windows(results, predictor)


def subsample_beds(config, results, preds: np.ndarray, frac: float,
                   out_dir: str, seed: int) -> list:
    """BEDs of a read subsample (each read kept with probability
    ``frac``) of one classification's predictions."""
    from deepmod_tpu_torch.aggregate.summarize import write_bed
    from deepmod_tpu_torch.engine.detect import _output_options
    from deepmod_tpu_torch.engine.outputs import write_batch_outputs

    rng = np.random.RandomState(seed)
    ends = np.cumsum([r.n_aligned for r in results])
    keep = [i for i in range(len(results)) if rng.rand() < frac]
    sub = [results[i] for i in keep]
    sub_preds = np.concatenate(
        [preds[ends[i] - results[i].n_aligned : ends[i]] for i in keep]
        or [np.empty(0, preds.dtype)])
    counts = {}
    write_batch_outputs(sub, sub_preds, _output_options(config), counts, 0,
                        out_dir)
    os.makedirs(out_dir, exist_ok=True)
    beds = []
    for (chrom, strand), pc in sorted(counts.items()):
        path = os.path.join(out_dir, f"mod_pos.{chrom}{strand}.C.bed")
        if write_bed(path, chrom, strand, "C", pc) > 0:
            beds.append(path)
    return beds


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.coverage_scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dmt_coverage"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=100)
    ap.add_argument("--train-reads", type=int, default=None,
                    help="reads of each training cohort (default by size)")
    ap.add_argument("--test-reads", type=int, default=None,
                    help="reads of each held-out cohort (default by size)")
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.engine.getfeatures import (
        GetFeaturesConfig,
        getfeatures_run,
    )
    from deepmod_tpu_torch.testing.synthetic import make_genome
    from deepmod_tpu_torch.tools.evaluate import ecoli_performance
    from deepmod_tpu_torch.train.loader import find_feature_files
    from deepmod_tpu_torch.train.trainer import TrainConfig, train_run

    print(_probe.header(args.device), flush=True)
    genome_size = 20_000 if args.small else 50_000
    n_train = args.train_reads or (60 if args.small else 400)
    # ~30x: reads of ~2.25 kb
    n_test = args.test_reads or (80 if args.small else 670)
    shift = 2.5 if args.small else 1.2
    base = args.out
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    genome = make_genome(np.random.RandomState(42), {CHROM: genome_size})
    t0 = time.time()
    sets = {}
    for name, n, seed, sh in (("train_mod", n_train, 11, shift),
                              ("train_ctl", n_train, 12, 0.0),
                              ("test_mod", n_test, 13, shift),
                              ("test_ctl", n_test, 14, 0.0)):
        sets[name] = _probe.write_cohort(os.path.join(base, name), n, seed,
                                         sh, genome)
    ref = os.path.join(sets["train_mod"], "ref.fa")
    print(f"[synth {time.time() - t0:.1f}s]", flush=True)
    for name, posneg in (("train_mod", 1), ("train_ctl", 0)):
        getfeatures_run(GetFeaturesConfig(
            wrk_base=os.path.join(sets[name], "pod5"), ref=ref,
            basecalls=os.path.join(sets[name], "calls.bam"),
            out_folder=os.path.join(base, f"feat_{name}"), posneg=posneg,
            motif="CG", align_str="builtin", threads=args.threads,
            save_format="npz"))
    print(f"[features {time.time() - t0:.1f}s]", flush=True)
    groups = [find_feature_files(os.path.join(base, "feat_train_mod")),
              find_feature_files(os.path.join(base, "feat_train_ctl"))]
    common = dict(epochs=args.epochs, hidden=args.hidden, seed=1,
                  log_every=50, device=args.device)
    params, _, _ = train_run(groups, TrainConfig(
        out_folder=os.path.join(base, "train1"), **common))
    train_run(groups, TrainConfig(
        out_folder=os.path.join(base, "train2"), unbalanced=True, **common),
        init_params=params,
        resume_opt_from=os.path.join(base, "train1", str(args.epochs),
                                     "mod.npz"))
    model = os.path.join(base, "train2", str(args.epochs), "mod.npz")
    print(f"[train {time.time() - t0:.1f}s]", flush=True)
    runs = {name: classify(sets[name], model, args.device, args.threads)
            for name in ("test_mod", "test_ctl")}
    print(f"[detect {time.time() - t0:.1f}s]", flush=True)

    results = {}
    full_cov = 4 if args.small else 30
    for cov in ((2, 4) if args.small else (5, 15, 30)):
        beds = {name: subsample_beds(
            *runs[name], cov / full_cov,
            os.path.join(base, f"sub_{name}_{cov}x"),
            seed=cov + (100 if name == "test_ctl" else 0))
            for name in runs}
        m = ecoli_performance(beds["test_mod"], beds["test_ctl"], ref,
                              motif="CG",
                              out_prefix=os.path.join(base, f"perf_{cov}x"),
                              make_plots=False)
        results[f"{cov}x"] = {k: v for k, v in m.items()
                              if k.startswith(("auc", "ap", "num", "read_"))}
        print(f"[{cov}x] " + json.dumps(results[f"{cov}x"]), flush=True)
    print(json.dumps({"coverage_scaling": results, "device": args.device,
                      "total_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
