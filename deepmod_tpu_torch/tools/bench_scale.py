"""Detect end to end on a 30x synthetic cohort over a 1 Mbp genome.

    python -m deepmod_tpu_torch.tools.bench_scale [--dataset DIR]
        [--reads 4000] [--genome-mbp 1.0] [--threads 2] [--target-only]
        [--runs 1] [--device cuda] [--hidden 100]

Counterpart of ``scripts/bench_scale.py``. Generates (once, under
``--dataset``; default a ``dmt_scale`` folder in the temporary directory,
never the repository) ``--reads`` long reads (5-10 kb) with a CG-motif
signal shift: fast5 where h5py is importable, else pod5 files of 25 reads
and one basecall BAM. Then runs the whole detect pipeline ``--runs``
times with one seeded full-width model (bf16) and, above one thread, one
HostPool across the runs: run 0 pays the workers' start-up and the
kernels' build, later runs are warm. Prints a JSON line a run: windows a
second over the wall, reads, windows, the stage seconds, the BED count
and the error classes. 4,000 reads of 5-10 kb on 1 Mbp are ~30x (the
reference's 30x E. coli protocol, docs/Reproducibility.md:26,30).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _host_bench, _probe

READS_PER_FILE = 25    # pod5 reads a file
READS_PER_BATCH = 250  # the JAX script's 250 one-read fast5 files a batch


def ensure_dataset(ds: str, reads: int, genome_mbp: float) -> str:
    """Write the cohort under ``ds`` unless it is there; its format."""
    fmt = _host_bench.default_format()
    if not os.path.isdir(os.path.join(ds, fmt)):
        t0 = time.time()
        _host_bench.write_dataset(
            ds, fmt, n_files=-(-reads // READS_PER_FILE),
            genome_sizes={"chr1": int(genome_mbp * 1_000_000)},
            num_reads=reads, read_length=(5000, 10000), seed=42,
            mod_motif="CG", mod_level_shift=1.2)
        print(f"generated dataset ({fmt}) in {time.time() - t0:.1f}s",
              flush=True)
    return fmt


def detect_config(ds: str, fmt: str, threads: int, device: str,
                  model_path: str = "unused"):
    """detect over the cohort: BEDs, and per-read files where h5py is
    present (fast5); READS_PER_BATCH reads a batch."""
    from deepmod_tpu_torch.engine.detect import DetectConfig

    return DetectConfig(
        wrk_base=os.path.join(ds, fmt), ref=os.path.join(ds, "ref.fa"),
        model_path=model_path, out_folder=os.path.join(ds, "out"),
        file_id="mod", base="C", align_str="builtin", threads=threads,
        files_per_batch=(READS_PER_BATCH if fmt == "fast5"
                         else READS_PER_BATCH // READS_PER_FILE),
        write_per_read=fmt == "fast5",
        basecalls=os.path.join(ds, "calls.bam") if fmt == "pod5" else "",
        device=device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.bench_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset",
                    default=os.path.join(tempfile.gettempdir(), "dmt_scale"))
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--genome-mbp", type=float, default=1.0)
    ap.add_argument("--target-only", action="store_true")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hidden", type=int, default=100,
                    help="the seeded model's width (the reference's 100)")
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.engine.detect import (
        WindowPredictor,
        _host_options,
        detect_run,
    )
    from deepmod_tpu_torch.engine.host_pool import HostPool
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz

    print(_probe.header(args.device), flush=True)
    ds = args.dataset
    fmt = ensure_dataset(ds, args.reads, args.genome_mbp)
    params, mc = _probe.seeded_model(7, args.hidden)
    model_path = os.path.join(ds, "model.npz")
    save_bilstm_npz(model_path, params, mc)
    predictor = WindowPredictor(params, mc, device=args.device,
                                precision="bf16")
    cfg = dataclasses.replace(
        detect_config(ds, fmt, args.threads, args.device, model_path),
        target_only=args.target_only)
    pool = (HostPool(args.threads, _host_options(cfg))
            if args.threads > 1 else None)
    try:
        for i in range(args.runs):
            run_cfg = dataclasses.replace(
                cfg, out_folder=os.path.join(ds, f"out_{i}"))
            r, dt = _probe.wall(
                lambda: detect_run(run_cfg, predictor, host_pool=pool),
                args.device)
            print(json.dumps({
                "metric": "detect_scale_windows_per_s",
                "value": r.num_windows / dt, "unit": "windows/s",
                "run": i, "reads": r.num_reads, "windows": r.num_windows,
                "wall_s": dt, "threads": args.threads,
                "target_only": args.target_only, "device": args.device,
                "format": fmt, "per_read_files": cfg.write_per_read,
                "stages": dict(sorted(r.stage_seconds.items())),
                "beds": len(r.bed_files),
                "errors": {k: len(v) for k, v in r.errors.items()},
            }), flush=True)
    finally:
        if pool is not None:
            pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
