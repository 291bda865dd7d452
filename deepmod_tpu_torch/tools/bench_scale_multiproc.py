"""Multi-process detect scaling: the merge overhead at 1, 2 and 3
processes.

    python -m deepmod_tpu_torch.tools.bench_scale_multiproc [--reads 120]
        [--genome-bp 200000] [--nprocs 1,2,3] [--device cuda]
        [--workdir DIR] [--out FILE]

Counterpart of ``scripts/bench_scale_multiproc.py``. The same synthetic
detect (a pod5 + basecall BAM set, ``--reads`` reads on one
``--genome-bp`` chromosome) runs as ``torch.distributed`` ranks of
``testing/multihost_worker.py`` (fresh interpreters, a localhost TCP
store, two shards of ``--device`` a rank, the worker's rule predictor in
place of a model, so BEDs are exact across topologies) at each process
count, over gloo: on the CPU, and on one card as ranks sharing it, which
nccl refuses (with several cards rank r takes card r mod the cards, still
over gloo). Per process count it reports the reads and windows a second
over the slowest rank's engine wall, and the ``cross_process_merge``
stage (the end-of-run count and index merge that replaces the
reference's filesystem merge barrier, myDetect.py:1196-1221) in seconds
and as a share of that wall. Ranks share the host's cores, so absolute
rates need not scale with the process count here; the merge share is the
communication cost. The dataset goes under ``--workdir`` (default a new
temporary directory, removed at the end).
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

from deepmod_tpu_torch.tools import _probe


def run_cluster(nproc: int, dataset: str, workdir: str, device: str,
                timeout: float) -> dict:
    from deepmod_tpu_torch.testing.multihost_worker import run_ranks

    out_folder = os.path.join(workdir, f"out_n{nproc}")
    t0 = time.perf_counter()
    recs = run_ranks(
        nproc, os.path.join(workdir, f"ranks_n{nproc}"),
        ("detect", dataset, out_folder, "--device", device, "--backend",
         "gloo", "--basecalls", os.path.join(dataset, "calls.bam")),
        timeout=timeout)
    wall = time.perf_counter() - t0
    reads = sum(r["num_reads"] for r in recs)
    windows = sum(r["num_windows"] for r in recs)
    # the collective runs in lockstep on every process; early finishers
    # wait inside it, so the slowest rank's stage is the worst case
    merges = [r["stage_seconds"].get("cross_process_merge", 0.0)
              for r in recs]
    walls = [r["wall_s"] for r in recs]
    return {
        "nproc": nproc,
        "cluster_wall_s": wall,
        "engine_wall_s_max": max(walls),
        "reads_total": reads,
        "windows_total": windows,
        "reads_per_s": reads / max(walls),
        "windows_per_s": windows / max(walls),
        "merge_s_max": max(merges),
        "merge_s_min": min(merges),
        "merge_frac_of_wall": max(merges) / max(walls),
        "beds": {name: open(os.path.join(out_folder, name)).read()
                 for name in recs[0]["beds"]},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.bench_scale_multiproc",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=120)
    ap.add_argument("--genome-bp", type=int, default=200_000)
    ap.add_argument("--nprocs", default="1,2,3")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.testing.synthetic import make_genome
    from deepmod_tpu_torch.utils.device import resolve_device

    import numpy as np

    resolve_device(args.device)  # no card: raise here, not in every rank
    print(_probe.header(args.device), flush=True)
    workdir = args.workdir or tempfile.mkdtemp(prefix="dmt_scale_mp_")
    try:
        dataset = os.path.join(workdir,
                               f"ds_r{args.reads}_g{args.genome_bp}")
        if not os.path.isdir(os.path.join(dataset, "pod5")):
            genome = make_genome(np.random.RandomState(17),
                                 {"chrM": args.genome_bp})
            _probe.write_cohort(dataset, args.reads, 17, 1.2, genome,
                                n_files=max(3, args.reads // 20))
        rows = []
        for nproc in (int(n) for n in args.nprocs.split(",")):
            print(f"running {nproc}-process group...", file=sys.stderr,
                  flush=True)
            rows.append(run_cluster(nproc, dataset, workdir, args.device,
                                    args.timeout))
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "beds"}), flush=True)
        # rank 0's BEDs: the same bytes at every process count
        beds = [r.pop("beds") for r in rows]
        if not beds[0] or any(b != beds[0] for b in beds):
            raise SystemExit("the process counts wrote different BEDs")
        base = rows[0]["windows_per_s"]
        summary = {
            "metric": "detect_multiproc_merge_overhead",
            "device": args.device,
            "rows": rows,
            "beds_identical": True,
            "note": ("ranks share the host's cores, so absolute reads/s "
                     "need not scale here; merge_frac_of_wall is the "
                     "communication cost"),
            "throughput_vs_1proc": [r["windows_per_s"] / base
                                    for r in rows],
        }
        print(json.dumps(summary), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(summary, fh, indent=2)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
