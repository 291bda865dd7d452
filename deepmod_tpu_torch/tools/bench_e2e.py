"""Warm end-to-end detect: reads -> align -> features -> classify on the
card -> BEDs (and per-read files where h5py is present).

    python -m deepmod_tpu_torch.tools.bench_e2e [--threads 1,4]
        [--reads 800] [--device cuda] [--keep]

Counterpart of ``scripts/bench_e2e.py``: detect runs over one synthetic
dataset with a shared ``WindowPredictor`` (and, at more than one thread,
a shared ``HostPool``). The first pass warms the weights, the workers and
their aligner index; the second is timed, so neither the upload nor the
workers' start-up is in its wall; on the card a third, traced with
torch.profiler, gives the card's idle share over a warm pass. Each
``--threads`` count is its own passes in this process, so the counts
compare within one call. The data is fast5 where h5py is importable, else
pod5 + a basecall BAM, READS_PER_FILE reads a pod5 file (fast5 is one
read a file), FILES_PER_BATCH files a batch, bf16. Prints the host's core
count and the card's ``nvidia-smi`` line, then one JSON line a count:
the wall, windows a second, detect's stage seconds, the host share of the
wall (the engine's time waiting on the host stage over the wall) and the
traced pass's idle share.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _host_bench

# the engine's wait on the host stage: the single-process path waits on
# its prefetch thread, the pooled path on the workers' messages
HOST_WAIT_STAGES = ("host_ingest_align_features", "wait_for_host_workers")
READS_PER_FILE = 25
FILES_PER_BATCH = 2
PRECISION = "bf16"


def host_share(result) -> float:
    """The share of a detect wall the engine spent waiting on the host."""
    wait = sum(result.stage_seconds.get(k, 0.0) for k in HOST_WAIT_STAGES)
    return wait / result.elapsed_s if result.elapsed_s else 0.0


def run(work: str, threads: int, predictor, config) -> dict:
    from deepmod_tpu_torch.engine.detect import (
        _host_options,
        detect_run,
        discover_fast5,
    )
    from deepmod_tpu_torch.engine.host_pool import HostPool

    config = dataclasses.replace(config, threads=threads)
    tags = ["cold", "warm"]
    if config.device.startswith("cuda"):
        tags.append("traced")
    pool = None
    if threads > 1:
        pool = HostPool(threads, _host_options(config))
    try:
        passes = {}
        for tag in tags:
            out = os.path.join(work, f"out_{threads}_{tag}")
            cfg = dataclasses.replace(
                config, out_folder=out,
                trace_dir=os.path.join(out, "trace") if tag == "traced"
                else None)
            t0 = time.perf_counter()
            result = detect_run(cfg, predictor, host_pool=pool)
            passes[tag] = (time.perf_counter() - t0, result)
    finally:
        if pool is not None:
            pool.close()
    wall, result = passes["warm"]
    res = {
        "metric": "detect_e2e_windows_per_s",
        "threads": threads,
        "value": result.num_windows / wall,
        "unit": "windows/s",
        "wall_s": wall,
        "cold_wall_s": passes["cold"][0],
        "host_share": host_share(result),
        "reads": result.num_reads,
        "windows": result.num_windows,
        "batches": -(-len(discover_fast5(config.wrk_base))
                     // config.files_per_batch),
        "errors": {k: len(v) for k, v in result.errors.items()},
        "stage_seconds": dict(sorted(result.stage_seconds.items())),
    }
    if "traced" in passes:
        busy, span, idle = _host_bench.trace_idle_share(os.path.join(
            work, f"out_{threads}_traced", "trace", "detect.json"))
        res["traced"] = {"wall_s": passes["traced"][0], "busy_s": busy,
                         "span_s": span, "idle_share": idle}
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.bench_e2e",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1",
                    help="comma-separated worker counts, e.g. 1,4")
    ap.add_argument("--reads", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.engine.detect import DetectConfig, WindowPredictor
    from deepmod_tpu_torch.models.bilstm import (
        BiLSTMConfig,
        init_bilstm_params,
    )
    from deepmod_tpu_torch.native import lib

    fmt = _host_bench.default_format()
    print(_host_bench.machine_line(), flush=True)
    print(f"native host library loaded: {lib.native_available()}",
          flush=True)
    work = tempfile.mkdtemp(prefix="dmt_bench_e2e_")
    try:
        t0 = time.perf_counter()
        folder = _host_bench.write_dataset(
            work, fmt, n_files=-(-args.reads // READS_PER_FILE),
            genome_sizes={"chrS": 200_000}, num_reads=args.reads,
            read_length=(1500, 3000), seed=11,
        )
        print(f"dataset: {args.reads} reads, {fmt}, "
              f"{time.perf_counter() - t0:.2f} s to write", flush=True)
        model_config = BiLSTMConfig(num_input=7)
        params = init_bilstm_params(0, model_config, device="cpu")
        predictor = WindowPredictor(params, model_config, device=args.device,
                                    precision=PRECISION)
        try:
            import h5py  # noqa: F401
            per_read = True
        except ImportError:
            per_read = False  # the predetail writer needs h5py
        config = DetectConfig(
            wrk_base=folder, ref=os.path.join(work, "ref.fa"),
            model_path="unused", out_folder="unused", align_str="builtin",
            basecalls=(os.path.join(work, "calls.bam")
                       if fmt == "pod5" else ""),
            files_per_batch=FILES_PER_BATCH, write_per_read=per_read,
            precision=PRECISION, device=args.device,
        )
        for threads in (int(t) for t in args.threads.split(",")):
            res = run(work, threads, predictor, config)
            res.update(device=args.device, precision=PRECISION, format=fmt,
                       per_read_files=per_read)
            print(json.dumps(res), flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
