"""The host stage's rate on one thread: ingest -> align -> features.

    python -m deepmod_tpu_torch.tools.bench_host [--repeats 3]

Counterpart of ``scripts/bench_host.py``: ``host_process_files`` over each
synthetic profile, warm (aligner index built, one warm-up call), the best
of ``--repeats`` passes, in windows a second on one thread. The stage
timers inside detect understate the host's cost, because detect overlaps
it with device time; this tool does not. Each profile runs twice in one
process: on the numpy twins (``native.use_native(False)``) and on the
native library; the two must give the same feature rows and centers, bit
for bit. The data is fast5 where h5py is importable (the native fast5
reader needs its libhdf5), else pod5 + a basecall BAM (move tables).
Prints the host's core count and the card's ``nvidia-smi`` line, then one
JSON line a profile.
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

from deepmod_tpu_torch.tools import _host_bench

PROFILES = {
    # ~2.1k events/read: per-file costs (file open) weigh heavier
    "short_reads": dict(
        genome_sizes={"chrS": 50000}, num_reads=120,
        read_length=(1500, 3000), seed=11,
    ),
    # ~7k events/read: the steady state of long reads
    "long_reads": dict(
        genome_sizes={"chrS": 120000}, num_reads=60,
        read_length=(5000, 10000), seed=11,
    ),
}


def _rate(files, repeats: int):
    """(best windows/s, windows, the last pass's results)."""
    from deepmod_tpu_torch.engine import host_worker

    host_worker.host_process_files(files[: max(4, len(files) // 20)])
    best, windows, results = 0.0, 0, []
    for _ in range(repeats):
        t0 = time.perf_counter()
        results, _errs = host_worker.host_process_files(files)
        dt = time.perf_counter() - t0
        windows = sum(r.n_aligned for r in results)
        best = max(best, windows / dt)
    return best, windows, results


def bench_profile(name: str, fmt: str, repeats: int) -> dict:
    import numpy as np

    from deepmod_tpu_torch.engine import host_worker
    from deepmod_tpu_torch.engine.detect import DetectConfig, _host_options
    from deepmod_tpu_torch.engine.outputs import build_batch_request
    from deepmod_tpu_torch.native import lib

    work = tempfile.mkdtemp(prefix="dmt_bench_host_")
    try:
        folder = _host_bench.write_dataset(work, fmt, **PROFILES[name])
        cfg = DetectConfig(
            wrk_base=folder, ref=os.path.join(work, "ref.fa"),
            model_path="unused", out_folder="unused", move=fmt == "pod5",
            basecalls=os.path.join(work, "calls.bam") if fmt == "pod5" else "",
        )
        files = sorted(glob.glob(os.path.join(folder, "**", f"*.{fmt}"),
                                 recursive=True))
        out = {"metric": f"host_windows_per_s_{name}", "format": fmt,
               "unit": "windows/s/thread", "files": len(files)}
        rows = {}
        for mode in ("numpy", "native"):
            lib.use_native(mode == "native")
            host_worker.init_worker(_host_options(cfg))  # index per mode
            out[mode], out["windows"], results = _rate(files, repeats)
            feats, centers, _, _ = build_batch_request(results)
            rows[mode] = (feats, centers)
        lib.use_native(True)
        out["speedup"] = out["native"] / out["numpy"]
        out["rows_equal"] = bool(
            np.array_equal(rows["numpy"][0], rows["native"][0])
            and np.array_equal(rows["numpy"][1], rows["native"][1])
        )
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.bench_host",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.native import lib

    fmt = _host_bench.default_format()
    print(_host_bench.machine_line(), flush=True)
    if not lib.native_available():
        print(f"native library unavailable: {lib.build_info['error']}",
              file=sys.stderr)
        return 1
    ok = True
    for name in PROFILES:
        res = bench_profile(name, fmt, args.repeats)
        ok &= res["rows_equal"]
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
