"""Same-process A/B/C of ``detect --targetOnly``.

    python -m deepmod_tpu_torch.tools.probe_target_only [--dataset DIR]
        [--reads 4000] [--genome-mbp 1.0] [--threads 2] [--device cuda]
        [--hidden 100]

Counterpart of ``scripts/probe_target_only.py``. Three modes through
``detect_run`` and one HostPool (above one thread), on ``bench_scale``'s
cohort (``--dataset``, written there first unless present):

  A standard        the compact transfer classifies every built row;
  B targetOnly      compact transfer: the C selection is dense (~25%),
                    so the predictor stays on the compact path (it routes
                    to window transfer below one selected row a window);
  C targetOnly+win  compact transfer off: materialized windows of only
                    the selected centers.

A warm-up pass first (the workers' start-up and the kernels' build), then
each mode once, each a host clock around a synchronized run. The BEDs of
the three modes must be the same bytes (checked: a difference exits
non-zero). Prints a JSON line a mode (wall, windows a second, stages,
BEDs) and the BEDs' md5s.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _probe
from deepmod_tpu_torch.tools.bench_scale import detect_config, ensure_dataset


def bed_md5(folder: str, names) -> dict:
    out = {}
    for name in names:
        with open(os.path.join(folder, name), "rb") as fh:
            out[name] = hashlib.md5(fh.read()).hexdigest()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_target_only",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset",
                    default=os.path.join(tempfile.gettempdir(), "dmt_scale"))
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--genome-mbp", type=float, default=1.0)
    ap.add_argument("--threads", type=int, default=2)
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

    print(_probe.header(args.device), flush=True)
    ds = args.dataset
    fmt = ensure_dataset(ds, args.reads, args.genome_mbp)
    params, mc = _probe.seeded_model(7, args.hidden)
    compact = WindowPredictor(params, mc, device=args.device,
                              precision="bf16", compact_transfer=True)
    windowed = WindowPredictor(params, mc, device=args.device,
                               precision="bf16", compact_transfer=False)
    cfg = detect_config(ds, fmt, args.threads, args.device)
    modes = [("A_standard_compact", compact, {}),
             ("B_targetonly_compact", compact, dict(target_only=True)),
             ("C_targetonly_window", windowed, dict(target_only=True))]
    pool = (HostPool(args.threads, _host_options(cfg))
            if args.threads > 1 else None)
    results = {}
    try:
        detect_run(dataclasses.replace(
            cfg, out_folder=os.path.join(ds, "out_probe_warm")), compact,
            host_pool=pool)
        for tag, predictor, overrides in modes:
            run_cfg = dataclasses.replace(
                cfg, out_folder=os.path.join(ds, f"out_probe_{tag}"),
                **overrides)
            r, dt = _probe.wall(
                lambda: detect_run(run_cfg, predictor, host_pool=pool),
                args.device)
            results[tag] = {
                "wall_s": dt, "windows_per_s": r.num_windows / dt,
                "windows": r.num_windows,
                "stages": dict(sorted(r.stage_seconds.items())),
                "beds": sorted(os.path.basename(b) for b in r.bed_files),
            }
            print(json.dumps({tag: results[tag]}), flush=True)
    finally:
        if pool is not None:
            pool.close()
    md5s = {tag: bed_md5(os.path.join(ds, f"out_probe_{tag}"),
                         results[tag]["beds"]) for tag, _, _ in modes}
    identical = all(m == md5s[modes[0][0]] for m in md5s.values()) and bool(
        md5s[modes[0][0]])
    print(json.dumps({"beds_identical": identical, "md5": md5s,
                      "device": args.device}), flush=True)
    if not identical:
        raise SystemExit("the three modes' BEDs differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
