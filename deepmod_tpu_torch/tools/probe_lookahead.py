"""Same-process sweep of the predictor's chunk-queue depth.

    python -m deepmod_tpu_torch.tools.probe_lookahead [--rows 4194304]
        [--passes 3] [--depths 2,4,8] [--device cuda]

Counterpart of ``scripts/probe_lookahead.py``. ``engine/detect.py``'s
``_LOOKAHEAD`` is how many chunks ``WindowPredictor`` keeps in flight:
chunk i+k is cut, cast and copied to the card while chunk i computes, and
a chunk's result is fetched only when the queue is full. Each depth runs
the compact predictor (bf16 on the card, fp32 on the CPU; 262,144-row
buckets on the card) over one block of engine-shaped rows, the depths in
turns for ``--passes`` passes, each a host clock around a synchronized
call. Prints a JSON line a (depth, pass) and the best wall a depth; the
predictions must not depend on the depth (checked).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _probe


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_lookahead",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--depths", default="2,4,8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import deepmod_tpu_torch.engine.detect as D

    cuda = torch.device(args.device).type == "cuda"
    print(_probe.header(args.device), flush=True)
    params, config = _probe.seeded_model(7)
    feats = _probe.engine_rows(np.random.RandomState(1), args.rows)
    centers = np.arange(16, args.rows - 16, dtype=np.int64)
    pred = D.WindowPredictor(
        params, config, buckets=(262144,) if cuda else None,
        device=args.device, precision="bf16" if cuda else "fp32",
        compact_transfer=True)
    want = pred.predict_from_features(feats, centers)  # warm-up
    depths = [int(d) for d in args.depths.split(",")]
    default = D._LOOKAHEAD
    best = {}
    try:
        for _ in range(args.passes):
            for depth in depths:
                D._LOOKAHEAD = depth
                got, dt = _probe.wall(
                    lambda: pred.predict_from_features(feats, centers),
                    args.device)
                if not np.array_equal(got, want):
                    raise SystemExit(f"depth {depth}: predictions differ")
                best[depth] = min(best.get(depth, float("inf")), dt)
                print(json.dumps({"depth": depth, "wall_s": dt,
                                  "windows_per_s": len(centers) / dt}),
                      flush=True)
    finally:
        D._LOOKAHEAD = default
    print(json.dumps({
        "metric": "lookahead_best_walls",
        "value": {str(k): v for k, v in sorted(best.items())},
        "rows": args.rows, "default_depth": default, "device": args.device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
