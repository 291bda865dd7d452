"""Same-process A/B of the packed and unpacked compact transfer through
``WindowPredictor``.

    python -m deepmod_tpu_torch.tools.probe_compact_pack [--rows 4194304]
        [--passes 3] [--fnum 7|57] [--device cuda]

Counterpart of ``scripts/probe_compact_pack.py``. "plain" is detect's
default: the fp32 rows as they stand, cast to the kernel's dtype on the
card (28 B a row at ``--fnum 7``, 228 at 57). "packed" is the opt-in
pack, its columns cast on the host: ``--fnum 7`` the 4 one-hot columns
as one uint8 code (``DMT_COMPACT_PACK=1``; bf16: 7 B a row), ``--fnum
57`` also the 50 histogram columns as uint8 (``DMT_COMPACT_PACK57=1``;
bf16: 57 B a row). One process alternates the two modes over the same
block of engine-shaped rows, so the card and its link are the same for
both; the packed predictions must equal the plain ones (checked: a
mismatch exits non-zero). Each pass is a host
clock around a synchronized call. Prints a JSON line a pass and a summary
line with the bytes each mode moved a row. ``--fnum 57`` caps the rows at
2,097,152 (57-wide rows). On the card bf16 by default, on the CPU fp32
(the kernels' plain versions: a check, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _probe

# the environment variable that switches each pack ("1" on, "0" off)
PACK_ENV = {7: "DMT_COMPACT_PACK", 57: "DMT_COMPACT_PACK57"}


def predictors(params, config, fnum: int, device: str, precision: str,
               buckets):
    """(packed, plain) compact-transfer predictors: the pack switched on
    and off by its environment variable, as in the JAX package."""
    from deepmod_tpu_torch.engine.detect import WindowPredictor

    name = PACK_ENV[fnum]
    saved = os.environ.get(name)
    made = []
    try:
        for value in ("1", "0"):
            os.environ[name] = value
            made.append(WindowPredictor(
                params, config, buckets=buckets, device=device,
                precision=precision, compact_transfer=True))
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved
    packed, plain = made
    flag = "_pack_hist" if fnum == 57 else "_pack_onehot"
    if not getattr(packed, flag) or getattr(plain, flag):
        raise RuntimeError(f"{name} did not switch the pack")
    return packed, plain


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_compact_pack",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--fnum", type=int, default=7, choices=(7, 57))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    cuda = torch.device(args.device).type == "cuda"
    precision = "bf16" if cuda else "fp32"
    rows = args.rows if args.fnum == 7 else min(args.rows, 2 * 1024 * 1024)
    # one 262,144-row bucket on the card (the JAX probe's); the CPU
    # predictor's own buckets elsewhere
    buckets = (262144,) if cuda else None
    params, config = _probe.seeded_model(args.fnum)
    feats = _probe.engine_rows(np.random.RandomState(1), rows, args.fnum)
    centers = np.arange(16, rows - 16, dtype=np.int64)
    packed, plain = predictors(params, config, args.fnum, args.device,
                               precision, buckets)
    print(_probe.header(args.device), flush=True)

    # warm both, and the identity check
    row_bytes = {}  # host->device bytes a feature row, padding included
    outs = {}
    for name, pred in (("plain", plain), ("packed", packed)):
        before = pred.transfer_bytes
        outs[name], _ = _probe.wall(
            lambda: pred.predict_from_features(feats, centers), args.device)
        row_bytes[name] = (pred.transfer_bytes - before) / rows
    identical = bool(np.array_equal(outs["packed"], outs["plain"]))
    if not identical:
        print(json.dumps({"identical": False}), flush=True)
        raise SystemExit("packed/unpacked prediction mismatch")

    results = {"packed": [], "plain": []}
    for _ in range(args.passes):
        for name, pred in (("plain", plain), ("packed", packed)):
            _, dt = _probe.wall(
                lambda: pred.predict_from_features(feats, centers),
                args.device)
            results[name].append(dt)
            print(json.dumps({
                "mode": name, "wall_s": dt,
                "windows_per_s": len(centers) / dt,
            }), flush=True)
    best = {k: min(v) for k, v in results.items()}
    print(json.dumps({
        "metric": "compact_pack_speedup",
        "value": best["plain"] / best["packed"],
        "unit": "x (plain_best / packed_best)",
        "best_plain_s": best["plain"], "best_packed_s": best["packed"],
        "rows": rows, "fnum": args.fnum, "identical": identical,
        "transfer_bytes_per_row": row_bytes, "modes": {
            "packed": sorted(map(str, packed.compact_modes)),
            "plain": sorted(map(str, plain.compact_modes))},
        "device": args.device, "precision": precision,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
