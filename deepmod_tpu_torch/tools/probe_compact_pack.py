"""Same-process A/B of detect's compact transfer against a packed one.

    python -m deepmod_tpu_torch.tools.probe_compact_pack [--rows 4194304]
        [--passes 3] [--fnum 7|57] [--device cuda]

Counterpart of ``scripts/probe_compact_pack.py``. "plain" is detect's
compact transfer through ``WindowPredictor``: the fp32 rows as they
stand, cast to the kernel's dtype on the card (28 B a row at ``--fnum
7``, 228 at 57). "packed" is the JAX package's pack, built here and
nowhere in the port: its columns cast on the host, ``--fnum 7`` the 4
one-hot columns as one uint8 code (bf16: 7 B a row), ``--fnum 57`` also
the 50 histogram columns as uint8 (bf16: 57 B a row), shipped through
pinned memory, the rows rebuilt on the device through a 5x4 LUT and
classified in place by the predictor's own model. One process alternates
the two over the same block of engine-shaped rows, so the card and its
link are the same for both; the packed predictions must equal the plain
ones (checked: a mismatch exits non-zero). Each pass is a host clock
around a synchronized call. Prints a JSON line a pass and a summary line
with the bytes each moved a row. ``--fnum 57`` caps the rows at 2,097,152
(57-wide rows). On the card bf16 by default, on the CPU fp32 (the
kernels' plain versions: a check, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepmod_tpu_torch.tools import _probe


def lut(dtype):
    """The 5x4 one-hot table: row k < 4 the k-th one-hot, row 4 (no
    base) zeros; exact in every dtype."""
    import torch

    table = torch.zeros(5, 4, dtype=dtype)
    table[:4] = torch.eye(4, dtype=dtype)
    return table


def pack_columns(features: np.ndarray, fnum: int, dtype) -> List:
    """The packed host columns of (rows, fnum) engine rows: ``[codes,
    rest]`` at fnum 7, ``[hist, codes, rest]`` at 57 (features/builder.py's
    layout: 50 histogram counts, the one-hot, mean, stdv, length). The
    codes are 0..3 for the hot column, 4 for none (uint8); the histogram
    counts uint8; the rest cast to ``dtype`` on the host. Raises
    ValueError for rows the pack cannot carry exactly: a one-hot column
    not 0/1, two hot columns, a count not an integer in [0, 256). Torch's
    threaded ops, not numpy's: this host pass is what the packed side of
    the A/B pays."""
    import torch

    x = torch.from_numpy(features)
    hot0 = fnum - 7
    onehot = x[:, hot0 : hot0 + 4]
    if not (((onehot == 0) | (onehot == 1)).all()
            and (onehot.sum(1) <= 1).all()):
        raise ValueError("the one-hot columns do not pack")
    codes = torch.where(onehot.any(1), onehot.argmax(1), 4).to(torch.uint8)
    cols = [codes, x[:, hot0 + 4 :].to(dtype)]
    if fnum == 57:
        hist = x[:, :50]
        if not ((hist >= 0) & (hist < 256) & (hist == hist.floor())).all():
            raise ValueError("a histogram count is not an integer in [0, 256)")
        cols.insert(0, hist.to(torch.uint8))
    return cols


def rebuild(columns: Sequence, table):
    """(rows, fnum) rows in ``table``'s dtype from ``pack_columns``'
    columns, on their device: the histogram counts cast, the one-hot
    through the LUT, the rest as shipped."""
    import torch

    *hist, codes, rest = columns
    return torch.cat([h.to(table.dtype) for h in hist]
                     + [table[codes.long()], rest], dim=1)


def predict_packed(pred, features: np.ndarray,
                   centers: np.ndarray) -> Tuple[np.ndarray, int]:
    """The packed transfer of ``features`` for ``pred``, a
    ``WindowPredictor`` on one device: the columns packed on the host
    (pinned on the card), shipped in chunks of the predictor's largest
    bucket of rows (the T-1 rows of halo shipped again), rebuilt on the
    device, every window of a chunk classified in place by the predictor's
    model; returns the predictions of the windows centred on ``centers``
    and the host->device bytes."""
    import torch

    from deepmod_tpu_torch.ops.bilstm_fused import seq_dtype

    window = pred.config.timesteps
    device = pred.device
    cuda = device.type == "cuda"
    cols = pack_columns(features, features.shape[1],
                        seq_dtype(pred.precision))
    if cuda:
        cols = [c.pin_memory() for c in cols]
    table = lut(seq_dtype(pred.precision)).to(device)
    rows = len(features)
    chunk = max(pred.buckets[-1], window)
    moved, preds = 0, []
    for row0 in range(0, rows - window + 1, chunk - window + 1):
        part = [c[row0 : row0 + chunk] for c in cols]
        moved += sum(c.numel() * c.element_size() for c in part)
        feats = rebuild([c.to(device, non_blocking=cuda) for c in part],
                        table)
        fnum = feats.shape[1]
        view = feats.as_strided((len(feats) - window + 1, window, fnum),
                                (fnum, fnum, 1))
        preds.append(pred._classify(view))
    every = torch.cat(preds).cpu().numpy()
    return every[np.asarray(centers) - window // 2], moved


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

    from deepmod_tpu_torch.engine.detect import WindowPredictor

    cuda = torch.device(args.device).type == "cuda"
    precision = "bf16" if cuda else "fp32"
    rows = args.rows if args.fnum == 7 else min(args.rows, 2 * 1024 * 1024)
    # one 262,144-row bucket on the card (the JAX probe's); the CPU
    # predictor's own buckets elsewhere
    buckets = (262144,) if cuda else None
    params, config = _probe.seeded_model(args.fnum)
    feats = _probe.engine_rows(np.random.RandomState(1), rows, args.fnum)
    centers = np.arange(16, rows - 16, dtype=np.int64)
    pred = WindowPredictor(params, config, buckets=buckets,
                           device=args.device, precision=precision,
                           compact_transfer=True)
    print(_probe.header(args.device), flush=True)

    def plain():
        before = pred.transfer_bytes
        out = pred.predict_from_features(feats, centers)
        return out, pred.transfer_bytes - before

    modes = (("plain", plain),
             ("packed", lambda: predict_packed(pred, feats, centers)))
    # warm both, and the identity check
    row_bytes = {}  # host->device bytes a feature row, halo included
    outs = {}
    for name, run in modes:
        (outs[name], moved), _ = _probe.wall(run, args.device)
        row_bytes[name] = moved / rows
    identical = bool(np.array_equal(outs["packed"], outs["plain"]))
    if not identical:
        print(json.dumps({"identical": False}), flush=True)
        raise SystemExit("packed/unpacked prediction mismatch")

    results = {"packed": [], "plain": []}
    for _ in range(args.passes):
        for name, run in modes:
            _, dt = _probe.wall(run, args.device)
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
        "transfer_bytes_per_row": row_bytes,
        "device": args.device, "precision": precision,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
