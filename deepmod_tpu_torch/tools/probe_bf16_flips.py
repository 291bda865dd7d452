"""Argmax flips of K1 bf16 against the fp32 path.

    python -m deepmod_tpu_torch.tools.probe_bf16_flips [--windows 65536]
        [--dataset DIR] [--reads 40] [--device cuda]

Counterpart of ``scripts/probe_bf16_flips.py`` (docs/Validation.md's
method): on real feature windows from the port's host pipeline and on as
many random windows, count the windows whose argmax differs between K1
fp32 (the fp32 path, within 2e-5 of the JAX package's scan) and K1 bf16
(the tensor-core kernel, detect's default), with a seeded full-width
model. The real windows come from ``--dataset`` (a folder with
``ref.fa`` and ``fast5/`` or ``pod5/`` + ``calls.bam``), by default a
synthetic one of ``--reads`` reads written to a temporary directory. Each
set is cut to a multiple of 512 windows. Prints a JSON line a set: the
flips, the windows, the largest |logit difference|, and the smallest and
1st-percentile fp32 logit margin |l1 - l0|. On the CPU both are the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _host_bench, _probe


def dataset_windows(path: str, n_max: int, window: int = 21) -> np.ndarray:
    """Up to ``n_max`` (n, window, 7) feature windows of a dataset's reads,
    through the host pipeline (ingest, align, features) as detect cuts
    them."""
    from deepmod_tpu_torch.engine.detect import DetectConfig, _host_options
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.engine.outputs import build_batch_request

    pod5 = os.path.isdir(os.path.join(path, "pod5"))
    folder = os.path.join(path, "pod5" if pod5 else "fast5")
    init_worker(_host_options(DetectConfig(
        wrk_base=folder, ref=os.path.join(path, "ref.fa"),
        model_path="unused", out_folder="", align_str="builtin",
        window_size=window,
        basecalls=os.path.join(path, "calls.bam") if pod5 else "")))
    results, _ = host_process_files(
        sorted(glob.glob(os.path.join(folder, "*.pod5" if pod5
                                      else "*.fast5"))))
    feats, centers, _, _ = build_batch_request(results, window=window)
    half = window // 2
    view = np.lib.stride_tricks.sliding_window_view(feats, window, axis=0)
    return np.ascontiguousarray(
        np.moveaxis(view[centers[:n_max] - half], 2, 1), np.float32)


def flip_stats(params, config, windows: np.ndarray, device) -> dict:
    """K1 fp32 against K1 bf16 on ``windows`` (cut to a multiple of 512)."""
    import torch

    from deepmod_tpu_torch.models.bilstm import bilstm_logits
    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops.bilstm_fused import pack_bilstm_params

    n = (len(windows) // 512) * 512
    x = torch.from_numpy(np.ascontiguousarray(windows[:n])).to(device)
    tparams = params_from_numpy(params, device)
    with torch.no_grad():
        lf, lb = (bilstm_logits(pack_bilstm_params(tparams, config, prec),
                                x, config, prec).cpu().numpy()
                  for prec in ("fp32", "bf16"))
    margin = np.abs(lf[:, 1] - lf[:, 0])
    return {"flips": int(np.sum(lf.argmax(1) != lb.argmax(1))),
            "windows": n, "max_abs_dlogit": float(np.abs(lf - lb).max()),
            "min_margin": float(margin.min()),
            "p1_margin": float(np.percentile(margin, 1))}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_bf16_flips",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=65536)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--reads", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(_probe.header(args.device), flush=True)
    params, config = _probe.seeded_model(7)
    work = None
    ds = args.dataset
    if ds is None:
        work = ds = tempfile.mkdtemp(prefix="dmt_flips_")
        _host_bench.write_dataset(
            ds, _host_bench.default_format(), n_files=max(1, args.reads // 25),
            genome_sizes={"chrF": 200_000}, num_reads=args.reads,
            read_length=(5000, 10000), seed=5, mod_motif="CG",
            mod_level_shift=1.2)
    try:
        real = dataset_windows(ds, args.windows)
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    rand = np.random.default_rng(5).standard_normal(
        (args.windows, 21, 7)).astype(np.float32)
    for name, wins in (("real", real), ("random", rand)):
        print(json.dumps(dict(set=name, device=args.device,
                              **flip_stats(params, config, wins,
                                           args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
