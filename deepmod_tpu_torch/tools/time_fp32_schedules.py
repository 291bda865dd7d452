"""Probe: K1's fp32 schedules on the fp32 core, timed turn by turn.

    python -m deepmod_tpu_torch.tools.time_fp32_schedules [--device cuda]
        [--batch N] [--label NAME]

K1 fp32 (``bilstm_center_features``), K5a fp32 (``merged_gemm``) and K5b
fp32 with fp32 and bf16 gates (``pregemm``, ``gate_store``) over the same
(B, 21, 7) windows at H=100, 3 layers (params from seed 2024): each
schedule's median of 5 CUDA-event timings after a warm-up call, K5b also
at tiles 32 and 40, and whether each output holds K1's bits. Prints one
line, ``<label> <package path> {...}``, in ms.

To compare a variant of the kernels with the checkout on one card, run
this tool turn by turn (A B B A) in each copy's directory, which puts
that copy's package first on the path (a copy builds its kernels under
its own ``build/``; start the builds first and together):

    cd <copy> && python -m deepmod_tpu_torch.tools.time_fp32_schedules --label A

``--device cpu`` times the plain versions with the host clock.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

BATCH = 262144
REPS = 5


def time_ms(fn, device) -> float:
    """Median of REPS timings of ``fn`` after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(REPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.time_fp32_schedules",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--label", default="run")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = BiLSTMConfig()
    params = init_bilstm_params(2024, cfg, device=device)
    packed = ops.pack_bilstm_params(params, cfg, "fp32")
    x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
        (args.batch, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(device)
    k1 = ops.bilstm_center_features(packed, x, cfg, "fp32")
    got = {}
    for name, flags in (("k5a", dict(merged_gemm=True)),
                        ("k5b", dict(pregemm=True)),
                        ("k5b_bf16_gates", dict(pregemm=True,
                                                gate_store="bf16"))):
        same = bool(torch.equal(
            ops.bilstm_center_mono(packed, x, cfg, "fp32", **flags), k1))
        got[name] = (round(time_ms(lambda: ops.bilstm_center_mono(
            packed, x, cfg, "fp32", **flags), device), 3), same)
    got["k1"] = round(time_ms(lambda: ops.bilstm_center_features(
        packed, x, cfg, "fp32"), device), 3)
    for tile in (32, 40):
        got[f"k5b_tile{tile}"] = round(time_ms(
            lambda: ops.bilstm_center_mono(packed, x, cfg, "fp32",
                                           pregemm=True, tile_b=tile),
            device), 3)
    print(args.label, ops.__file__.rsplit("/", 3)[0], got, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
