"""What the mono-schedule probe tools share (``probe_mono``,
``probe_merged_gemm``, ``probe_pregemm``): their command line, the model
and windows they run, the output they chain, and the clock.

As in the JAX scripts (``scripts/probe_*.py``): H=100, 3 layers, T=21,
F=7, params from seed 0, windows standard normal from seed 1, 131,072 of
them by default, and each timed call ends in ``argmax(center @ out_w +
out_b)``, added into one int32 accumulator over ``ITERS`` chained calls.
The TPU tiles are replaced by the port's tile sweep: the fp32 kernels the
tools run (K1, K4, K5a, K5b) are the fp32 core's, at its tiles (2-CTA
clusters up to 40 windows at H=100, 4-CTA ones from 48: ``f32_shape``);
the bf16 tensor-core kernels (K1, K4 and K5a-c) take one tile, 64
windows, and run at it alone.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

BATCH = 131072
ITERS = 16
# the port's tile sweep in fp32 (windows a cluster of the fp32 core):
# below the default, the default (TILE_B) and a 4-CTA one
TILES = (24, 40, 80)


def tiles(kernel: str, precision: str):
    """The tiles ``kernel`` (a mono schedule or "layered") runs at in the
    sweep: TILES, or the one tile of a tensor-core kernel."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    return (ops.TC_TILE_B,) if ops.tensor_core(kernel, precision) else TILES


def parse_args(prog: str, doc: str, argv: Optional[Sequence[str]]):
    parser = argparse.ArgumentParser(prog=prog, description=doc)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--batch", type=int, default=BATCH)
    return parser.parse_args(argv)


def setup(device_name: str, batch: int):
    """(device, config, params, fp32 windows) on the resolved device, and
    prints the device line."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.utils.device import resolve_device

    device = resolve_device(device_name)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions)")
    print(f"device: {where}; batch {batch}", flush=True)
    cfg = BiLSTMConfig(num_input=7, num_hidden=100, timesteps=21)
    params = init_bilstm_params(0, cfg, device=device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(device)
    return device, cfg, params, x


def classify(center: torch.Tensor, params) -> torch.Tensor:
    """The scripts' output: int32 argmax of the logits."""
    logits = center @ params["out_w"] + params["out_b"]
    return torch.argmax(logits, dim=-1).to(torch.int32)


def windows_per_s(fn: Callable[[], torch.Tensor], batch: int,
                  device) -> float:
    """Windows a second over ``ITERS`` chained calls of ``fn`` (each call's
    int32 output added into one accumulator) after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    acc = torch.zeros(batch, dtype=torch.int32, device=device)
    acc += fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        acc += fn()
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return batch * ITERS / seconds
