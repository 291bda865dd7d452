"""Transcendental-rate probe (P1): v <- op(v), K times, in one kernel.

    python -m deepmod_tpu_torch.tools.probe_transcendental [--device cuda]

Counterpart of ``scripts/probe_transcendental.py`` (a Pallas kernel that
loops K times over a (512, 512) block). The CUDA kernel is
``deepmod_tpu_torch/csrc/probe_transcendental.cu``; this module holds its
plain version (``probe_plain``: the same K-step loop in torch), the
wrapper ``probe`` (a CPU tensor goes to the plain version, a CUDA tensor
launches the kernel or raises) and ``main``, which prints the rate of
each op (tanh, pade, mul) in fp32 and bf16 storage at K = 256 and 2048.

With the loop inside the kernel the launch overhead shrinks as K grows:
if the rate still grows from K=256 to 2048, the smaller K was bound by
overhead, and the large-K rate is the op's. mul (one fused multiply-add)
calibrates the other two in units of the simplest op. In bf16 storage
each step rounds v to bf16 and computes in fp32.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

OPS = ("tanh", "pade", "mul")
OP_CODES = {"tanh": 0, "pade": 1, "mul": 2}  # enum Op in the CUDA source
PRECISIONS = ("fp32", "bf16")
_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
SHAPE = (512, 512)
ITERS = (256, 2048)
MUL_A, MUL_B = 1.0009765625, 0.125

# kernel launches per storage precision: each wrapper call that launches
# the CUDA kernel adds one; nothing else touches these
LAUNCHES: Dict[str, int] = {"fp32": 0, "bf16": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _precision_of(dtype: torch.dtype) -> str:
    for name, dt in _DTYPE.items():
        if dt == dtype:
            return name
    raise ValueError(f"the probe takes float32 or bfloat16, got {dtype}")


def step_plain(v: torch.Tensor, op: str) -> torch.Tensor:
    """One step on fp32 values, rounded as the kernel rounds: tanh; the
    Pade approximant v(27+v^2)/(27+9v^2) as separate rounded ops; mul as
    one fused multiply-add (exact in float64, then one rounding)."""
    if op == "tanh":
        return torch.tanh(v)
    if op == "pade":
        v2 = v * v
        return v * (27.0 + v2) / (27.0 + 9.0 * v2)
    if op == "mul":
        return (v.double() * MUL_A + MUL_B).float()
    raise ValueError(f"op must be one of {OPS}: {op!r}")


def probe_plain(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """P1's function in torch: ``iters`` steps of ``op``, each rounded to
    x's dtype, computed in fp32."""
    dt = x.dtype
    v = x.to(torch.float32)
    for _ in range(iters):
        v = step_plain(v, op).to(dt).to(torch.float32)
    return v.to(dt)


def _probe_cuda(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    from deepmod_tpu_torch.ops import _build

    precision = _precision_of(x.dtype)
    if op not in OP_CODES:
        raise ValueError(f"op must be one of {OPS}: {op!r}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    fn = lib.dmt_probe_bf16 if precision == "bf16" else lib.dmt_probe_f32
    with torch.cuda.device(x.device):
        status = fn(OP_CODES[op], x.data_ptr(), out.data_ptr(), x.numel(),
                    iters, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "transcendental probe kernel launch")
    LAUNCHES[precision] += 1
    return out


def probe(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """v <- op(v) ``iters`` times over x (fp32 or bf16 storage)."""
    if x.device.type == "cpu":
        _precision_of(x.dtype)
        return probe_plain(x, op, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _probe_cuda(x, op, iters)


def probe_input(precision: str, device, seed: int = 0) -> torch.Tensor:
    """The probe's (512, 512) buffer: uniform in [0.1, 0.6), as the TPU
    probe draws it."""
    rng = np.random.default_rng(seed)
    x = rng.random(SHAPE, dtype=np.float64) * 0.5 + 0.1
    return torch.from_numpy(x.astype(np.float32)).to(_DTYPE[precision]).to(
        device)


def rate(op: str, precision: str, iters: int, device,
         reps: int = 20) -> Dict[str, float]:
    """Ops per second of ``reps`` chained probe calls (each call's output
    feeds the next) after one warm-up call. On the card the time comes
    from CUDA events; on the CPU from the host clock."""
    x = probe_input(precision, device)
    acc = probe(x, op, iters)
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        acc = probe(acc, op, iters)
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    if not torch.isfinite(acc.float()).all():
        raise RuntimeError(f"{op} {precision} K={iters}: non-finite values")
    n = x.numel() * iters * reps
    return {"ops_per_s": n / seconds, "ms_per_call": seconds / reps * 1e3}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_transcendental",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel) or cpu (the plain version)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--ops", default=",".join(OPS))
    parser.add_argument("--iters", default=",".join(map(str, ITERS)))
    args = parser.parse_args(argv)
    from deepmod_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain version)")
    print(f"device: {where}", flush=True)
    for op in args.ops.split(","):
        for precision in PRECISIONS:
            for iters in map(int, args.iters.split(",")):
                r = rate(op, precision, iters, device, args.reps)
                print(f"{op:5s} {precision} K={iters:5d}: "
                      f"{r['ops_per_s'] / 1e9:10.2f} Gop/s "
                      f"({r['ms_per_call']:.4f} ms a call)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
