"""The plain reference: DeepMod's BiLSTM classifier in plain torch.

The semantics of WGLab/DeepMod v0.1.3, ``myMultiBiRNN.py:21-91``: a stack
of ``num_layers`` TF1 ``BasicLSTMCell``s a direction (gates = [x; h] W + b
in (i, j, f, o) order, c' = c sigmoid(f + forget_bias) + sigmoid(i)
tanh(j), h' = tanh(c') sigmoid(o)), ``static_bidirectional_rnn`` over a
window (the bw stack reads it time-reversed), the [fw; bw] outputs at the
center step, a (2H, C) projection; training minimises the mean softmax
cross-entropy with Adam. The center output depends only on fw steps
0..T//2 and bw steps T-1..T//2, so only those are run.

It imports nothing of the program. Modes:

- ``fp64``: the reference; every product and every elementwise step in
  float64;
- ``tf32``: the control of an fp32 configuration; every product's
  operands rounded to TF32 (10 mantissa bits), fp32 accumulation and
  elementwise math;
- ``fp8``: the control of a bf16 configuration; every product's operands
  scaled per tensor into float8 e4m3 and back, fp32 accumulation and
  elementwise math (carries in fp32, as the bf16 program keeps them).

The backward of a product rounds its operands the same way.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

MODES = ("fp64", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest even at TF32's 10 mantissa bits."""
    x = t.to(torch.float32).contiguous()
    i = x.view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """fp32 through float8 e4m3fn with one scale for the tensor."""
    x = t.to(torch.float32)
    amax = x.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def rounding(mode: str) -> Tuple[torch.dtype, Callable]:
    """(compute dtype, operand rounding) of a mode."""
    if mode == "fp64":
        return torch.float64, lambda t: t.to(torch.float64)
    if mode == "tf32":
        return torch.float32, _round_tf32
    if mode == "fp8":
        return torch.float32, _round_fp8
    raise ValueError(f"mode {mode!r}: expected one of {MODES}")


class _Product(torch.autograd.Function):
    """a @ b with both operands rounded, in the forward and the backward."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        return rg @ rb.transpose(0, 1), ra.transpose(0, 1) @ rg, None


@contextlib.contextmanager
def _no_tf32():
    """Products in the precision asked for: TF32 off while the reference
    runs (``tf32`` rounds its operands itself)."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def _lane(x: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          forget_bias: float, rnd: Callable) -> torch.Tensor:
    """One direction's stack over (N, S, F) steps; the top layer's last h."""
    seq = x
    for kernel, bias in layers:
        n, steps = seq.shape[0], seq.shape[1]
        hidden = kernel.shape[1] // 4
        h = seq.new_zeros(n, hidden)
        c = seq.new_zeros(n, hidden)
        outs = []
        for t in range(steps):
            gates = _Product.apply(torch.cat([seq[:, t], h], dim=1), kernel,
                                   rnd) + bias
            i, j, f, o = gates.split(hidden, dim=1)
            c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
            h = torch.tanh(c) * torch.sigmoid(o)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
    return seq[:, -1]


def logits(weights: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
           mode: str = "fp64") -> torch.Tensor:
    """(N, T, F) windows -> (N, C) logits in ``mode``'s compute dtype."""
    dtype, rnd = rounding(mode)
    x = x.to(dtype)
    w = {k: v.to(dtype) for k, v in weights.items()}
    center = cfg["timesteps"] // 2

    def stack(lane):
        return [(w[f"{lane}.{layer}.kernel"], w[f"{lane}.{layer}.bias"])
                for layer in range(cfg["num_layers"])]

    fb = float(cfg["forget_bias"])
    fw = _lane(x[:, : center + 1], stack("fw"), fb, rnd)
    bw = _lane(x[:, center:].flip(1), stack("bw"), fb, rnd)
    out = _Product.apply(torch.cat([fw, bw], dim=1), w["out_w"], rnd) + w["out_b"]
    if cfg.get("output_layer") == "sigmoid":
        out = torch.sigmoid(out)
    return out


@torch.no_grad()
def window_logits(weights: Dict[str, torch.Tensor], rows: torch.Tensor,
                  centers: torch.Tensor, cfg: Dict, mode: str = "fp64",
                  block: int = 65536) -> torch.Tensor:
    """Logits of the windows centred on ``centers`` (absolute row indices)
    of a (rows, F) feature array, ``block`` windows at a time."""
    half = cfg["timesteps"] // 2
    span = torch.arange(-half, half + 1, device=rows.device)
    out = []
    with _no_tf32():
        for lo in range(0, len(centers), block):
            idx = centers[lo : lo + block, None] + span
            out.append(logits(weights, rows[idx], cfg, mode))
    return torch.cat(out) if out else rows.new_zeros(0, cfg["num_classes"])


def loss(weights: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor,
         mask: torch.Tensor, cfg: Dict, mode: str) -> torch.Tensor:
    """Masked mean softmax cross-entropy of a batch."""
    dtype, _ = rounding(mode)
    z = logits(weights, x, cfg, mode)
    per = -(y.to(dtype) * torch.log_softmax(z, dim=-1)).sum(dim=-1)
    m = mask.to(dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def train(weights: Dict[str, torch.Tensor],
          batches: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          cfg: Dict, learning_rate: float, mode: str = "fp64",
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Dict:
    """Adam steps over ``batches`` from ``weights`` (not modified), in the
    order of operations the configuration states (eps outside the
    bias-corrected root). Returns each step's loss, the first step's
    gradients and the weights after the last step, by name."""
    dtype, _ = rounding(mode)
    names = list(weights)
    params = {k: weights[k].detach().to(dtype).clone() for k in names}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    with _no_tf32():
        for count, (x, y, mask) in enumerate(batches, start=1):
            leaves = [params[k].requires_grad_(True) for k in names]
            value = loss(params, x, y, mask, cfg, mode)
            grads = torch.autograd.grad(value, leaves)
            losses.append(float(value.detach()))
            with torch.no_grad():
                g = dict(zip(names, grads))
                if first is None:
                    first = {k: v.detach().clone() for k, v in g.items()}
                bc1 = 1.0 - b1 ** count
                bc2 = 1.0 - b2 ** count
                for k in names:
                    mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                    nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
                    step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                    params[k] = (params[k].detach() - learning_rate * step)
    return {"losses": losses, "first_grads": first,
            "params": {k: v.detach() for k, v in params.items()}}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The L2 norm of each tensor, in float64."""
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in tensors.items()}


def median(values) -> float:
    return float(np.median(list(values)))
