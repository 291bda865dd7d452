"""Whole-stack BiLSTM center features: the CUDA kernel and its plain version.

Counterpart of ``deepmod_tpu/ops/bilstm_fused.py::bilstm_fused_center_mono``
(Pallas ``_mono_kernel``). The kernel itself is
``deepmod_tpu_torch/csrc/bilstm_fused.cu``; this module holds

- ``bilstm_center_plain``: the same function in plain PyTorch, step by
  step, with the same readout-cone truncation, time-reversed bw read and
  bf16 contract. The CPU path and the tests use it; the chip smoke test
  holds the kernel against it on the card;
- ``pack_bilstm_params``: the kernel's weight operand (TF ``(in+H, 4H)``
  kernels of every layer and lane in one flat buffer, i/f/o columns
  pre-halved in bf16 mode);
- ``bilstm_center_features``: the public wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises.

The bf16 contract (one copy, shared by the plain version and the packing):
bf16 x, weights and stored sequences, fp32 accumulation and fp32 cell
state; sigmoid(x) evaluated as 0.5*tanh(x/2)+0.5 with the inner /2 folded
into the i/f/o weight and bias columns (an exact exponent shift), and the
f gate adding 0.5*forget_bias in the original association; the center
row is returned rounded to bf16. fp32 mode uses exp-based sigmoids on
unscaled fp32 weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

PRECISIONS = ("fp32", "bf16")
_SEQ_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
# largest T the kernel takes: odd T only, T//2+1 <= 13 steps (the TPU
# package routes other T through its layered kernel, not ported yet)
MAX_TIMESTEPS = 25
# default windows per block (a multiple of 8). chip_smoke.py's sweep on
# an H100 at H=100 measured 24 fastest in fp32 and within 1% of the
# fastest in bf16 (two blocks of 300 threads fit an SM)
TILE_B = 24
MAX_THREADS = 512    # kMaxThreads in the CUDA source
MAX_SMEM = 232448    # bytes of shared memory a block may use on Hopper

# kernel launches per precision: each wrapper call that launches the
# CUDA kernel adds one; nothing else touches these
LAUNCHES: Dict[str, int] = {"fp32": 0, "bf16": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def seq_dtype(precision: str) -> torch.dtype:
    if precision not in _SEQ_DTYPE:
        raise ValueError(f"precision must be one of {PRECISIONS}: {precision!r}")
    return _SEQ_DTYPE[precision]


def _ifo_scale(hidden: int, device) -> torch.Tensor:
    """(4H,) column scale: 0.5 on the i, f, o gate blocks, 1 on j."""
    scale = torch.ones(4 * hidden, dtype=torch.float32, device=device)
    scale[: hidden] = 0.5
    scale[2 * hidden :] = 0.5
    return scale


def layer_weights(layer_params: Dict[str, torch.Tensor], precision: str):
    """One layer-lane's (kernel, bias) as the kernel consumes them.

    fp32: the fp32 TF kernel and bias. bf16: the kernel cast to bf16, then
    its i/f/o columns halved (exact in bf16), and the fp32 bias halved the
    same way (``_prescale_ifo`` of the TPU package)."""
    kernel = layer_params["kernel"]
    bias = layer_params["bias"].to(torch.float32)
    if precision == "fp32":
        return kernel.to(torch.float32), bias
    hidden = kernel.shape[1] // 4
    scale = _ifo_scale(hidden, kernel.device)
    w = kernel.to(torch.bfloat16) * scale.to(torch.bfloat16)
    return w, bias * scale


def _forget_term(forget_bias: float, precision: str) -> float:
    return 0.5 * forget_bias if precision == "bf16" else forget_bias


def bilstm_center_plain(
    params: Dict[str, Any], x: torch.Tensor, config, precision: str = "fp32"
) -> torch.Tensor:
    """(B, T, F) -> (B, 2H) fp32 center features in plain PyTorch.

    Odd T runs every layer of each lane over steps 0..T//2 only (the
    readout cone) and reads the last step; even T runs all T steps and
    reads fw at T//2 and bw at T-1-T//2, as the JAX scan path does."""
    dt = seq_dtype(precision)
    prescaled = precision == "bf16"
    timesteps = config.timesteps
    hidden = config.num_hidden
    fb = _forget_term(config.forget_bias, precision)
    x = x.to(dt)
    odd = timesteps % 2 == 1
    steps = timesteps // 2 + 1 if odd else timesteps
    center = timesteps // 2

    def sig(v):
        return 0.5 * torch.tanh(v) + 0.5 if prescaled else torch.sigmoid(v)

    feats = []
    for lane in ("fw", "bw"):
        seq = [
            x[:, t] if lane == "fw" else x[:, timesteps - 1 - t]
            for t in range(steps)
        ]
        for layer in range(config.num_layers):
            w, b = layer_weights(params[lane][layer], precision)
            in_dim = seq[0].shape[-1]
            w_x = w[:in_dim].to(torch.float32)
            w_h = w[in_dim:].to(torch.float32)
            h = torch.zeros(x.shape[0], hidden, dtype=torch.float32,
                            device=x.device)
            c = torch.zeros_like(h)
            out = []
            for t in range(steps):
                gates = (
                    seq[t].to(torch.float32) @ w_x
                    + h.to(dt).to(torch.float32) @ w_h
                    + b
                )
                i, j, f, o = gates.split(hidden, dim=1)
                c = c * sig(f + fb) + sig(i) * torch.tanh(j)
                h = torch.tanh(c) * sig(o)
                out.append(h.to(dt))
            seq = out
        if odd:
            feats.append(seq[-1])
        else:
            feats.append(seq[center] if lane == "fw"
                         else seq[timesteps - 1 - center])
    return torch.cat(feats, dim=1).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class PackedBiLSTM:
    """A BiLSTM's recurrent weights in the CUDA kernel's operand layout.

    ``w``: flat, [lane][layer] TF kernels ``(in+H, 4H)`` in the sequence
    dtype; ``bias``: ``(2, layers, 4H)`` fp32; ``params`` keeps the source
    dict for the plain version."""

    w: torch.Tensor
    bias: torch.Tensor
    precision: str
    params: Dict[str, Any]


def pack_bilstm_params(params: Dict[str, Any], config,
                       precision: str = "fp32") -> PackedBiLSTM:
    seq_dtype(precision)
    ws, bs = [], []
    for lane in ("fw", "bw"):
        for layer in range(config.num_layers):
            w, b = layer_weights(params[lane][layer], precision)
            ws.append(w.reshape(-1))
            bs.append(b)
    w = torch.cat(ws).contiguous()
    bias = torch.stack(bs).reshape(2, config.num_layers, -1).contiguous()
    return PackedBiLSTM(w=w, bias=bias, precision=precision, params=params)


def _launch_cuda(packed: PackedBiLSTM, x: torch.Tensor, config,
                 tile_b: int = TILE_B) -> torch.Tensor:
    from . import _build

    precision = packed.precision
    dt = seq_dtype(precision)
    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
    if timesteps % 2 == 0 or timesteps > MAX_TIMESTEPS:
        raise NotImplementedError(
            f"windowsize {timesteps}: the CUDA kernel takes odd T <= "
            f"{MAX_TIMESTEPS}; the layered kernel for other T (TPU kernel "
            "K4) is a ROADMAP item of the port"
        )
    if x.dim() != 3 or x.shape[1] != timesteps or x.shape[2] != in_dim:
        raise ValueError(
            f"x must be (B, {timesteps}, {in_dim}), got {tuple(x.shape)}"
        )
    if x.dtype != dt:
        x = x.to(dt)
    if any(s < 0 for s in x.stride()):
        raise ValueError("x must have non-negative strides")
    for name, t, want in (("w", packed.w, dt), ("bias", packed.bias,
                                                 torch.float32)):
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"packed {name} must be a contiguous {want} tensor on "
                f"{x.device}"
            )
    expected = 2 * ((in_dim + hidden) * 4 * hidden
                    + (layers - 1) * 2 * hidden * 4 * hidden)
    if packed.w.numel() != expected or packed.bias.numel() != 2 * layers * 4 * hidden:
        raise ValueError("packed weights do not match the model config")
    if tile_b <= 0 or tile_b % 8:
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    threads = hidden * tile_b // 8
    steps = timesteps // 2 + 1
    smem = steps * (hidden + in_dim) * tile_b * x.element_size()
    if threads > MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(
            f"hidden={hidden}, fnum={in_dim}, T={timesteps} need {threads} "
            f"threads and {smem} B of shared memory per block; the kernel "
            f"takes at most {MAX_THREADS} and {MAX_SMEM}"
        )
    batch = x.shape[0]
    out = torch.empty(batch, 2 * hidden, dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    fn = (lib.dmt_bilstm_center_bf16 if precision == "bf16"
          else lib.dmt_bilstm_center_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), batch,
            timesteps, in_dim, hidden, layers, packed.w.data_ptr(),
            packed.bias.data_ptr(),
            _forget_term(config.forget_bias, precision), out.data_ptr(),
            tile_b, stream,
        )
    _build.check(status, "bilstm_center kernel launch")
    LAUNCHES[precision] += 1
    return out


def bilstm_center_features(
    params: Union[Dict[str, Any], PackedBiLSTM],
    x: torch.Tensor,
    config,
    precision: str = "fp32",
    tile_b: int = TILE_B,
) -> torch.Tensor:
    """(B, T, F) windows -> (B, 2H) fp32 center [fw; bw] features.

    ``x`` may be any (B, T, F) view with non-negative strides — e.g. the
    overlapping window view of a (rows, F) feature block
    (``as_strided((rows-T+1, T, F), (F, F, 1))``), which the kernel reads
    in place. On the CPU this is the plain version; on a CUDA tensor it
    launches the kernel (odd T <= 25) or raises. ``params`` may be
    pre-packed (``pack_bilstm_params``) to skip the per-call packing.
    ``tile_b`` is the kernel's windows per block (a multiple of 8)."""
    if isinstance(params, PackedBiLSTM):
        if params.precision != precision:
            raise ValueError(
                f"params packed for {params.precision}, called with {precision}"
            )
        packed, raw = params, params.params
    else:
        packed, raw = None, params
    if x.device.type == "cpu":
        return bilstm_center_plain(raw, x, config, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if packed is None:
        packed = pack_bilstm_params(raw, config, precision)
    return _launch_cuda(packed, x, config, tile_b)
