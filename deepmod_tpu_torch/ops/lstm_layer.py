"""One LSTM layer, one direction: the CUDA kernel and its plain version.

Counterpart of ``deepmod_tpu/ops/lstm_pallas.py::lstm_layer_pallas``
(Pallas ``_lstm_kernel``, K6). The input projection ``x @ W_x + b`` is a
plain ``torch.matmul`` before the recurrence, as the JAX package leaves it
to XLA outside its kernel; the recurrence over the projected gates is
``deepmod_tpu_torch/csrc/lstm_layer.cu`` on the card and
``lstm_recurrence_plain`` on the CPU. fp32 only, as in JAX: exp sigmoids,
``forget_bias`` inside the f sigmoid, TF gate order i, j, f, o.
"""

from __future__ import annotations

from typing import Dict

import torch

from ._build import MAX_SMEM, MAX_THREADS

# windows per block (a multiple of 8); a thread owns one hidden unit for 8
# of them, so hidden * TILE_B / 8 threads a block
TILE_B = 24

# kernel launches: each wrapper call that launches the CUDA kernel adds
# one; nothing else touches this
LAUNCHES: Dict[str, int] = {"fp32": 0}


def reset_launch_counts() -> None:
    LAUNCHES["fp32"] = 0


def project(kernel: torch.Tensor, bias: torch.Tensor,
            x_seq: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (B, T, 4H) fp32 gate pre-activations x @ W_x + b."""
    in_dim = x_seq.shape[-1]
    return torch.matmul(x_seq.to(torch.float32),
                        kernel[:in_dim].to(torch.float32)) + bias


def lstm_recurrence_plain(x_proj: torch.Tensor, w_h: torch.Tensor,
                          forget_bias: float, reverse: bool) -> torch.Tensor:
    """K6's function: (B, T, 4H) gate pre-activations and the (H, 4H)
    recurrent kernel -> (B, T, H) fp32. With ``reverse`` the steps run
    T-1..0 and each h is stored at its own index."""
    batch, timesteps, gates = x_proj.shape
    hidden = gates // 4
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    out = torch.empty(batch, timesteps, hidden, dtype=torch.float32,
                      device=x_proj.device)
    order = range(timesteps - 1, -1, -1) if reverse else range(timesteps)
    for t in order:
        g = x_proj[:, t] + h @ w_h
        i, j, f, o = g.split(hidden, dim=1)
        c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        h = torch.tanh(c) * torch.sigmoid(o)
        out[:, t] = h
    return out


def _recurrence_cuda(x_proj: torch.Tensor, w_h: torch.Tensor,
                     forget_bias: float, reverse: bool,
                     tile_b: int) -> torch.Tensor:
    from . import _build

    batch, timesteps, gates = x_proj.shape
    hidden = gates // 4
    x_proj = x_proj.contiguous()
    w_h = w_h.to(torch.float32).contiguous()
    if x_proj.dtype != torch.float32 or w_h.device != x_proj.device:
        raise ValueError("x_proj must be fp32 and lie on w_h's device")
    if tuple(w_h.shape) != (hidden, gates):
        raise ValueError(f"w_h must be ({hidden}, {gates}), got "
                         f"{tuple(w_h.shape)}")
    if tile_b <= 0 or tile_b % 8:
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    threads, smem = hidden * tile_b // 8, hidden * tile_b * 4
    if threads > MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(
            f"hidden={hidden} needs {threads} threads and {smem} B of shared "
            f"memory per block; the kernel takes at most {MAX_THREADS} and "
            f"{MAX_SMEM}")
    out = torch.empty(batch, timesteps, hidden, dtype=torch.float32,
                      device=x_proj.device)
    if batch == 0 or timesteps == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x_proj.device):
        status = lib.dmt_lstm_layer_f32(
            x_proj.data_ptr(), w_h.data_ptr(), forget_bias, out.data_ptr(),
            batch, timesteps, hidden, int(reverse), tile_b,
            torch.cuda.current_stream(x_proj.device).cuda_stream,
        )
    _build.check(status, "lstm layer kernel launch")
    LAUNCHES["fp32"] += 1
    return out


def lstm_recurrence(x_proj: torch.Tensor, w_h: torch.Tensor,
                    forget_bias: float = 1.0, reverse: bool = False,
                    tile_b: int = TILE_B) -> torch.Tensor:
    """K6: the recurrence over projected gates. A CPU tensor goes to the
    plain version; a CUDA tensor launches the kernel or raises."""
    if x_proj.device.type == "cpu":
        return lstm_recurrence_plain(x_proj, w_h.to(torch.float32),
                                     forget_bias, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    return _recurrence_cuda(x_proj, w_h, forget_bias, reverse, tile_b)


def lstm_layer(kernel: torch.Tensor, bias: torch.Tensor, x_seq: torch.Tensor,
               forget_bias: float = 1.0, reverse: bool = False,
               tile_b: int = TILE_B) -> torch.Tensor:
    """One LSTM layer over (B, T, F) -> (B, T, H) fp32 (JAX
    ``lstm_layer_pallas``): the projection in torch, the recurrence in
    K6 (its plain version on the CPU)."""
    in_dim = x_seq.shape[-1]
    return lstm_recurrence(project(kernel, bias, x_seq), kernel[in_dim:],
                           forget_bias, reverse, tile_b)
