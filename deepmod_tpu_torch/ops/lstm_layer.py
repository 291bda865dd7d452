"""One LSTM layer, one direction: the CUDA kernel and its plain version.

Counterpart of ``deepmod_tpu/ops/lstm_pallas.py::lstm_layer_pallas``
(Pallas ``_lstm_kernel``, K6). The input projection ``x @ W_x + b`` is a
plain ``torch.matmul`` before the recurrence, as the JAX package leaves it
to XLA outside its kernel; the recurrence over the projected gates is
``deepmod_tpu_torch/csrc/lstm_layer.cu`` on the card (the fp32 core's
pieces: W_h resident in shared memory, split by units over a thread-block
cluster, ``lstm_layer_shape``) and ``lstm_recurrence_plain`` on the CPU.
fp32 only, as in JAX: exp sigmoids, ``forget_bias`` inside the f sigmoid,
TF gate order i, j, f, o.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ._build import MAX_SMEM
from .bilstm_fused import (F32_MAX_THREADS, F32_SPLITS, F32Shape,
                           f32_pack_layer, f32_smem)

# default windows a cluster (a multiple of 8): the fastest of chip_smoke.py's
# split x tile sweep on an H100 at H=100, T=21, 262,144 windows (PERF.md
# §6: tile 40 in 2-CTA clusters); ``lstm_layer_shape`` steps it down where
# no split fits
TILE_B = 40
# widest hidden K6 takes: what the CUDA-core kernel it replaces took at its
# default tile (hidden * 24 / 8 <= 512 threads a block); 4-CTA clusters
# from H=103 on at TILE_B
MAX_HIDDEN = 170

# kernel launches: each wrapper call that launches the CUDA kernel adds
# one; nothing else touches this
LAUNCHES: Dict[str, int] = {"fp32": 0}


def reset_launch_counts() -> None:
    LAUNCHES["fp32"] = 0


def lstm_layer_smem(hidden: int, split: int, tile: int) -> int:
    """Shared-memory bytes of one K6 CTA (``lstm_f32.cuh::smem_bytes`` with
    W_h's rows and no x ring): H + 1 rows of its units' (i, j, f, o), the
    h ring (2 x [H][tile]) and a spare operand row."""
    return f32_smem(0, hidden, split, tile, w_rows=hidden)


def lstm_layer_shape(hidden: int, tile_b: Optional[int] = None,
                     split: Optional[int] = None) -> F32Shape:
    """K6's launch at this width: the tile ``tile_b``, by default the
    largest up to ``TILE_B`` at which some split fits, and ``split`` CTAs a
    cluster, by default the fewest of ``F32_SPLITS`` that hold W_h and the
    h ring at that tile. Raises ``ValueError`` for what no launch takes:
    hidden over ``MAX_HIDDEN``, a tile that is not a multiple of 8, more
    than ``F32_MAX_THREADS`` threads or ``MAX_SMEM`` bytes a CTA."""
    if hidden > MAX_HIDDEN:
        raise ValueError(f"K6 takes hidden <= {MAX_HIDDEN}, got {hidden}")
    if tile_b is not None and (tile_b <= 0 or tile_b % 8):
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    tiles = [tile_b] if tile_b is not None else range(TILE_B, 0, -8)
    for tile in tiles:
        for s in ([split] if split is not None else F32_SPLITS):
            threads = -(-hidden // s) * (tile // 8)
            smem = lstm_layer_smem(hidden, s, tile)
            if threads <= F32_MAX_THREADS and smem <= MAX_SMEM:
                return F32Shape(s, tile, threads, smem)
    raise ValueError(
        f"hidden={hidden}: no K6 launch of tile "
        f"{tile_b or 'up to ' + str(TILE_B)} fits {F32_MAX_THREADS} threads "
        f"and {MAX_SMEM} B of shared memory a CTA in a cluster of "
        f"{split or ' or '.join(map(str, F32_SPLITS))}")


def pack_wh(w_h: torch.Tensor) -> torch.Tensor:
    """The (H, 4H) recurrent kernel in K6's operand layout: W_h's rows of
    ``f32_pack_layer``'s gate-interleaved packing, (H, Hp4, 4) fp32 flat,
    zeros for the padded units."""
    hidden = w_h.shape[0]
    return f32_pack_layer(w_h.to(torch.float32), w_h.new_zeros(4 * hidden),
                          0, hidden)[0]


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


def recurrence_packed(x_proj: torch.Tensor, wh_packed: torch.Tensor,
                      forget_bias: float, reverse: bool,
                      shape: F32Shape) -> torch.Tensor:
    """K6's launch over a CUDA tensor with W_h already packed
    (``pack_wh``) at ``shape`` (``lstm_layer_shape``)."""
    from . import _build

    batch, timesteps, gates = x_proj.shape
    hidden = gates // 4
    x_proj = x_proj.contiguous()
    if (x_proj.dtype != torch.float32 or wh_packed.device != x_proj.device
            or wh_packed.numel() != hidden * -(-hidden // 4) * 16):
        raise ValueError("x_proj must be fp32 and wh_packed K6's packing of "
                         "an (H, 4H) kernel on its device")
    out = torch.empty(batch, timesteps, hidden, dtype=torch.float32,
                      device=x_proj.device)
    if batch == 0 or timesteps == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x_proj.device):
        status = lib.dmt_lstm_layer_f32(
            x_proj.data_ptr(), wh_packed.data_ptr(), forget_bias,
            out.data_ptr(), batch, timesteps, hidden, int(reverse),
            shape.tile, shape.split,
            torch.cuda.current_stream(x_proj.device).cuda_stream,
        )
    _build.check(status, "lstm layer kernel launch")
    LAUNCHES["fp32"] += 1
    return out


def lstm_layer_clusters(hidden: int, shape: F32Shape, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K6 at ``shape``: how many
    clusters of ``shape.split`` CTAs the card holds at once."""
    from . import _build

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_lstm_layer_f32_clusters(
            hidden, shape.tile, shape.split, ctypes.byref(n))
    _build.check(status, "lstm layer cluster occupancy")
    return n.value


def lstm_recurrence(x_proj: torch.Tensor, w_h: torch.Tensor,
                    forget_bias: float = 1.0, reverse: bool = False,
                    tile_b: Optional[int] = None) -> torch.Tensor:
    """K6: the recurrence over projected gates. A CPU tensor goes to the
    plain version; a CUDA tensor launches the kernel (W_h packed here, at
    ``lstm_layer_shape``) or raises."""
    if x_proj.device.type == "cpu":
        return lstm_recurrence_plain(x_proj, w_h.to(torch.float32),
                                     forget_bias, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    w_h = w_h.to(torch.float32)
    gates = x_proj.shape[-1]
    if tuple(w_h.shape) != (gates // 4, gates):
        raise ValueError(f"w_h must be ({gates // 4}, {gates}), got "
                         f"{tuple(w_h.shape)}")
    return recurrence_packed(x_proj, pack_wh(w_h), forget_bias, reverse,
                             lstm_layer_shape(gates // 4, tile_b))


def lstm_layer(kernel: torch.Tensor, bias: torch.Tensor, x_seq: torch.Tensor,
               forget_bias: float = 1.0, reverse: bool = False,
               tile_b: Optional[int] = None) -> torch.Tensor:
    """One LSTM layer over (B, T, F) -> (B, T, H) fp32 (JAX
    ``lstm_layer_pallas``): the projection in torch, the recurrence in
    K6 (its plain version on the CPU)."""
    in_dim = x_seq.shape[-1]
    return lstm_recurrence(project(kernel, bias, x_seq), kernel[in_dim:],
                           forget_bias, reverse, tile_b)
