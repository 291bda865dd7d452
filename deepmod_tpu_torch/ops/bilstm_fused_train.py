"""BiLSTM training kernels: the CUDA kernels, their plain versions and the
``torch.autograd.Function`` between them.

Counterpart of ``deepmod_tpu/ops/bilstm_fused_train.py``: K2 (Pallas
``_fwd_kernel`` via ``_run_fwd_layer``) and K3 (Pallas ``_bwd_kernel`` via
``_run_bwd_layer``) under the custom VJP of ``bilstm_fused_center_train``.
The kernels are ``deepmod_tpu_torch/csrc/bilstm_train.cu``; this module
holds

- ``train_fwd_plain``: K2's function in plain PyTorch, step by step: every
  layer of both lanes, returning the h and c sequences of every layer (the
  BPTT residuals);
- ``train_bwd_plain``: K3's function for one layer, both lanes: BPTT that
  recomputes the gates from the stored rows, the dx stream and the fp32
  weight-gradient sums;
- ``train_fwd`` / ``train_bwd``: the wrappers. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises;
- ``BiLSTMCenterTrain`` (``bilstm_center_train``): the autograd Function,
  the layer loop of the JAX ``_fwd`` / ``_bwd`` with its residual
  bookkeeping, the seeding at the center row and the layer-0 reverse.

The contract (the same in both precisions, and not K1's):

- sigmoid(v) = 0.5*tanh(0.5*v)+0.5, forget_bias added whole inside the f
  sigmoid; weights, products, h/c carries and weight gradients are fp32;
- ``precision="bf16"`` changes only what is stored: the layer inputs, the
  h and c sequences and the dh/dx streams are bf16. The next layer reads
  the stored (rounded) h, while the recurrence carries h in fp32, and the
  backward recomputes the gates from the stored rows;
- odd T runs every layer for T//2+1 steps and reads both lanes at the last
  one; even T runs all T steps and reads fw at T//2 and bw at T-1-T//2
  (steps of the time-reversed bw lane). The center features leave in the
  storage dtype; the backward seeds dh at the center row only.

Sequences are laid out (lane, step, window, feature), lane 0 = fw; the bw
lane's layer-0 input is the time-reversed window.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ._build import MAX_SMEM
from .bilstm_fused import (F32_MAX_HIDDEN, F32_MAX_THREADS, F32_SPLITS,
                           F32Shape, f32_smem, readout)

PRECISIONS = ("fp32", "bf16")
_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16}
# K2 runs the fp32 core of K1 and K4 fp32 (csrc/lstm_f32.cuh): a cluster
# of F32_SPLITS CTAs a tile-lane, the layer's weights resident in shared
# memory split by units, thread (u, g) one unit for 8 windows, at most
# F32_MAX_THREADS threads a CTA. FWD_TILE_B is its default tile,
# chip_smoke.py's sweep at the trainer's batch 2048 on an H100 (PERF.md
# §6); ``fwd_shape`` steps it down where it does not fit. K1's and K4's
# tile (``bilstm_fused.TILE_B``) is their own
FWD_TILE_B = 32
# K3's recurrence: BWD_TILE_B windows a block in cells of 8 units x 8
# windows, 4 threads a cell, so 2 * (H rounded up to 8) threads rounded up
# to whole warps (at most BWD_MAX_THREADS); shared memory holds the step's
# da, [4H][BWD_TILE_B] fp32, and Wh^T, [4H][H rounded up to 8] fp32, where
# both fit (H <= 104), else Wh^T is read from a global copy
BWD_TILE_B = 32
BWD_MAX_THREADS = 256
# K3's products: 128 x 128 output tiles (DW_TILE; the dx product: 128
# rows by 16 or 64 columns). The dW product sums up to DW_SPLITS ordered
# ranges of the steps*B rows (at least DW_SPLIT_ROWS rows each, a
# multiple of DW_CHUNK, the kernel's kBK) in separate blocks, aiming at
# DW_BLOCKS blocks in all (two a streaming multiprocessor of an H100),
# then adds the ranges in order: the card filled, and the same bits on
# every run
DW_TILE = (128, 128)
DW_SPLITS = 32
DW_SPLIT_ROWS = 256
DW_CHUNK = 8
DW_BLOCKS = 264

# kernel launches: each wrapper call that launches a CUDA kernel adds one
# to its key ("fwd_<precision>": K2, all layers; "bwd_<precision>": K3 for
# one layer, the recurrence and its weight-gradient product); nothing
# else touches these
LAUNCHES: Dict[str, int] = {
    f"{kind}_{p}": 0 for kind in ("fwd", "bwd") for p in PRECISIONS
}

LayerWeights = Tuple[torch.Tensor, torch.Tensor]  # (2, in+H, 4H), (2, 4H)


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def storage_dtype(precision: str) -> torch.dtype:
    if precision not in _STORAGE:
        raise ValueError(f"precision must be one of {PRECISIONS}: {precision!r}")
    return _STORAGE[precision]


def _precision_of(dtype: torch.dtype) -> str:
    for name, dt in _STORAGE.items():
        if dt == dtype:
            return name
    raise ValueError(f"sequences must be float32 or bfloat16, got {dtype}")


def sigmoid(v: torch.Tensor) -> torch.Tensor:
    """The tanh form the TPU training kernels use in both precisions."""
    return 0.5 * torch.tanh(0.5 * v) + 0.5


def layer_inputs(x: torch.Tensor, steps: int) -> torch.Tensor:
    """(B, T, F) windows -> (2, steps, B, F) layer-0 inputs: fw reads
    steps 0.., bw the time-reversed window."""
    return torch.stack([x[:, :steps], x.flip(1)[:, :steps]]).transpose(
        1, 2).contiguous()


def stack_lanes(params: Dict[str, Any]) -> List[LayerWeights]:
    """Per layer, the fw and bw kernels and biases stacked on a lane axis
    (fp32, contiguous)."""
    return [
        (torch.stack([fw["kernel"], bw["kernel"]]).to(torch.float32).contiguous(),
         torch.stack([fw["bias"], bw["bias"]]).to(torch.float32).contiguous())
        for fw, bw in zip(params["fw"], params["bw"])
    ]


# ------------------------------------------------------------ plain versions


def train_fwd_plain(xin: torch.Tensor, weights: Sequence[LayerWeights],
                    forget_bias: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function: (2, steps, B, F) layer-0 inputs in the storage dtype
    -> h and c sequences (layers, 2, steps, B, H) in that dtype."""
    dt = xin.dtype
    steps, batch = xin.shape[1], xin.shape[2]
    seq = xin
    hs, cs = [], []
    for w, b in weights:
        in_dim = seq.shape[-1]
        hidden = w.shape[-1] // 4
        w_x, w_h = w[:, :in_dim], w[:, in_dim:]
        h = torch.zeros(2, batch, hidden, dtype=torch.float32, device=xin.device)
        c = torch.zeros_like(h)
        h_out, c_out = [], []
        for t in range(steps):
            gates = (torch.bmm(seq[:, t].to(torch.float32), w_x)
                     + torch.bmm(h, w_h) + b[:, None])
            i, j, f, o = gates.split(hidden, dim=-1)
            c = c * sigmoid(f + forget_bias) + sigmoid(i) * torch.tanh(j)
            h = torch.tanh(c) * sigmoid(o)
            h_out.append(h.to(dt))
            c_out.append(c.to(dt))
        seq = torch.stack(h_out, dim=1)
        hs.append(seq)
        cs.append(torch.stack(c_out, dim=1))
    return torch.stack(hs), torch.stack(cs)


def train_bwd_plain(
    xin: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor, dh: torch.Tensor,
    w: torch.Tensor, b: torch.Tensor, forget_bias: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's function for one layer, both lanes.

    xin (2, steps, B, in), hs / cs / dh (2, steps, B, H) in the storage
    dtype; w (2, in+H, 4H), b (2, 4H) fp32. Returns dx (2, steps, B, in) in
    the storage dtype and the fp32 weight and bias gradients (2, in+H, 4H),
    (2, 4H), summed over windows and steps."""
    dt = hs.dtype
    steps, batch, hidden = hs.shape[1], hs.shape[2], hs.shape[3]
    in_dim = xin.shape[-1]
    f32 = torch.float32
    w_x, w_h = w[:, :in_dim], w[:, in_dim:]
    zeros = torch.zeros(2, batch, hidden, dtype=f32, device=hs.device)
    dh_carry, dc_carry = zeros, zeros
    dx = torch.zeros(2, steps, batch, in_dim, dtype=dt, device=hs.device)
    da_seq = torch.empty(2, steps, batch, 4 * hidden, dtype=f32,
                         device=hs.device)
    for t in range(steps - 1, -1, -1):
        x_t = xin[:, t].to(f32)
        c_t = cs[:, t].to(f32)
        h_prev = hs[:, t - 1].to(f32) if t > 0 else zeros
        c_prev = cs[:, t - 1].to(f32) if t > 0 else zeros
        gates = torch.bmm(x_t, w_x) + torch.bmm(h_prev, w_h) + b[:, None]
        gi, gj, gf, go = gates.split(hidden, dim=-1)
        i, j = sigmoid(gi), torch.tanh(gj)
        f, o = sigmoid(gf + forget_bias), sigmoid(go)
        dh_total = dh[:, t].to(f32) + dh_carry
        tanh_c = torch.tanh(c_t)
        d_o = dh_total * tanh_c
        dc = dc_carry + dh_total * o * (1.0 - tanh_c * tanh_c)
        dc_carry = dc * f
        da = torch.cat([
            dc * j * i * (1.0 - i),
            dc * i * (1.0 - j * j),
            dc * c_prev * f * (1.0 - f),
            d_o * o * (1.0 - o),
        ], dim=-1)
        dx[:, t] = torch.bmm(da, w_x.transpose(1, 2)).to(dt)
        dh_carry = torch.bmm(da, w_h.transpose(1, 2))
        da_seq[:, t] = da
    h_prev_seq = torch.cat([zeros[:, None], hs[:, :-1].to(f32)], dim=1)
    rows = torch.cat([xin.to(f32), h_prev_seq], dim=-1).reshape(
        2, steps * batch, in_dim + hidden)
    da_rows = da_seq.reshape(2, steps * batch, 4 * hidden)
    return dx, torch.bmm(rows.transpose(1, 2), da_rows), da_rows.sum(dim=1)


# ------------------------------------------------------------- the kernels


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def fwd_shape(in_dim: int, hidden: int, tile_b: Optional[int] = None,
              split: Optional[int] = None) -> F32Shape:
    """K2's launch at this width: the tile ``tile_b``, by default the
    largest up to ``FWD_TILE_B`` at which some split fits, and the fewest
    CTAs of ``F32_SPLITS`` (or ``split``) that hold a layer's weights and
    the operand rings at that tile (``f32_smem`` of the widest layer,
    ``hidden``). Raises ``ValueError`` for what the kernel does not take:
    fnum over hidden, hidden over ``F32_MAX_HIDDEN``, a tile that is not a
    multiple of 8, another split, more than ``F32_MAX_THREADS`` threads or
    ``MAX_SMEM`` bytes a CTA."""
    if in_dim > hidden:
        raise ValueError(f"the training kernels need fnum <= hidden, got "
                         f"{in_dim} > {hidden}")
    if hidden > F32_MAX_HIDDEN:
        raise ValueError(
            f"the training forward (K2) takes hidden <= {F32_MAX_HIDDEN} "
            f"(the JAX fused kernels' padded width), got {hidden}")
    if tile_b is not None and (tile_b <= 0 or tile_b % 8):
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    if split is not None and split not in F32_SPLITS:
        raise ValueError(f"split must be one of {F32_SPLITS}: {split}")
    tiles = [tile_b] if tile_b is not None else range(FWD_TILE_B, 0, -8)
    splits = [split] if split is not None else F32_SPLITS
    for tile in tiles:
        for s in splits:
            threads = -(-hidden // s) * (tile // 8)
            smem = f32_smem(hidden, hidden, s, tile)
            if threads <= F32_MAX_THREADS and smem <= MAX_SMEM:
                return F32Shape(s, tile, threads, smem)
    raise ValueError(
        f"hidden={hidden}: no launch of the training forward (K2) at tile "
        f"{tile_b or 'up to ' + str(FWD_TILE_B)} fits {F32_MAX_THREADS} "
        f"threads and {MAX_SMEM} B of shared memory a CTA in a cluster of "
        f"{split or ' or '.join(map(str, F32_SPLITS))}")


def fwd_clusters(in_dim: int, hidden: int, shape: F32Shape, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K2 at this shape: how many
    clusters of ``shape.split`` CTAs the card holds at once."""
    import ctypes

    from . import _build

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_bilstm_train_fwd_clusters(
            in_dim, hidden, shape.tile, shape.split, ctypes.byref(n))
    _build.check(status, "bilstm train forward (K2) cluster occupancy")
    return n.value


def bwd_block(hidden: int) -> Tuple[int, int, bool]:
    """(threads, shared-memory bytes, Wh^T in shared memory) of a block of
    K3's recurrence, as ``launch_bwd`` sizes it."""
    hp8 = -(-hidden // 8) * 8
    threads = -(-2 * hp8 // 32) * 32
    das = 4 * hidden * BWD_TILE_B * 4
    shared = das + 4 * hidden * hp8 * 4 <= MAX_SMEM
    return threads, das + (4 * hidden * hp8 * 4 if shared else 0), shared


def _check_bwd_block(hidden: int, in_dim: int) -> bool:
    """K3's limits; returns whether Wh^T is staged in shared memory."""
    if in_dim > hidden:
        raise ValueError(f"the training kernels need fnum <= hidden, got "
                         f"{in_dim} > {hidden}")
    threads, smem, shared = bwd_block(hidden)
    if threads > BWD_MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(
            f"hidden={hidden} needs {threads} threads and {smem} B of shared "
            f"memory per block of K3's recurrence; it takes at most "
            f"{BWD_MAX_THREADS} and {MAX_SMEM}")
    return shared


def dw_tiles(in_dim: int, hidden: int) -> Tuple[int, int]:
    """(row tiles, column tiles) of one lane's (in+H+1) x 4H dW product."""
    return (-(-(in_dim + hidden + 1) // DW_TILE[0]),
            -(-(4 * hidden) // DW_TILE[1]))


def dw_splits(rows: int, in_dim: int, hidden: int) -> int:
    """The ordered row ranges of K3's dW product at ``rows`` = steps * B:
    enough for 2 lanes x tiles x splits to reach DW_BLOCKS, at most
    DW_SPLITS, each range at least DW_SPLIT_ROWS rows."""
    tm, tn = dw_tiles(in_dim, hidden)
    want = -(-DW_BLOCKS // (2 * tm * tn))
    return max(1, min(DW_SPLITS, want, rows // DW_SPLIT_ROWS))


def _train_fwd_cuda(xin: torch.Tensor, weights: Sequence[LayerWeights],
                    forget_bias: float, tile_b: Optional[int] = None,
                    split: Optional[int] = None):
    from . import _build

    precision = _precision_of(xin.dtype)
    dt, dev = xin.dtype, xin.device
    _, steps, batch, in_dim = xin.shape
    layers = len(weights)
    hidden = weights[0][0].shape[-1] // 4
    _check("xin", xin, dev, dt, (2, steps, batch, in_dim))
    for layer, (w, b) in enumerate(weights):
        lin = in_dim if layer == 0 else hidden
        _check(f"w[{layer}]", w, dev, torch.float32, (2, lin + hidden, 4 * hidden))
        _check(f"b[{layer}]", b, dev, torch.float32, (2, 4 * hidden))
    shape = fwd_shape(in_dim, hidden, tile_b, split)
    # the kernel's operand: [lane][layer] TF kernels, flat; (2, layers, 4H)
    w_all = torch.cat([w[lane].reshape(-1) for lane in range(2)
                       for w, _ in weights])
    b_all = torch.stack([b for _, b in weights], dim=1).contiguous()
    hs = torch.empty(layers, 2, steps, batch, hidden, dtype=dt, device=dev)
    cs = torch.empty_like(hs)
    if batch == 0:
        return hs, cs
    # the inter-layer rows, blocked [H][tile] fp32 a (tile, lane, step),
    # overwritten in place by each next layer
    tiles = -(-batch // shape.tile)
    ws = torch.empty(tiles, 2, steps, hidden * shape.tile if layers > 1 else 1,
                     dtype=torch.float32, device=dev)
    lib = _build.library()
    fn = (lib.dmt_bilstm_train_fwd_bf16 if precision == "bf16"
          else lib.dmt_bilstm_train_fwd_f32)
    with torch.cuda.device(dev):
        status = fn(
            xin.data_ptr(), batch, steps, in_dim, hidden, layers,
            w_all.data_ptr(), b_all.data_ptr(), forget_bias, hs.data_ptr(),
            cs.data_ptr(), ws.data_ptr(), shape.tile, shape.split,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "bilstm train forward (K2) launch")
    LAUNCHES[f"fwd_{precision}"] += 1
    return hs, cs


def _train_bwd_cuda(xin, hs, cs, dh, w, b, forget_bias: float):
    from . import _build

    precision = _precision_of(hs.dtype)
    dt, dev = hs.dtype, hs.device
    _, steps, batch, hidden = hs.shape
    in_dim = xin.shape[-1]
    _check("xin", xin, dev, dt, (2, steps, batch, in_dim))
    for name, t in (("hs", hs), ("cs", cs), ("dh", dh)):
        _check(name, t, dev, dt, (2, steps, batch, hidden))
    _check("w", w, dev, torch.float32, (2, in_dim + hidden, 4 * hidden))
    _check("b", b, dev, torch.float32, (2, 4 * hidden))
    shared = _check_bwd_block(hidden, in_dim)
    dx = torch.empty(2, steps, batch, in_dim, dtype=dt, device=dev)
    # the kernels' scratch: the operand rows [x; h_{t-1}; 1] in fp32, the
    # gate pre-activations and da
    rows = torch.empty(2, steps * batch, -(-(in_dim + hidden + 1) // 4) * 4,
                       dtype=torch.float32, device=dev)
    gates = torch.empty(2, steps, batch, 4 * hidden, dtype=torch.float32,
                        device=dev)
    da = torch.empty_like(gates)
    dw = torch.empty(2, in_dim + hidden + 1, 4 * hidden, dtype=torch.float32,
                     device=dev)
    if batch == 0:
        dw.zero_()
        return dx, dw[:, :-1], dw[:, -1]
    # above H = 104 the recurrence reads Wh^T from this copy, units padded
    # to a multiple of 8
    wht = None
    if not shared:
        hp8 = -(-hidden // 8) * 8
        wht = torch.zeros(2, 4 * hidden, hp8, dtype=torch.float32, device=dev)
        wht[:, :, :hidden] = w[:, in_dim:].transpose(1, 2)
    splits = dw_splits(steps * batch, in_dim, hidden)
    partial = (torch.empty((splits,) + tuple(dw.shape), dtype=torch.float32,
                           device=dev) if splits > 1 else dw)
    lib = _build.library()
    fn = (lib.dmt_bilstm_train_bwd_bf16 if precision == "bf16"
          else lib.dmt_bilstm_train_bwd_f32)
    with torch.cuda.device(dev):
        status = fn(
            xin.data_ptr(), hs.data_ptr(), cs.data_ptr(), dh.data_ptr(),
            w.data_ptr(), None if wht is None else wht.data_ptr(),
            b.data_ptr(), forget_bias, dx.data_ptr(), rows.data_ptr(),
            gates.data_ptr(),
            da.data_ptr(), dw.data_ptr(), partial.data_ptr(), splits, batch,
            steps, in_dim, hidden,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "bilstm train backward (K3) launch")
    LAUNCHES[f"bwd_{precision}"] += 1
    return dx, dw[:, :-1], dw[:, -1]


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def train_fwd(xin: torch.Tensor, weights: Sequence[LayerWeights],
              forget_bias: float, tile_b: Optional[int] = None,
              split: Optional[int] = None):
    """K2: layer-0 inputs (2, steps, B, F) -> (hs, cs), each (layers, 2,
    steps, B, H) in xin's dtype (the storage dtype). ``tile_b`` and
    ``split`` choose the kernel's launch (``fwd_shape``; the default fits
    the width); the plain version on the CPU ignores them."""
    if _on(xin) == "cpu":
        return train_fwd_plain(xin, weights, forget_bias)
    return _train_fwd_cuda(xin, weights, forget_bias, tile_b, split)


def train_bwd(xin, hs, cs, dh, w, b, forget_bias: float):
    """K3 for one layer: -> (dx (2, steps, B, in) in the storage dtype,
    dW (2, in+H, 4H) fp32, db (2, 4H) fp32)."""
    if _on(hs) == "cpu":
        return train_bwd_plain(xin, hs, cs, dh, w, b, forget_bias)
    return _train_bwd_cuda(xin, hs, cs, dh, w, b, forget_bias)


# ---------------------------------------------------- the autograd Function


def _lstm_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [lp[key] for lane in ("fw", "bw") for lp in params[lane]
            for key in ("kernel", "bias")]


class BiLSTMCenterTrain(torch.autograd.Function):
    """(B, T, F) windows -> (B, 2H) center [fw; bw] features in the storage
    dtype, with K2 forward and K3 backward (their plain versions on the
    CPU). Inputs: x, config, precision, then the LSTM kernels and
    biases in ``_lstm_leaves`` order."""

    @staticmethod
    def forward(ctx, x, config, precision, *leaves):
        dt = storage_dtype(precision)
        layers = config.num_layers
        if x.dim() != 3 or x.shape[1:] != (config.timesteps, config.num_input):
            raise ValueError(f"x must be (B, {config.timesteps}, "
                             f"{config.num_input}), got {tuple(x.shape)}")
        if any(leaf.device != x.device for leaf in leaves):
            raise ValueError("parameters and x must lie on one device")
        fw = [{"kernel": leaves[2 * i], "bias": leaves[2 * i + 1]}
              for i in range(layers)]
        bw = [{"kernel": leaves[2 * (layers + i)],
               "bias": leaves[2 * (layers + i) + 1]} for i in range(layers)]
        weights = stack_lanes({"fw": fw, "bw": bw})
        steps, center, bw_center = readout(config.timesteps)
        xin = layer_inputs(x.to(dt), steps)
        hs, cs = train_fwd(xin, weights, config.forget_bias)
        ctx.save_for_backward(xin, hs, cs, *[t for wb in weights for t in wb])
        ctx.config, ctx.x_dtype = config, x.dtype
        top = hs[layers - 1]
        return torch.cat([top[0, center], top[1, bw_center]], dim=1)

    @staticmethod
    def backward(ctx, g):
        xin, hs, cs, *flat = ctx.saved_tensors
        config = ctx.config
        layers, hidden, timesteps = (config.num_layers, config.num_hidden,
                                     config.timesteps)
        weights = [(flat[2 * i], flat[2 * i + 1]) for i in range(layers)]
        dt = hs.dtype
        steps, center, bw_center = readout(timesteps)
        batch = xin.shape[2]
        dh = torch.zeros(2, steps, batch, hidden, dtype=dt, device=hs.device)
        dh[0, center] = g[:, :hidden].to(dt)
        dh[1, bw_center] = g[:, hidden:].to(dt)
        grads: Dict[str, List] = {"fw": [None] * layers, "bw": [None] * layers}
        dx_out = None
        for layer in range(layers - 1, -1, -1):
            w, b = weights[layer]
            layer_in = xin if layer == 0 else hs[layer - 1]
            dx, dw, db = train_bwd(layer_in, hs[layer], cs[layer], dh, w, b,
                                   config.forget_bias)
            grads["fw"][layer] = (dw[0], db[0])
            grads["bw"][layer] = (dw[1], db[1])
            if layer > 0:
                dh = dx
            else:
                # the bw lane read x time-reversed: reverse its dx back and
                # add, in the storage dtype as the JAX package does
                full = torch.zeros(2, timesteps, batch, xin.shape[-1],
                                   dtype=dt, device=hs.device)
                full[:, :steps] = dx
                dx_out = (full[0] + full[1].flip(0)).transpose(0, 1).to(
                    ctx.x_dtype)
        leaf_grads = [t for lane in ("fw", "bw") for pair in grads[lane]
                      for t in pair]
        return (dx_out, None, None, *leaf_grads)


def bilstm_center_train(params: Dict[str, Any], x: torch.Tensor, config,
                        precision: str = "fp32") -> torch.Tensor:
    """Differentiable (B, T, F) -> (B, 2H) center features in the storage
    dtype (bf16 in bf16 mode). Gradients flow to every ``fw``/``bw``
    kernel and bias of ``params`` and to ``x``."""
    storage_dtype(precision)
    return BiLSTMCenterTrain.apply(x, config, precision, *_lstm_leaves(params))
