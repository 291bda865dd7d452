"""BiLSTM center features: the CUDA kernels and their plain versions.

Counterpart of ``deepmod_tpu/ops/bilstm_fused.py::bilstm_fused_center``
and its two kernels:

- K1, ``bilstm_fused_center_mono`` (Pallas ``_mono_kernel``): the whole
  stack in one launch, odd T <= 25. CUDA: ``csrc/bilstm_fused.cu`` (bf16
  on the tensor cores, with its own two-dot schedule; fp32 on the fp32
  core, ``csrc/lstm_f32.cuh``); plain version ``bilstm_center_plain``;
- K4, ``_run_layer`` (Pallas ``_layer_kernel``): one layer, both lanes, a
  launch, for every other T or when the caller forces it, each lane
  stopping at its readout step (``cone``). CUDA: ``csrc/bilstm_layer.cu``
  (bf16 on the tensor cores, fp32 on the fp32 core); plain versions
  ``layer_plain`` (one layer) and ``bilstm_layered_plain`` (the layer
  loop, all T steps at even T, as in JAX);
- K5a-c, K1's function under the three other schedules of
  ``bilstm_fused_center_mono``, reached through ``bilstm_center_mono``'s
  flags as in JAX: ``merged_gemm`` (``_mono_merged_kernel``, CUDA
  ``csrc/bilstm_mono_merged.cu``), ``pregemm`` with ``gate_store``
  (``_mono_pregemm_kernel``, ``csrc/bilstm_mono_pregemm.cu``) and
  ``wavefront`` (``_mono_wavefront_kernel``,
  ``csrc/bilstm_mono_wavefront.cu``). Their plain version is K1's,
  ``bilstm_center_plain``, with ``gate_store`` for K5b.

In bf16, K1, K4 and K5a-c are tensor-core kernels (``csrc/lstm_tc.cuh``:
``wgmma`` chains on the tensor cores, 64 windows a tile; hidden 105-128
over thread-block clusters, see ``TC_MAX_HP``). In fp32, K1, K4 and K5a-c
run the fp32 core (``csrc/lstm_f32.cuh``: each layer's weights resident
in shared memory, split by units over a thread-block cluster, see
``f32_shape``; K5b on a persistent grid, ``f32_slots``; K5c a
persistent grid of clusters of a CTA group a layer,
``f32_slots``). This module also holds ``pack_bilstm_params``
(TF ``(in+H, 4H)`` kernels of every layer and lane in one flat buffer,
i/f/o columns pre-halved in bf16 mode, which the wrappers check against
the config; in bf16 also the padded, gate-permuted tensor-core layout,
``tc_pack_layer``; in fp32 also the gate-interleaved layout of the fp32
core, ``f32_pack_layer``) and the public wrapper
``bilstm_center_features``, which routes as the JAX package does. A CPU
tensor goes to the plain version of the chosen kernel; a CUDA tensor
launches the kernel or raises. The chip smoke test holds each kernel
against its plain version on the card.

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
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ._build import MAX_SMEM

PRECISIONS = ("fp32", "bf16")
_SEQ_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
# largest T the mono kernel (K1) takes: odd T only, T//2+1 <= 13 steps.
# Every other T goes to the layered kernel (K4), as in the TPU package
MAX_TIMESTEPS = 25
# default windows per tile of K1 and K4 in fp32 (the fp32 core, a
# multiple of 8): chip_smoke.py's sweep on an H100 at H=100 (PERF.md §6).
# ``f32_shape`` steps it down where it does not fit
TILE_B = 40
# the fp32 core (csrc/lstm_f32.cuh): a layer-lane's [Wx; Wh] weights stay
# in shared memory, split by units over a thread-block cluster of
# F32_SPLITS CTAs (the fewest that hold them beside the operand rings);
# thread (u, g) owns one unit for 8 windows; at most F32_MAX_THREADS
# threads a CTA; hidden up to F32_MAX_HIDDEN (the JAX fused kernels' LANE,
# as TC_MAX_HP)
F32_SPLITS = (1, 2, 4)
F32_MAX_THREADS = 256
F32_MAX_HIDDEN = 128
# the bf16 tensor-core kernels (K1, K4 and K5a-c, csrc/lstm_tc.cuh) take 64
# windows a tile (the wgmma M) and no other tile, with 256 threads (two
# warpgroups) a block; H is padded to Hp, a multiple of 8, at most
# TC_MAX_HP = 128, the JAX fused kernels' LANE. Up to TC_ONE_BLOCK_HP a
# layer's weights (16 Hp^2 bytes after layer 0) and the operand rings fit
# one block's 227 KB; beyond it K1, K4, K5a and K5c split each layer-lane
# by units over a 2-CTA thread-block cluster of 128 threads a CTA
# (``tc_split``). K5b keeps one weight resident at a time (8 Hp^2 bytes)
# and needs no cluster. K5c runs one CTA (or split pair) a layer, a
# cluster a tile-lane
TC_TILE_B = 64
TC_THREADS = 256
TC_MAX_HP = 128
TC_ONE_BLOCK_HP = 104
# the schedules of K1's function (JAX ``bilstm_fused_center_mono``'s
# flags): "mono" is K1, the other three K5a-c; in fp32 all four run the
# fp32 core
SCHEDULES = ("mono", "merged", "pregemm", "wavefront")
GATE_STORES = ("fp32", "bf16")
# default windows per block by kernel and precision: K1 and K4
# ("layered") in fp32 TILE_B, the fp32 core's (where it fits:
# ``f32_shape``); K5a-c in fp32 (the fp32 core too) each schedule's, the
# fastest in chip_smoke.py's sweep of the fp32 core's tiles on an H100 at
# H=100, 3 layers, T=21; TC_TILE_B, the only tile, for K1, K4 and K5a-c in
# bf16 (a K1 caller's TILE_B becomes TC_TILE_B there: ``_mono_tile``)
SCHEDULE_TILE_B = {
    "mono": {"fp32": TILE_B, "bf16": TC_TILE_B},
    "merged": {"fp32": TILE_B, "bf16": TC_TILE_B},
    "pregemm": {"fp32": TILE_B, "bf16": TC_TILE_B},
    "wavefront": {"fp32": TILE_B, "bf16": TC_TILE_B},
    "layered": {"fp32": TILE_B, "bf16": TC_TILE_B},
}

# kernel launches per precision: each wrapper call that launches K1 adds
# one to LAUNCHES, each K4 layer launch one to LAYERED_LAUNCHES, each K5
# launch one to MONO_SCHEDULE_LAUNCHES[schedule]; nothing else touches
# these
LAUNCHES: Dict[str, int] = {"fp32": 0, "bf16": 0}
LAYERED_LAUNCHES: Dict[str, int] = {"fp32": 0, "bf16": 0}
MONO_SCHEDULE_LAUNCHES: Dict[str, Dict[str, int]] = {
    schedule: {"fp32": 0, "bf16": 0} for schedule in SCHEDULES[1:]}


def tensor_core(kernel: str, precision: str) -> bool:
    """Whether ``kernel`` (a schedule of ``SCHEDULES`` or "layered", K4)
    runs on the tensor cores in ``precision``: all of them in bf16."""
    return precision == "bf16" and kernel in (*SCHEDULES, "layered")


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAYERED_LAUNCHES,
                   *MONO_SCHEDULE_LAUNCHES.values()):
        for key in counts:
            counts[key] = 0


def use_mono(timesteps: int, mono: Optional[bool] = None) -> bool:
    """The JAX package's route (``bilstm_fused_center``): K1 for odd T <=
    25 unless ``mono`` is False; K4 otherwise. ``mono=True`` outside K1's
    range raises."""
    if mono is None:
        return timesteps % 2 == 1 and timesteps <= MAX_TIMESTEPS
    if mono and (timesteps % 2 == 0 or timesteps > MAX_TIMESTEPS):
        raise ValueError(
            f"the mono kernel takes odd T <= {MAX_TIMESTEPS}, got "
            f"{timesteps}; pass mono=None or False for the layered kernel")
    return bool(mono)


def cone(timesteps: int) -> Tuple[int, int, int]:
    """(steps, fw readout step, bw readout step) of the readout cone at
    any T: every layer of the fw lane needs steps 0..T//2 only, and of the
    time-reversed bw lane 0..T-1-T//2 (one fewer at even T), since a lane's
    layer reads only the layer below in the same lane. K4 runs fw_step+1
    and bw_step+1 steps a layer and sizes its sequences for ``steps`` =
    T//2+1; at odd T this is ``readout``."""
    center = timesteps // 2
    return center + 1, center, timesteps - 1 - center


def readout(timesteps: int) -> Tuple[int, int, int]:
    """(steps run per layer, fw readout step, bw readout step): odd T runs
    the T//2+1 steps of the readout cone and reads both lanes at the last;
    even T runs all T steps and reads fw at T//2 and bw at T-1-T//2 of the
    time-reversed lane."""
    center = timesteps // 2
    if timesteps % 2 == 1:
        return center + 1, center, center
    return timesteps, center, timesteps - 1 - center


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


def _itemsize(precision: str) -> int:
    return torch.finfo(seq_dtype(precision)).bits // 8


def _forget_term(forget_bias: float, precision: str) -> float:
    return 0.5 * forget_bias if precision == "bf16" else forget_bias


def _run_lane(rows, w: torch.Tensor, b: torch.Tensor, forget_bias: float,
              precision: str, gate_store: str = "fp32"):
    """One layer of one lane over ``rows`` (a list of (B, in) steps in the
    storage dtype) under the kernels' contract; returns the list of h rows
    in the storage dtype. ``gate_store="bf16"`` rounds each step's input
    projection to bf16 before the h product and bias are added (K5b's bf16
    gate buffer, JAX ``_mono_pregemm_kernel``)."""
    dt = seq_dtype(precision)
    prescaled = precision == "bf16"
    fb = _forget_term(forget_bias, precision)
    in_dim = rows[0].shape[-1]
    hidden = w.shape[1] // 4
    w_x = w[:in_dim].to(torch.float32)
    w_h = w[in_dim:].to(torch.float32)

    def sig(v):
        return 0.5 * torch.tanh(v) + 0.5 if prescaled else torch.sigmoid(v)

    h = torch.zeros(rows[0].shape[0], hidden, dtype=torch.float32,
                    device=rows[0].device)
    c = torch.zeros_like(h)
    out = []
    for row in rows:
        gx = row.to(torch.float32) @ w_x
        if gate_store == "bf16":
            gx = gx.to(torch.bfloat16).to(torch.float32)
        gates = gx + h.to(dt).to(torch.float32) @ w_h + b
        i, j, f, o = gates.split(hidden, dim=1)
        c = c * sig(f + fb) + sig(i) * torch.tanh(j)
        h = torch.tanh(c) * sig(o)
        out.append(h.to(dt))
    return out


def bilstm_center_plain(
    params: Dict[str, Any], x: torch.Tensor, config, precision: str = "fp32",
    gate_store: str = "fp32",
) -> torch.Tensor:
    """K1's function: (B, T, F) -> (B, 2H) fp32 center features in plain
    PyTorch, each lane through its whole stack in turn. It is also the
    plain version of K5a-c; ``gate_store="bf16"`` is K5b's bf16 gate
    buffer (``_run_lane``).

    Odd T runs every layer of each lane over steps 0..T//2 only (the
    readout cone) and reads the last step; even T runs all T steps and
    reads fw at T//2 and bw at T-1-T//2, as the JAX scan path does."""
    x = x.to(seq_dtype(precision))
    timesteps = config.timesteps
    steps, fw_step, bw_step = readout(timesteps)
    feats = []
    for lane, step in (("fw", fw_step), ("bw", bw_step)):
        seq = [x[:, t] if lane == "fw" else x[:, timesteps - 1 - t]
               for t in range(steps)]
        for layer in range(config.num_layers):
            w, b = layer_weights(params[lane][layer], precision)
            seq = _run_lane(seq, w, b, config.forget_bias, precision,
                            gate_store)
        feats.append(seq[step])
    return torch.cat(feats, dim=1).to(torch.float32)


def layer_plain(
    in_fw: torch.Tensor, in_bw: torch.Tensor, weights, out_steps: int,
    forget_bias: float, reverse_bw_read: bool, final: bool,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function for one layer and both lanes, in plain PyTorch (JAX
    ``_run_layer`` / ``_layer_kernel``).

    ``in_fw``, ``in_bw``: time-major (T_in, B, in) in the storage dtype;
    ``weights``: (w_fw, b_fw, w_bw, b_bw) as ``layer_weights`` gives them.
    Each lane runs ``out_steps`` steps; the bw lane reads step T_in-1-t
    when ``reverse_bw_read``. Returns the (out_steps, B, H) sequences in
    the storage dtype, or with ``final`` only their last row, (1, B, H)."""
    w_fw, b_fw, w_bw, b_bw = weights
    in_steps = in_bw.shape[0]
    outs = []
    for seq, w, b, rev in ((in_fw, w_fw, b_fw, False),
                           (in_bw, w_bw, b_bw, reverse_bw_read)):
        rows = [seq[in_steps - 1 - t] if rev else seq[t]
                for t in range(out_steps)]
        h = _run_lane(rows, w, b, forget_bias, precision)
        outs.append(torch.stack(h[-1:] if final else h))
    return outs[0], outs[1]


def bilstm_layered_plain(
    params: Dict[str, Any], x: torch.Tensor, config, precision: str = "fp32"
) -> torch.Tensor:
    """(B, T, F) -> (B, 2H) fp32 center features through the layer loop
    of ``layer_plain`` (JAX ``bilstm_fused_center`` with ``mono=False``):
    the bw lane keeps its time-reversed layout through the stack; odd T
    runs T//2+1 steps a layer and the last layer keeps only its center
    row; even T runs all T steps and reads fw at T//2, bw at T-1-T//2."""
    timesteps = config.timesteps
    steps, fw_step, bw_step = readout(timesteps)
    odd = timesteps % 2 == 1
    xt = x.to(seq_dtype(precision)).transpose(0, 1)  # (T, B, F) view
    in_fw, in_bw = xt, xt
    for layer in range(config.num_layers):
        weights = (*layer_weights(params["fw"][layer], precision),
                   *layer_weights(params["bw"][layer], precision))
        final = odd and layer == config.num_layers - 1
        in_fw, in_bw = layer_plain(in_fw, in_bw, weights, steps,
                                   config.forget_bias, layer == 0, final,
                                   precision)
    if odd:
        fw_step = bw_step = 0  # the last layer kept only the center row
    return torch.cat([in_fw[fw_step], in_bw[bw_step]], dim=1).to(
        torch.float32)


def tc_dims(in_dim: int, hidden: int) -> Tuple[int, int, int]:
    """(Hp, x core columns, k-tiles) of one layer of the tensor-core
    kernels (``csrc/lstm_tc.cuh``): Hp is ``hidden`` rounded up to 8; the
    operand [h; x] is Hp/8 + ceil(in/8) core columns of 8, taken 16 deep a
    ``wgmma`` (a zero column pads an odd count)."""
    hp = -(-hidden // 8) * 8
    nx = -(-in_dim // 8)
    return hp, nx, (hp // 8 + nx + 1) // 2


def tc_gate_columns(hidden: int) -> torch.Tensor:
    """(4Hp,) int64: the TF column (gate * H + unit) that each column of
    the tensor-core weights holds, -1 for a padded unit. Warpgroup w owns
    columns w*2Hp .. w*2Hp+2Hp-1 and units w*Hp/2 on; in each pair of
    8-column chunks p, unit w*Hp/2 + 4p + q has its (i, j) at columns 2q,
    2q+1 of the first chunk and its (f, o) at 2q, 2q+1 of the second: the
    columns of one thread's wgmma accumulator fragment."""
    hp = tc_dims(1, hidden)[0]
    n = torch.arange(4 * hp)
    wg, r = n // (2 * hp), n % (2 * hp)
    chunk, within = r // 8, r % 8
    unit = wg * (hp // 2) + 4 * (chunk // 2) + within // 2
    gate = 2 * (chunk % 2) + within % 2
    return torch.where(unit < hidden, gate * hidden + unit,
                       torch.full_like(n, -1))


def tc_pack_layer(w: torch.Tensor, b: torch.Tensor, in_dim: int,
                  hidden: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer-lane's bf16 (w, b) as ``layer_weights`` gives them, in the
    tensor-core layout: the K rows reordered [Wh; Wx] and zero-padded (Hp
    h rows, 8*ceil(in/8) x rows, Kp = 16 * k-tiles in all), the columns
    permuted by ``tc_gate_columns`` (zero for padded units), stored K-major
    in core columns, [Kp/8][4Hp][8] flat; the bias as (Hp, 4) fp32, (i, j,
    f, o) a unit, zero for padded units."""
    hp, _, nk = tc_dims(in_dim, hidden)
    kp = 16 * nk
    rows = torch.zeros(kp, 4 * hidden, dtype=w.dtype, device=w.device)
    rows[:hidden] = w[in_dim:]
    rows[hp:hp + in_dim] = w[:in_dim]
    cols = tc_gate_columns(hidden).to(w.device)
    valid = cols >= 0
    wp = torch.zeros(kp, 4 * hp, dtype=w.dtype, device=w.device)
    wp[:, valid] = rows[:, cols[valid]]
    core = wp.reshape(kp // 8, 8, 4 * hp).transpose(1, 2).contiguous()
    bias = torch.zeros(hp, 4, dtype=torch.float32, device=b.device)
    bias[:hidden] = b.reshape(4, hidden).t()
    return core.reshape(-1), bias


def tc_split(hidden: int) -> int:
    """CTAs that share one layer-lane's gate columns in K4, K5a and K5c
    (``lstm_tc.cuh::split_of``): 1 up to Hp = ``TC_ONE_BLOCK_HP``, else a
    2-CTA cluster, CTA r holding ``tc_gate_columns``' warpgroup r."""
    return 1 if tc_dims(1, hidden)[0] <= TC_ONE_BLOCK_HP else 2


def tc_smem(config, schedule: str = "merged") -> int:
    """Shared-memory bytes of one CTA of a tensor-core kernel
    (``lstm_tc.cuh::smem_bytes``): the h and x rings, the zero column, the
    resident weights and the bias. K1, K4, K5a and K5c hold the widest
    layer's [Wh; Wx] (their CTA's half in a split), K1 with a second zero
    column after the x ring; K5b one of Wx and Wh at a time, the wider in
    core columns rounded up to even."""
    widest = max(config.num_input, config.num_hidden)
    hp, nx, nk = tc_dims(widest, config.num_hidden)
    col = TC_TILE_B * 8 * 2
    if schedule == "pregemm":
        cols = max(hp // 8, nx)
        w_bytes = (cols + cols % 2) * 4 * hp * 16
    else:
        w_bytes = 16 * nk * 4 * hp * 2 // tc_split(config.num_hidden)
    zeros = 2 if schedule == "mono" else 1
    return (2 * (hp // 8) * col + 2 * nx * col + zeros * col + w_bytes
            + 16 * hp)


def tc_threads(schedule: str, hidden: int) -> int:
    """Threads a CTA of a tensor-core kernel: 256 (two warpgroups), 128 in
    a split CTA of K1, K4, K5a or K5c; K5b always 256."""
    return TC_THREADS // (1 if schedule == "pregemm" else tc_split(hidden))


def f32_units(hidden: int) -> int:
    """Units of the fp32 core's packed weights: ``hidden`` rounded up to a
    multiple of 4 (the widest split), zero-padded
    (``lstm_f32.cuh::packed_units``)."""
    return -(-hidden // 4) * 4


def f32_pack_layer(w: torch.Tensor, b: torch.Tensor, in_dim: int,
                   hidden: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer-lane's fp32 (w, b) as ``layer_weights`` gives them, in the
    fp32 core's gate-interleaved layout: row k of [Wx; Wh] (TF's row order)
    holds each unit's (i, j, f, o) adjacently, ``(in+H, Hp4, 4)`` flat with
    zeros for the padded units (``f32_units``), so a CTA of a split loads
    its units' 16-byte vectors of each row; the bias as ``(Hp4, 4)``."""
    hp4 = f32_units(hidden)
    rows = in_dim + hidden
    wp = torch.zeros(rows, hp4, 4, dtype=w.dtype, device=w.device)
    wp[:, :hidden] = w.reshape(rows, 4, hidden).transpose(1, 2)
    bias = torch.zeros(hp4, 4, dtype=torch.float32, device=b.device)
    bias[:hidden] = b.reshape(4, hidden).t()
    return wp.reshape(-1), bias


def f32_smem(in_max: int, hidden: int, split: int, tile: int,
             w_rows: Optional[int] = None) -> int:
    """Shared-memory bytes of one CTA of the fp32 core
    (``lstm_f32.cuh::smem_bytes``): ``w_rows`` rows of its units' weights
    (by default the widest layer's [Wx; Wh], ``in_max + hidden``; K5b holds
    one of the two at a time, ``in_max``) plus a spare row, the h ring (2 x
    [H][tile]), the x ring (2 x [in_max][tile]) and a spare operand row.
    K5a's operand ring takes the two rings' bytes."""
    units = -(-hidden // split)
    rows = in_max + hidden if w_rows is None else w_rows
    return ((rows + 1) * units * 16
            + (2 * hidden + 2 * in_max + 1) * tile * 4)


@dataclasses.dataclass(frozen=True)
class F32Shape:
    """A launch of the fp32 core: ``split`` CTAs a cluster, ``tile``
    windows a cluster, ``threads`` and ``smem`` bytes a CTA."""

    split: int
    tile: int
    threads: int
    smem: int


def f32_shape(in_dim: int, hidden: int,
              tile_b: Optional[int] = None) -> F32Shape:
    """The fp32 core's launch at this width (K1 and K4 size their CTAs by
    the widest layer, ``max(in_dim, hidden)``): the tile ``tile_b``, by
    default the largest up to ``TILE_B`` at which some split fits, and the
    fewest CTAs of ``F32_SPLITS`` that hold the weights and operands at
    that tile.
    Raises ``ValueError`` for what no launch takes: hidden over
    ``F32_MAX_HIDDEN``, a tile that is not a multiple of 8, more than
    ``F32_MAX_THREADS`` threads or ``MAX_SMEM`` bytes a CTA."""
    if hidden > F32_MAX_HIDDEN:
        raise ValueError(
            f"the fp32-core kernels (K1, K4, K5a-c) take hidden <= "
            f"{F32_MAX_HIDDEN} "
            f"(the JAX fused kernels' padded width), got {hidden}")
    if tile_b is not None and (tile_b <= 0 or tile_b % 8):
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    in_max = max(in_dim, hidden)
    tiles = [tile_b] if tile_b is not None else range(TILE_B, 0, -8)
    for tile in tiles:
        for s in F32_SPLITS:
            threads = -(-hidden // s) * (tile // 8)
            smem = f32_smem(in_max, hidden, s, tile)
            if threads <= F32_MAX_THREADS and smem <= MAX_SMEM:
                return F32Shape(s, tile, threads, smem)
    raise ValueError(
        f"hidden={hidden}, fnum={in_dim}: no fp32 launch of tile "
        f"{tile_b or 'up to ' + str(TILE_B)} fits {F32_MAX_THREADS} "
        f"threads and {MAX_SMEM} B of shared memory a CTA in a cluster of "
        f"{' or '.join(map(str, F32_SPLITS))}")


def f32_schedule_shape(in_dim: int, hidden: int, schedule: str,
                       tile_b: Optional[int] = None) -> F32Shape:
    """The launch of a schedule of ``SCHEDULES`` on the fp32 core:
    ``f32_shape``'s split, tile and threads for all four (K5a's operand
    ring takes K1's bytes, K5c's CTA of a layer K1's CTA's), with K5b's
    own shared memory: one of Wx and Wh resident at a time, so fewer bytes
    at the same split."""
    shape = f32_shape(in_dim, hidden, tile_b)
    if schedule == "pregemm":
        in_max = max(in_dim, hidden)
        shape = dataclasses.replace(shape, smem=f32_smem(
            in_max, hidden, shape.split, shape.tile, w_rows=in_max))
    return shape


def f32_clusters(config, shape: F32Shape, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the fp32 core (K4's kernel) at
    this config and shape: how many clusters of ``shape.split`` CTAs the
    card holds at once."""
    import ctypes

    from . import _build

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_bilstm_layer_f32_clusters(
            max(config.num_input, config.num_hidden), config.num_hidden,
            shape.tile, shape.split, ctypes.byref(n))
    _build.check(status, "bilstm fp32 cluster occupancy")
    return n.value


def _check_f32(packed: "PackedBiLSTM", config) -> None:
    """The fp32 core's packing matches the config."""
    layers, hp4 = config.num_layers, f32_units(config.num_hidden)
    want = 2 * sum((config.num_input if layer == 0 else config.num_hidden)
                   + config.num_hidden for layer in range(layers)) * hp4 * 4
    if (packed.f32_w is None or packed.f32_w.numel() != want
            or packed.f32_bias.shape != (layers, 2, hp4, 4)):
        raise ValueError("packed fp32-core weights do not match the model "
                         "config")


@dataclasses.dataclass(frozen=True)
class PackedBiLSTM:
    """A BiLSTM's recurrent weights in the CUDA kernels' operand layouts.

    ``w``: flat, [lane][layer] TF kernels ``(in+H, 4H)`` in the sequence
    dtype; ``bias``: ``(2, layers, 4H)`` fp32; in bf16 also ``tc_w``:
    flat, [layer][lane] ``tc_pack_layer`` weights, and ``tc_bias``:
    ``(layers, 2, Hp, 4)`` fp32 (K1, K4 and K5a-c); in fp32 also ``f32_w``:
    flat, [layer][lane] ``f32_pack_layer`` weights, and ``f32_bias``:
    ``(layers, 2, Hp4, 4)`` fp32 (K1, K4 and K5a-c); ``params`` keeps
    the source dict for the plain version."""

    w: torch.Tensor
    bias: torch.Tensor
    precision: str
    params: Dict[str, Any]
    tc_w: Optional[torch.Tensor] = None
    tc_bias: Optional[torch.Tensor] = None
    f32_w: Optional[torch.Tensor] = None
    f32_bias: Optional[torch.Tensor] = None


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
    tc_w = tc_bias = None
    if precision == "bf16":
        tws, tbs = [], []
        for layer in range(config.num_layers):
            lin = config.num_input if layer == 0 else config.num_hidden
            for lane in ("fw", "bw"):
                tw, tb = tc_pack_layer(
                    *layer_weights(params[lane][layer], precision), lin,
                    config.num_hidden)
                tws.append(tw)
                tbs.append(tb)
        tc_w = torch.cat(tws).contiguous()
        tc_bias = torch.stack(tbs).reshape(
            config.num_layers, 2, *tbs[0].shape).contiguous()
    f32_w = f32_bias = None
    if precision == "fp32":
        fws, fbs = [], []
        for layer in range(config.num_layers):
            lin = config.num_input if layer == 0 else config.num_hidden
            for lane in ("fw", "bw"):
                fw_, fb_ = f32_pack_layer(
                    *layer_weights(params[lane][layer], precision), lin,
                    config.num_hidden)
                fws.append(fw_)
                fbs.append(fb_)
        f32_w = torch.cat(fws).contiguous()
        f32_bias = torch.stack(fbs).reshape(
            config.num_layers, 2, *fbs[0].shape).contiguous()
    return PackedBiLSTM(w=w, bias=bias, precision=precision, params=params,
                        tc_w=tc_w, tc_bias=tc_bias, f32_w=f32_w,
                        f32_bias=f32_bias)


def _check_inputs(packed: PackedBiLSTM, x: torch.Tensor, config,
                  tile_b: int, smem: int, threads: int,
                  max_threads: int) -> torch.Tensor:
    """Check what the kernels take (``threads`` a block, at most
    ``max_threads``); returns x in the storage dtype."""
    dt = seq_dtype(packed.precision)
    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
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
    if (packed.w.numel() != 2 * _lane_weights(config)
            or packed.bias.numel() != 2 * layers * 4 * hidden):
        raise ValueError("packed weights do not match the model config")
    if tile_b <= 0 or tile_b % 8:
        raise ValueError(f"tile_b must be a positive multiple of 8: {tile_b}")
    if threads > max_threads or smem > MAX_SMEM:
        raise ValueError(
            f"hidden={hidden}, fnum={in_dim}, T={timesteps} need {threads} "
            f"threads and {smem} B of shared memory per block; the kernel "
            f"takes at most {max_threads} and {MAX_SMEM}"
        )
    return x


def _check_tc(packed: PackedBiLSTM, config, tile_b: int) -> None:
    """What the bf16 tensor-core kernels (K1, K4, K5a-c) take beyond
    ``_check_inputs``: 64 windows a tile and Hp <= TC_MAX_HP."""
    if tile_b != TC_TILE_B:
        raise ValueError(
            f"the bf16 tensor-core kernels (K1, K4, K5a-c) take tile_b="
            f"{TC_TILE_B} only (the wgmma M), got {tile_b}")
    hp = tc_dims(1, config.num_hidden)[0]
    if hp > TC_MAX_HP:
        raise ValueError(
            f"the bf16 tensor-core kernels (K1, K4, K5a-c) take hidden <= "
            f"{TC_MAX_HP} (the JAX fused kernels' padded width), got "
            f"{config.num_hidden}")
    layers = config.num_layers
    want = 2 * sum(16 * tc_dims(config.num_input if layer == 0 else
                                config.num_hidden, config.num_hidden)[2]
                   * 4 * hp for layer in range(layers))
    if (packed.tc_w is None or packed.tc_w.numel() != want
            or packed.tc_bias.shape != (layers, 2, hp, 4)):
        raise ValueError("packed tensor-core weights do not match the "
                         "model config")


def _lane_weights(config) -> int:
    """Elements of one lane's kernels, all layers, in the packed buffer."""
    h = config.num_hidden
    return ((config.num_input + h) * 4 * h
            + (config.num_layers - 1) * 2 * h * 4 * h)


def mono_block(config, schedule: str, tile_b: int,
               precision: str) -> Tuple[int, int, int]:
    """(threads, most threads the kernel takes, shared-memory bytes) of one
    CTA of a mono schedule, as its CUDA launcher sizes it. In bf16, all
    four are tensor-core kernels (one CTA's ``tc_threads`` and ``tc_smem``,
    64 windows, any other ``tile_b`` refused). In fp32, all four are one
    CTA of the fp32 core at ``f32_schedule_shape`` (raising ``ValueError``
    where no launch takes ``tile_b``)."""
    if tensor_core(schedule, precision):
        threads = tc_threads(schedule, config.num_hidden)
        return threads, threads, tc_smem(config, schedule)
    shape = f32_schedule_shape(config.num_input, config.num_hidden, schedule,
                               tile_b)
    return shape.threads, F32_MAX_THREADS, shape.smem


def _launch_mono(packed: PackedBiLSTM, x: torch.Tensor, config,
                 tile_b: int, schedule: str = "mono",
                 gate_store: str = "fp32") -> torch.Tensor:
    """K1 (``schedule="mono"``) or one of K5a-c: the whole stack in one
    launch (odd T <= 25). In fp32 all four run the fp32 core
    (``_launch_mono_f32``). In bf16 (the tensor-core kernels) K5b gets a
    device-memory gate workspace of ``gate_store`` dtype a resident slot
    (a persistent grid), with a bf16 workspace for the inter-layer rows
    beside it; K1 and K5a a bf16 workspace for the inter-layer rows,
    (ceil(B/64), 2, steps, 64 * Hp), each layer overwriting the one before
    in place; K5c (clusters of a CTA a layer) none."""
    from . import _build

    precision = packed.precision
    if precision == "fp32":
        return _launch_mono_f32(packed, x, config, tile_b, schedule,
                                gate_store)
    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
    steps = timesteps // 2 + 1
    _check_tc(packed, config, tile_b)
    threads, max_threads, smem = mono_block(config, schedule, tile_b,
                                            precision)
    x = _check_inputs(packed, x, config, tile_b, smem, threads, max_threads)
    batch = x.shape[0]
    out = torch.empty(batch, 2 * hidden, dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    kernel = "center" if schedule == "mono" else schedule
    fn = getattr(lib, f"dmt_bilstm_{kernel}_bf16")
    args = [x.data_ptr(), *x.stride(), batch, timesteps, in_dim, hidden,
            layers, packed.tc_w.data_ptr(), packed.tc_bias.data_ptr(),
            _forget_term(config.forget_bias, precision)]
    blocks = -(-batch // tile_b)
    hp = tc_dims(1, hidden)[0]
    if schedule == "pregemm":
        slots = pregemm_slots(batch, in_dim, hidden, gate_store, x.device)
        gx = torch.empty(slots * steps * TC_THREADS * hp,
                         dtype=_SEQ_DTYPE[gate_store], device=x.device)
        rows = torch.empty(slots * steps * TC_TILE_B * hp,
                           dtype=torch.bfloat16, device=x.device)
        args += [gx.data_ptr(), int(gate_store == "bf16"), rows.data_ptr(),
                 slots, out.data_ptr()]
    elif schedule in ("mono", "merged"):
        ws = torch.empty(blocks * 2 * steps * tile_b * hp,
                         dtype=torch.bfloat16, device=x.device)
        args += [ws.data_ptr(), out.data_ptr()]
    else:  # K5c: clusters, no workspace, no tile argument
        args += [out.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(*args, stream)
    _build.check(status, f"bilstm {schedule} kernel launch")
    if schedule == "mono":
        LAUNCHES[precision] += 1
    else:
        MONO_SCHEDULE_LAUNCHES[schedule][precision] += 1
    return out


def _launch_mono_f32(packed: PackedBiLSTM, x: torch.Tensor, config,
                     tile_b: Optional[int], schedule: str = "mono",
                     gate_store: str = "fp32",
                     slots: Optional[int] = None) -> torch.Tensor:
    """K1 or K5a-c in fp32 on the fp32 core, every layer of a lane in one
    launch. K1 and K5a (the merged operand ring) run a cluster of
    ``f32_shape``'s split a tile-lane with an fp32 workspace for the
    inter-layer rows, (ceil(B/tile), 2, T//2+1, H * tile), each layer
    overwriting the one before in place. K5b runs a persistent grid of
    ``f32_slots`` clusters with ``pregemm_f32_workspace``'s
    workspaces, a function of the card, not of the batch. K5c runs a
    persistent grid of ``slots`` clusters of num_layers x split CTAs (by
    default ``f32_slots``; one an item, ``2 * ceil(B/tile)``, is
    the cluster-a-tile form), no workspace."""
    from . import _build

    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
    _check_f32(packed, config)
    shape = f32_schedule_shape(in_dim, hidden, schedule, tile_b)
    x = _check_inputs(packed, x, config, shape.tile, shape.smem,
                      shape.threads, F32_MAX_THREADS)
    batch = x.shape[0]
    out = torch.empty(batch, 2 * hidden, dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    args = [x.data_ptr(), *x.stride(), batch, timesteps, in_dim, hidden,
            layers, packed.f32_w.data_ptr(), packed.f32_bias.data_ptr(),
            config.forget_bias]
    tail = [out.data_ptr(), shape.tile, shape.split]
    if schedule == "pregemm":
        slots = f32_slots(batch, shape.tile, pregemm_f32_clusters(
            config, shape, gate_store, x.device))
        n_gates, n_rows = pregemm_f32_workspace(config, shape, slots)
        gx = torch.empty(n_gates, dtype=_SEQ_DTYPE[gate_store],
                         device=x.device)
        rows = torch.empty(n_rows, dtype=torch.float32, device=x.device)
        fn = lib.dmt_bilstm_pregemm_f32
        args += [gx.data_ptr(), int(gate_store == "bf16"), rows.data_ptr(),
                 slots]
    elif schedule == "wavefront":
        if slots is None:
            slots = f32_slots(batch, shape.tile, wavefront_f32_clusters(
                config, shape, x.device))
        fn = lib.dmt_bilstm_wavefront_f32
        tail.append(slots)
    else:
        tiles = -(-batch // shape.tile)
        ws = torch.empty(tiles * 2 * (timesteps // 2 + 1) * hidden
                         * shape.tile, dtype=torch.float32, device=x.device)
        fn = (lib.dmt_bilstm_center_f32 if schedule == "mono" else
              lib.dmt_bilstm_merged_f32)
        args += [ws.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(*args, *tail, stream)
    _build.check(status, f"bilstm {schedule} kernel launch")
    if schedule == "mono":
        LAUNCHES["fp32"] += 1
    else:
        MONO_SCHEDULE_LAUNCHES[schedule]["fp32"] += 1
    return out


def wavefront_f32_clusters(config, shape: F32Shape, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of fp32 K5c at this config and
    shape: the clusters of num_layers x ``shape.split`` CTAs the card holds
    at once."""
    import ctypes

    from . import _build

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_bilstm_wavefront_f32_clusters(
            config.num_input, config.num_hidden, config.num_layers,
            shape.tile, shape.split, ctypes.byref(n))
    _build.check(status, "bilstm fp32 wavefront cluster occupancy")
    if n.value < 1:
        raise RuntimeError(
            f"no cluster of {config.num_layers * shape.split} CTAs of fp32 "
            f"K5c at {shape} fits the card")
    return n.value


def f32_slots(batch: int, tile: int, resident: int) -> int:
    """The persistent grid of fp32 K5b and K5c: ``resident`` clusters (what
    the card holds at once, ``pregemm_f32_clusters`` or
    ``wavefront_f32_clusters``), at most the 2 x ceil(B/tile) (tile, lane)
    work items. K5c's cluster runs a contiguous run of the lane-major
    items, so it loads each weight once, or twice where its run crosses
    from the fw lane to the bw lane."""
    return min(resident, 2 * -(-batch // tile))


def pregemm_f32_workspace(config, shape: F32Shape,
                          slots: int) -> Tuple[int, int]:
    """(gate values, row values) of fp32 K5b's workspaces over ``slots``
    clusters at ``shape``: a gate region a CTA, [T//2+1][U][i,j,f,o][tile]
    of its own U = ceil(H/split) units (in the gate store's dtype), and a
    slot's blocked rows between layers, T//2+1 x [H][tile] fp32. Both
    depend on the card (the slots), not on the batch."""
    steps = config.timesteps // 2 + 1
    units = -(-config.num_hidden // shape.split)
    return (slots * shape.split * steps * units * 4 * shape.tile,
            slots * steps * config.num_hidden * shape.tile)


def pregemm_f32_bytes(config, shape: F32Shape, slots: int,
                      gate_store: str) -> int:
    """Bytes of ``pregemm_f32_workspace`` with ``gate_store`` gates."""
    gates, rows = pregemm_f32_workspace(config, shape, slots)
    return gates * _itemsize(gate_store) + rows * 4


def pregemm_f32_clusters(config, shape: F32Shape, gate_store: str,
                         device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of fp32 K5b at this config, shape
    and gate store: the clusters of ``shape.split`` CTAs the card holds at
    once."""
    import ctypes

    from . import _build

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_bilstm_pregemm_f32_clusters(
            config.num_input, config.num_hidden, shape.tile, shape.split,
            int(gate_store == "bf16"), ctypes.byref(n))
    _build.check(status, "bilstm fp32 pregemm cluster occupancy")
    if n.value < 1:
        raise RuntimeError(
            f"no cluster of {shape.split} CTAs of fp32 K5b at {shape} fits "
            "the card")
    return n.value


def pregemm_slots(batch: int, in_dim: int, hidden: int, gate_store: str,
                  device) -> int:
    """The persistent grid of bf16 K5b at this shape and gate store: the
    card's SMs times the kernel's blocks an SM, at most the (tile, lane)
    items; each slot gets its own gate and row workspace."""
    import ctypes

    from . import _build

    slots = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().dmt_bilstm_pregemm_bf16_slots(
            batch, in_dim, hidden, int(gate_store == "bf16"),
            ctypes.byref(slots))
    _build.check(status, "bilstm pregemm slots")
    return slots.value


def tc_clusters(schedule: str, config, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of bf16 K5a (a cluster of
    ``tc_split`` CTAs) or K5c (``tc_split`` x num_layers CTAs) at this
    config: how many such clusters the card holds at once."""
    import ctypes

    from . import _build

    lib = _build.library()
    n = ctypes.c_int(0)
    dims = (config.num_input, config.num_hidden)
    with torch.cuda.device(device):
        if schedule == "wavefront":
            status = lib.dmt_bilstm_wavefront_bf16_clusters(
                *dims, config.num_layers, ctypes.byref(n))
        else:
            status = lib.dmt_bilstm_merged_bf16_clusters(*dims,
                                                         ctypes.byref(n))
    _build.check(status, f"bilstm {schedule} cluster occupancy")
    return n.value


def _launch_layered(packed: PackedBiLSTM, x: torch.Tensor, config,
                    tile_b: Optional[int] = None) -> torch.Tensor:
    """K4: one launch a layer, both lanes, each lane stopping at its
    readout step (``cone``). Layer 0 reads the windows through their
    strides; each later layer reads the blocked sequences of the one
    before, (2, T//2+1, ceil(B/tile), H * tile) fp32, each tile's row
    [H][tile] (the bw lane kept time-reversed); the last writes the (B,
    2H) features. fp32 runs the fp32 core at ``f32_shape``'s launch; bf16
    goes to the tensor-core kernel (``_launch_layered_tc``)."""
    from . import _build

    if tensor_core("layered", packed.precision):
        return _launch_layered_tc(packed, x, config,
                                  TC_TILE_B if tile_b is None else tile_b)
    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
    _check_f32(packed, config)
    shape = f32_shape(in_dim, hidden, tile_b)
    x = _check_inputs(packed, x, config, shape.tile, shape.smem,
                      shape.threads, F32_MAX_THREADS)
    steps, fw_step, bw_step = cone(timesteps)
    batch = x.shape[0]
    out = torch.empty(batch, 2 * hidden, dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hp4 = f32_units(hidden)
    tiles = -(-batch // shape.tile)
    src, in_steps, w_off = None, timesteps, 0
    with torch.cuda.device(x.device):
        for layer in range(layers):
            lin = in_dim if layer == 0 else hidden
            final = layer == layers - 1
            seq = None if final else torch.empty(
                2, steps, tiles, hidden * shape.tile, dtype=torch.float32,
                device=x.device)
            status = lib.dmt_bilstm_layer_f32(
                x.data_ptr(), *x.stride(), int(src is None),
                None if src is None else src.data_ptr(), batch, in_steps,
                steps, lin, hidden, packed.f32_w.data_ptr() + 4 * w_off,
                packed.f32_bias[layer].data_ptr(), config.forget_bias,
                None if final else seq.data_ptr(),
                out.data_ptr() if final else None, fw_step, bw_step,
                shape.tile, shape.split, stream)
            _build.check(status, f"bilstm layer kernel launch (layer {layer})")
            LAYERED_LAUNCHES["fp32"] += 1
            w_off += 2 * (lin + hidden) * hp4 * 4
            src, in_steps = seq, steps
    return out


def _launch_layered_tc(packed: PackedBiLSTM, x: torch.Tensor, config,
                       tile_b: int) -> torch.Tensor:
    """K4 in bf16 on the tensor cores: one launch a layer, both lanes, 64
    windows a block, each lane stopping at its readout step (``cone``).
    Between layers the sequence is blocked, (2, T//2+1, ceil(B/64), 64 *
    Hp) bf16, each tile's row in the kernel's operand layout (the bw lane
    kept time-reversed, as in fp32)."""
    from . import _build

    timesteps, hidden = config.timesteps, config.num_hidden
    in_dim, layers = config.num_input, config.num_layers
    _check_tc(packed, config, tile_b)
    threads = tc_threads("layered", hidden)
    x = _check_inputs(packed, x, config, tile_b, tc_smem(config), threads,
                      threads)
    steps, fw_step, bw_step = cone(timesteps)
    batch = x.shape[0]
    out = torch.empty(batch, 2 * hidden, dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hp = tc_dims(1, hidden)[0]
    tiles = -(-batch // TC_TILE_B)
    src, in_steps, w_off = None, timesteps, 0
    with torch.cuda.device(x.device):
        for layer in range(layers):
            lin = in_dim if layer == 0 else hidden
            final = layer == layers - 1
            seq = None if final else torch.empty(
                2, steps, tiles, TC_TILE_B * hp, dtype=torch.bfloat16,
                device=x.device)
            status = lib.dmt_bilstm_layer_bf16(
                x.data_ptr() if src is None else None, *x.stride(),
                int(src is None), None if src is None else src.data_ptr(),
                batch, in_steps, steps, lin, hidden,
                packed.tc_w.data_ptr() + 2 * w_off,
                packed.tc_bias[layer].data_ptr(),
                _forget_term(config.forget_bias, "bf16"),
                None if final else seq.data_ptr(),
                out.data_ptr() if final else None, fw_step, bw_step, stream)
            _build.check(status, f"bilstm layer kernel launch (layer {layer})")
            LAYERED_LAUNCHES["bf16"] += 1
            w_off += 2 * 16 * tc_dims(lin, hidden)[2] * 4 * hp
            src, in_steps = seq, steps
    return out


def _split_params(params: Union[Dict[str, Any], PackedBiLSTM],
                  precision: str):
    """(packed or None, the raw params dict)."""
    if isinstance(params, PackedBiLSTM):
        if params.precision != precision:
            raise ValueError(
                f"params packed for {params.precision}, called with {precision}"
            )
        return params, params.params
    return None, params


def bilstm_center_features(
    params: Union[Dict[str, Any], PackedBiLSTM],
    x: torch.Tensor,
    config,
    precision: str = "fp32",
    tile_b: Optional[int] = None,
    mono: Optional[bool] = None,
) -> torch.Tensor:
    """(B, T, F) windows -> (B, 2H) fp32 center [fw; bw] features.

    ``x`` may be any (B, T, F) view with non-negative strides — e.g. the
    overlapping window view of a (rows, F) feature block
    (``as_strided((rows-T+1, T, F), (F, F, 1))``), which the kernels read
    in place. ``mono`` routes as in the JAX package (``use_mono``): None
    takes K1 for odd T <= 25 and K4 otherwise, False forces K4. On the
    CPU this is the chosen kernel's plain version; on a CUDA tensor it
    launches the kernel or raises. ``params`` may be pre-packed
    (``pack_bilstm_params``) to skip the per-call packing. ``tile_b`` is
    the kernel's windows per block (a multiple of 8; K1 and K4 in bf16
    take 64 only, K1 reading ``TILE_B`` as 64), by default
    ``SCHEDULE_TILE_B`` of the kernel and precision. Hidden >
    ``TC_MAX_HP`` (128) raises in bf16."""
    mono = use_mono(config.timesteps, mono)
    packed, raw = _split_params(params, precision)
    if x.device.type == "cpu":
        plain = bilstm_center_plain if mono else bilstm_layered_plain
        return plain(raw, x, config, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if packed is None:
        packed = pack_bilstm_params(raw, config, precision)
    if not mono:
        return _launch_layered(packed, x, config, tile_b)
    return _launch_mono(packed, x, config, _mono_tile(tile_b, precision))


def _mono_tile(tile_b: Optional[int], precision: str) -> Optional[int]:
    """K1's tile: in fp32 ``tile_b`` as given (None: ``f32_shape``'s);
    in bf16 64, which the fp32 default ``TILE_B`` also reads as."""
    if precision == "bf16" and (tile_b is None or tile_b == TILE_B):
        return TC_TILE_B
    return tile_b


def mono_schedule(config, wavefront: bool = False, merged_gemm: bool = False,
                  pregemm: bool = False, gate_store: str = "fp32") -> str:
    """The schedule JAX ``bilstm_fused_center_mono`` picks from its flags,
    with its checks: odd T (and the port's T <= 25), ``wavefront`` needs
    ``num_layers <= 3`` and refuses ``merged_gemm``; then ``wavefront``,
    ``merged_gemm``, ``pregemm`` in that order, else K1 ("mono")."""
    timesteps = config.timesteps
    if timesteps % 2 == 0 or timesteps > MAX_TIMESTEPS:
        raise ValueError(
            f"the mono kernel requires odd T <= {MAX_TIMESTEPS}, got "
            f"{timesteps}")
    if gate_store not in GATE_STORES:
        raise ValueError(
            f"gate_store must be one of {GATE_STORES}: {gate_store!r}")
    if wavefront:
        if config.num_layers > 3:
            raise ValueError(
                "the wavefront schedule needs num_layers <= 3, got "
                f"{config.num_layers}")
        if merged_gemm:
            raise ValueError(
                "merged_gemm probes the sequential schedule; it cannot be "
                "combined with wavefront")
        return "wavefront"
    if merged_gemm:
        return "merged"
    return "pregemm" if pregemm else "mono"


def bilstm_center_mono(
    params: Union[Dict[str, Any], PackedBiLSTM],
    x: torch.Tensor,
    config,
    precision: str = "fp32",
    tile_b: Optional[int] = None,
    wavefront: bool = False,
    merged_gemm: bool = False,
    pregemm: bool = False,
    gate_store: str = "fp32",
) -> torch.Tensor:
    """(B, T, F) windows -> (B, 2H) fp32 center features, the whole stack
    in one launch: JAX ``bilstm_fused_center_mono`` with its flags.

    With no flag this is K1 (as ``bilstm_center_features`` routes odd T);
    ``merged_gemm`` runs K5a (one product of [x_t; h] with [Wx; Wh] a
    step), ``pregemm`` K5b (each layer's input projections first, into a
    gate buffer of ``gate_store`` dtype, "fp32" or "bf16", in either
    precision), ``wavefront`` K5c (layer L at step s - L, num_layers <= 3);
    the precedence and checks are JAX's (``mono_schedule``). All four
    schedules take odd T <= 25 (``MAX_TIMESTEPS``; shared memory bounds
    the port's kernels, not JAX's 63), the same ``PackedBiLSTM`` and the
    same x views as ``bilstm_center_features``. On the CPU this is the
    plain version (``bilstm_center_plain``, with ``gate_store`` for K5b);
    on a CUDA tensor it launches the chosen kernel or raises. ``tile_b``
    defaults to ``SCHEDULE_TILE_B`` of the schedule and precision (K5a-c
    in bf16, the tensor-core kernels, take 64 only; K5a-c in fp32 take
    the fp32 core's tiles, ``f32_shape``). Hidden over 128 raises in both
    precisions."""
    schedule = mono_schedule(config, wavefront, merged_gemm, pregemm,
                             gate_store)
    gates = gate_store if schedule == "pregemm" else "fp32"
    packed, raw = _split_params(params, precision)
    if x.device.type == "cpu":
        return bilstm_center_plain(raw, x, config, precision, gates)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if packed is None:
        packed = pack_bilstm_params(raw, config, precision)
    if schedule == "mono":
        tile_b = _mono_tile(tile_b, precision)
    elif tile_b is None:
        tile_b = SCHEDULE_TILE_B[schedule][precision]
    return _launch_mono(packed, x, config, tile_b, schedule, gates)
