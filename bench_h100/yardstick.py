"""The yardstick: the published peaks of one NVIDIA H100 and the operations
and bytes that a cell's work needs, counted from the shapes.

The peaks and the readout cone's count are copied from ``chip_smoke.py``
(``PEAK_OPS``, ``PEAK_BYTES``, ``flops_per_window``) so that a change to
the program cannot move them. Every count is of the work the inputs need:
the cone (the steps the center readout depends on), the windows asked
for, every byte once. What a kernel happens to compute beyond that (pad
windows, padded columns, a recomputed gate product) is not counted, so a
change that stops such work reads higher, not lower.

Operations are the multiply-adds (x2) of the matrix products; the cell's
elementwise work (sigmoids, tanh, the carry) is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 on the tensor cores, fp32 on
# the CUDA cores (the fp32 contract rules out TF32), HBM3 bandwidth. The
# rates assume the full 700 W power limit; the result line carries the
# card's limit beside every share of them.
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12

# bytes of one feature value as the device stage ships it
ITEMSIZE = {"fp32": 4, "bf16": 2}


def cone_steps(timesteps: int) -> Tuple[int, int]:
    """(fw, bw) steps a layer needs for the center readout: fw reads
    steps 0..T//2, the time-reversed bw lane T-1..T//2."""
    center = timesteps // 2
    return center + 1, timesteps - center


def _layer_in(cfg: Dict, layer: int) -> int:
    return cfg["num_input"] if layer == 0 else cfg["num_hidden"]


def cone_flops(cfg: Dict) -> int:
    """FLOP of one window's recurrence over the cone, both lanes, every
    layer: a step is [x; h] (in + H) times the (in + H, 4H) kernel."""
    h = cfg["num_hidden"]
    per_step = sum(2 * (_layer_in(cfg, layer) + h) * 4 * h
                   for layer in range(cfg["num_layers"]))
    return sum(cone_steps(cfg["timesteps"])) * per_step


def projection_flops(cfg: Dict) -> int:
    """FLOP of one window's (2H, C) readout projection."""
    return 2 * 2 * cfg["num_hidden"] * cfg["num_classes"]


def detect_flops(cfg: Dict) -> int:
    """FLOP one classified window needs: the cone and the projection."""
    return cone_flops(cfg) + projection_flops(cfg)


def backward_flops(cfg: Dict) -> int:
    """FLOP of one window's backward through the cone: a step's dX
    product (dgates (4H) times the kernel's transpose, into [dx; dh]), its
    dW product ([x; h] times dgates) and the bias gradient's 4H adds."""
    h = cfg["num_hidden"]
    per_step = sum(2 * 4 * h * (_layer_in(cfg, layer) + h)
                   + 2 * (_layer_in(cfg, layer) + h) * 4 * h + 4 * h
                   for layer in range(cfg["num_layers"]))
    return sum(cone_steps(cfg["timesteps"])) * per_step


def train_flops(cfg: Dict) -> int:
    """FLOP one training sample needs: the forward (cone and projection),
    the backward through both, the projection's two gradient products and
    its bias's adds. Adam's elementwise update is not counted."""
    c, h2 = cfg["num_classes"], 2 * cfg["num_hidden"]
    return (detect_flops(cfg) + backward_flops(cfg)
            + 2 * 2 * c * h2 + c)


def weight_count(cfg: Dict) -> int:
    """Parameters of the model: both lanes' kernels and biases, and the
    projection."""
    h = cfg["num_hidden"]
    lane = sum((_layer_in(cfg, layer) + h) * 4 * h + 4 * h
               for layer in range(cfg["num_layers"]))
    return 2 * lane + 2 * h * cfg["num_classes"] + cfg["num_classes"]


def k1_bytes(cfg: Dict, windows: int, precision: str) -> int:
    """Bytes K1 moves for ``windows`` windows, each once: one feature row
    a window (its center row; neighbouring windows share the rest), the
    (2H,) fp32 center features written, the weights read."""
    return (windows * cfg["num_input"] * ITEMSIZE[precision]
            + windows * 2 * cfg["num_hidden"] * 4
            + weight_count(cfg) * ITEMSIZE[precision])


def k2_bytes(cfg: Dict, windows: int) -> int:
    """Bytes the training forward moves: the cone's input rows read, each
    layer's h and c of every cone step written for the backward (fp32),
    the weights read."""
    fw, bw = cone_steps(cfg["timesteps"])
    states = cfg["num_layers"] * (fw + bw) * cfg["num_hidden"] * 2 * 4
    return (windows * (max(fw, bw) * cfg["num_input"] * 4 + states)
            + weight_count(cfg) * 4)


def k3_bytes(cfg: Dict, windows: int) -> int:
    """Bytes the training backward moves: K2's states and the input rows
    read once, the weight gradients written once."""
    return k2_bytes(cfg, windows) + weight_count(cfg) * 4


def least_seconds(flops: float, nbytes: float, precision: str) -> Tuple[float, str]:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the bandwidth, and which one bounds it."""
    t_ops = flops / PEAK_OPS[precision]
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
