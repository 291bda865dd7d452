"""The model's weights, made from the seed on the device.

The same tensors go to the program (which packs them its own way) and to
``bench_h100.reference``. The layout is the published one, TF1's
``BasicLSTMCell``: a (in + H, 4H) kernel and a (4H,) bias a layer a
direction, gates in (i, j, f, o) order, then the (2H, C) projection.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_h100.seeds import stream_seed


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight in a fixed order: fw layers, bw
    layers (kernel, bias each), the projection's kernel and bias."""
    h = cfg["num_hidden"]
    out = []
    for lane in ("fw", "bw"):
        for layer in range(cfg["num_layers"]):
            in_dim = cfg["num_input"] if layer == 0 else h
            out.append((f"{lane}.{layer}.kernel", (in_dim + h, 4 * h)))
            out.append((f"{lane}.{layer}.bias", (4 * h,)))
    out.append(("out_w", (2 * h, cfg["num_classes"])))
    out.append(("out_b", (cfg["num_classes"],)))
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat {name: fp32 tensor} from ``seed``: two draws on the device.
    LSTM kernels glorot-uniform (the reference's initializer), biases
    uniform in +-0.1 (the initializer's zeros would leave the bias path
    unchecked), the projection standard normal clipped to +-2."""
    shapes = leaf_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))
    lstm = [(n, s) for n, s in shapes if not n.startswith("out_")]
    proj = [(n, s) for n, s in shapes if n.startswith("out_")]
    sizes = [int(np.prod(s)) for _, s in lstm]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    z = torch.randn(sum(int(np.prod(s)) for _, s in proj), generator=gen,
                    device=device).clamp_(-2, 2)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for (name, shape), size in zip(lstm, sizes):
        part = u[pos : pos + size].view(shape)
        pos += size
        if name.endswith("kernel"):
            rows, cols = shape
            part = part * float(np.sqrt(6.0 / (rows + cols)))
        else:
            part = part * 0.1
        out[name] = part.contiguous()
    pos = 0
    for name, shape in proj:
        size = int(np.prod(shape))
        out[name] = z[pos : pos + size].view(shape).contiguous()
        pos += size
    return out


def as_port_params(flat: Dict[str, torch.Tensor]) -> Dict:
    """The nested {"fw": [{kernel, bias}], "bw": [...], out_w, out_b}
    layout the program takes, over the same tensors."""
    tree: Dict = {"fw": [], "bw": []}
    for name, t in flat.items():
        parts = name.split(".")
        if len(parts) == 3:
            lane, layer, key = parts
            while len(tree[lane]) <= int(layer):
                tree[lane].append({})
            tree[lane][int(layer)][key] = t
        else:
            tree[name] = t
    return tree


def from_port_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """The flat layout of a nested params tree, in ``leaf_shapes`` order."""
    out = {}
    for lane in ("fw", "bw"):
        for layer, lp in enumerate(tree[lane]):
            out[f"{lane}.{layer}.kernel"] = lp["kernel"]
            out[f"{lane}.{layer}.bias"] = lp["bias"]
    out["out_w"] = tree["out_w"]
    out["out_b"] = tree["out_b"]
    return out
