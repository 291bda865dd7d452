"""BiLSTM checkpoints for the PyTorch port: the native ``.npz`` format.

The ``.npz`` layout is the JAX package's (``deepmod_tpu/models/
tf_import.py::save_bilstm_npz``), so a model saved by either package
loads in the other: ``meta/*`` scalars (``meta/output_layer`` a 0-d bytes
array), ``{fw,bw}/<layer>/{kernel,bias}`` in TF's (in+H, 4H) i,j,f,o
layout, ``out_w`` and ``out_b``. Adam slots that a training run stored
(``adam/...``) are ignored here: training is not ported yet.

Reading the reference's TF1 checkpoints is not ported yet either (it is a
ROADMAP item of the port); ``load_model`` raises for them.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .bilstm import BiLSTMConfig


def _map_params(tree: Dict[str, Any], conv) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        lane: [{"kernel": conv(lp["kernel"]), "bias": conv(lp["bias"])}
               for lp in tree[lane]]
        for lane in ("fw", "bw")
    }
    out["out_w"] = conv(tree["out_w"])
    out["out_b"] = conv(tree["out_b"])
    return out


def params_from_numpy(
    tree: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """A params tree of numpy arrays (or JAX arrays passed through numpy)
    -> the same tree of torch tensors on ``device``."""
    from deepmod_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    return _map_params(tree, lambda a: torch.tensor(
        np.asarray(a, np.float32), dtype=dtype, device=dev))


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A params tree of torch tensors or arrays -> fp32 numpy arrays."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a, np.float32)

    return _map_params(tree, conv)


def save_bilstm_npz(path: str, params: Dict[str, Any],
                    config: BiLSTMConfig) -> None:
    """Persist a BiLSTM (torch or numpy tree) as a flat .npz."""
    tree = params_to_numpy(params)
    flat = {
        "meta/num_input": np.int64(config.num_input),
        "meta/num_hidden": np.int64(config.num_hidden),
        "meta/timesteps": np.int64(config.timesteps),
        "meta/num_layers": np.int64(config.num_layers),
        "meta/num_classes": np.int64(config.num_classes),
        "meta/output_layer": np.bytes_(config.output_layer.encode()),
        "out_w": tree["out_w"],
        "out_b": tree["out_b"],
    }
    for lane in ("fw", "bw"):
        for layer, lp in enumerate(tree[lane]):
            flat[f"{lane}/{layer}/kernel"] = lp["kernel"]
            flat[f"{lane}/{layer}/bias"] = lp["bias"]
    np.savez(path, **flat)


def load_bilstm_npz(path: str) -> Tuple[Dict[str, Any], BiLSTMConfig]:
    """-> (params as numpy arrays, config); ``params_from_numpy`` moves
    them onto a device."""
    data = np.load(path)
    config = BiLSTMConfig(
        num_input=int(data["meta/num_input"]),
        num_hidden=int(data["meta/num_hidden"]),
        timesteps=int(data["meta/timesteps"]),
        num_layers=int(data["meta/num_layers"]),
        num_classes=int(data["meta/num_classes"]),
        output_layer=data["meta/output_layer"].item().decode(),
    )
    params: Dict[str, Any] = {
        lane: [{"kernel": data[f"{lane}/{layer}/kernel"],
                "bias": data[f"{lane}/{layer}/bias"]}
               for layer in range(config.num_layers)]
        for lane in ("fw", "bw")
    }
    params["out_w"] = data["out_w"]
    params["out_b"] = data["out_b"]
    return params, config


def load_model(prefix: str) -> Tuple[Dict[str, Any], BiLSTMConfig]:
    """Load a BiLSTM model from a native .npz (numpy params)."""
    if prefix.endswith(".npz"):
        return load_bilstm_npz(prefix)
    raise NotImplementedError(
        f"{prefix}: reading TF1 checkpoints is not ported to the PyTorch "
        "package yet (ROADMAP: TF-checkpoint import); convert it to .npz "
        "with deepmod_tpu.models.tf_import.load_model + save_bilstm_npz"
    )
