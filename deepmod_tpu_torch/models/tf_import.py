"""BiLSTM checkpoints for the PyTorch port: the native ``.npz`` format and
the reference's TF1 checkpoints.

The ``.npz`` layout is the JAX package's (``deepmod_tpu/models/
tf_import.py::save_bilstm_npz``), so a model saved by either package
loads in the other: ``meta/*`` scalars (``meta/output_layer`` a 0-d bytes
array), ``{fw,bw}/<layer>/{kernel,bias}`` in TF's (in+H, 4H) i,j,f,o
layout, ``out_w`` and ``out_b``. A training run's checkpoints also carry
the Adam slots in the JAX package's layout (``adam/count`` and
``adam/{mu,nu}/<param key>``): ``save_bilstm_npz(..., opt_state=...)``
writes them and ``load_adam_state`` reads them back, so a resume from a
checkpoint of either package continues the run.

The reference ships its models as TF1 checkpoints (five BiLSTM ones and
one cluster-model one under train_deepmod/). ``load_model`` reads any path
that does not end in ``.npz`` as one, through ``models.tf_bundle`` (numpy
only, no TensorFlow), with the JAX package's variable layout
(``deepmod_tpu/models/tf_import.py``, verified there against the bundled
rnn_f7_wd21_chr1to10_4 and Cg.cov5.nb25 checkpoints):

BiLSTM (myMultiBiRNN.py:21-91):
    bidirectional_rnn/{fw,bw}/multi_rnn_cell/cell_{0,1,2}/basic_lstm_cell/kernel
        (in+H, 4H) with the TF (i, j, f, o) gate order, used as it is;
    .../bias  (4H,)
    Variable   (2H, 2)  output weight
    Variable_1 (2,)     output bias

Cluster MLP (hm_cluster_predict.py):
    W_1 (14,100) b_1 (100,) W_2 (100,20) b_2 (20,) W_O (20,1) b_O (1,)

Other variables (Adam slots, ``global_step``) are not read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .bilstm import BiLSTMConfig
from .cluster_mlp import PARAM_KEYS, ClusterMLPConfig
from .tf_bundle import CheckpointReader

RNN_KERNEL = "bidirectional_rnn/{d}/multi_rnn_cell/cell_{l}/basic_lstm_cell/kernel"
RNN_BIAS = "bidirectional_rnn/{d}/multi_rnn_cell/cell_{l}/basic_lstm_cell/bias"


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
    """A params tree of numpy arrays, JAX arrays passed through numpy, or
    torch tensors -> the same tree of (new) torch tensors on ``device``."""
    from deepmod_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=dev, dtype=dtype, copy=True)
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=dev)

    return _map_params(tree, conv)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A params tree of torch tensors or arrays -> fp32 numpy arrays."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a, np.float32)

    return _map_params(tree, conv)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A params-shaped tree -> the .npz key naming (Adam's mu/nu mirror
    the params, so the same keys serve them under ``adam/{mu,nu}/``)."""
    tree = params_to_numpy(tree)
    flat = {prefix + "out_w": tree["out_w"], prefix + "out_b": tree["out_b"]}
    for lane in ("fw", "bw"):
        for layer, lp in enumerate(tree[lane]):
            flat[f"{prefix}{lane}/{layer}/kernel"] = lp["kernel"]
            flat[f"{prefix}{lane}/{layer}/bias"] = lp["bias"]
    return flat


def _unflatten(data, num_layers: int, prefix: str = "") -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        lane: [{"kernel": data[f"{prefix}{lane}/{layer}/kernel"],
                "bias": data[f"{prefix}{lane}/{layer}/bias"]}
               for layer in range(num_layers)]
        for lane in ("fw", "bw")
    }
    tree["out_w"] = data[prefix + "out_w"]
    tree["out_b"] = data[prefix + "out_b"]
    return tree


def save_bilstm_npz(path: str, params: Dict[str, Any], config: BiLSTMConfig,
                    opt_state: Optional[Dict[str, Any]] = None) -> None:
    """Persist a BiLSTM (torch or numpy tree) as a flat .npz.

    With ``opt_state`` (the trainer's Adam state: ``count``, ``mu``,
    ``nu``) the slots ride along as ``adam/count`` (int32) and
    ``adam/{mu,nu}/...``, the layout the JAX package's ``load_adam_state``
    reads."""
    flat = {
        "meta/num_input": np.int64(config.num_input),
        "meta/num_hidden": np.int64(config.num_hidden),
        "meta/timesteps": np.int64(config.timesteps),
        "meta/num_layers": np.int64(config.num_layers),
        "meta/num_classes": np.int64(config.num_classes),
        "meta/output_layer": np.bytes_(config.output_layer.encode()),
    }
    flat.update(_flatten(params))
    if opt_state is not None:
        flat["adam/count"] = np.asarray(opt_state["count"], np.int32)
        flat.update(_flatten(opt_state["mu"], "adam/mu/"))
        flat.update(_flatten(opt_state["nu"], "adam/nu/"))
    np.savez(path, **flat)


def load_adam_state(path: str, params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The Adam state stored by either package's ``save_bilstm_npz``, on
    the device of ``params`` (torch tensors); None for a params-only
    checkpoint, whose callers start from fresh slots."""
    data = np.load(path)
    if "adam/count" not in data:
        return None
    num_layers = int(data["meta/num_layers"])
    device = params["out_w"].device
    return {
        "count": int(data["adam/count"]),
        "mu": params_from_numpy(_unflatten(data, num_layers, "adam/mu/"), device),
        "nu": params_from_numpy(_unflatten(data, num_layers, "adam/nu/"), device),
    }


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
    return _unflatten(data, config.num_layers), config


def _bilstm_config(reader: CheckpointReader) -> BiLSTMConfig:
    shapes = reader.get_variable_to_shape_map()
    k0 = RNN_KERNEL.format(d="fw", l=0)
    if k0 not in shapes:
        raise ValueError(f"{reader.prefix} is not a DeepMod BiLSTM checkpoint")
    num_hidden = shapes[k0][1] // 4
    num_layers = 0
    while RNN_KERNEL.format(d="fw", l=num_layers) in shapes:
        num_layers += 1
    return BiLSTMConfig(
        num_input=shapes[k0][0] - num_hidden,
        num_hidden=num_hidden,
        num_layers=num_layers,
        num_classes=shapes["Variable"][1],
    )


def bilstm_config_from_checkpoint(prefix: str) -> BiLSTMConfig:
    """(num_input, num_hidden, num_layers, num_classes) from the shapes in
    a TF checkpoint's ``.index``: its ``.data`` files may be absent (the
    reference strips them from its BiLSTM checkpoints)."""
    return _bilstm_config(CheckpointReader(prefix))


def load_bilstm_checkpoint(prefix: str) -> Tuple[Dict[str, Any], BiLSTMConfig]:
    """A reference BiLSTM TF checkpoint -> (params as numpy fp32, config);
    ``FileNotFoundError`` where its ``.data`` shard is missing."""
    reader = CheckpointReader(prefix)
    config = _bilstm_config(reader)

    def get(name: str) -> np.ndarray:
        return np.asarray(reader.get_tensor(name), dtype=np.float32)

    params: Dict[str, Any] = {
        d: [{"kernel": get(RNN_KERNEL.format(d=d, l=layer)),
             "bias": get(RNN_BIAS.format(d=d, l=layer))}
            for layer in range(config.num_layers)]
        for d in ("fw", "bw")
    }
    params["out_w"] = get("Variable")
    params["out_b"] = get("Variable_1")
    return params, config


def load_cluster_checkpoint(
        prefix: str) -> Tuple[Dict[str, np.ndarray], ClusterMLPConfig]:
    """The reference's cluster-effect MLP TF checkpoint -> (params as numpy
    fp32, config)."""
    reader = CheckpointReader(prefix)
    params = {name: np.asarray(reader.get_tensor(name), dtype=np.float32)
              for name in PARAM_KEYS}
    config = ClusterMLPConfig(
        num_input=params["W_1"].shape[0],
        hidden1=params["W_1"].shape[1],
        hidden2=params["W_2"].shape[1],
    )
    return params, config


def load_model(prefix: str) -> Tuple[Dict[str, Any], BiLSTMConfig]:
    """A BiLSTM model (numpy params) from a native .npz or a TF checkpoint
    prefix."""
    if prefix.endswith(".npz"):
        return load_bilstm_npz(prefix)
    return load_bilstm_checkpoint(prefix)
