"""Cluster-effect second-stage model (5mC CpG refinement), in PyTorch.

The MLP of ``deepmod_tpu/models/cluster_mlp.py``, which restores the
reference's DeepMod_tools/hm_cluster_predict.py:94-103 model from the
bundled checkpoint
``train_deepmod/na12878_cluster_train_mod-keep_prob0.7-nb25-chr1/Cg.cov5.nb25``:

    X (B, 14) -> W_1 (14, 100) + b_1 -> ReLU -> dropout
              -> W_2 (100, 20) + b_2 -> ReLU -> dropout
              -> W_O (20, 1)  + b_O -> sigmoid = output:0

Inference runs with keep_prob=1 (hm_cluster_predict.py:161), so dropout
is the identity there; training draws it from an explicit
``torch.Generator``. The products are plain ``torch.matmul`` on the card
(the JAX package leaves them to XLA outside any Pallas kernel).

Parameters keep the JAX package's flat dict (``W_1, b_1, W_2, b_2, W_O,
b_O``) as torch tensors; ``cluster_params_from_numpy`` and
``cluster_params_to_numpy`` carry them across, and the ``.npz`` layout
(``train.cluster_trainer.save_cluster_npz``) is the JAX package's, so
either package loads the other's file.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deepmod_tpu_torch.utils.device import resolve_device

PARAM_KEYS = ("W_1", "b_1", "W_2", "b_2", "W_O", "b_O")


@dataclasses.dataclass(frozen=True)
class ClusterMLPConfig:
    num_input: int = 14
    hidden1: int = 100
    hidden2: int = 20
    nb_size: int = 25      # neighbor window, hm_cluster_predict.py:83
    cov_threshold: int = 5  # coverage gate, hm_cluster_predict.py:18


Params = Dict[str, torch.Tensor]


def _truncated_normal(generator: torch.Generator, shape, stddev: float
                      ) -> torch.Tensor:
    """TF ``truncated_normal``: normal draws beyond 2 sigma drawn again."""
    out = torch.randn(shape, generator=generator)
    bad = out.abs() > 2.0
    while bool(bad.any()):
        out[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = out.abs() > 2.0
    return stddev * out


def init_cluster_params(
    generator: torch.Generator,
    config: ClusterMLPConfig = ClusterMLPConfig(),
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Weights truncated normal (stddev 0.1, cut at 2 sigma), biases zero,
    drawn from ``generator`` (a CPU generator: the same numbers whatever
    the device)."""
    dev = resolve_device(device)
    shapes = {"W_1": (config.num_input, config.hidden1),
              "W_2": (config.hidden1, config.hidden2),
              "W_O": (config.hidden2, 1)}
    params = {}
    for w, b in (("W_1", "b_1"), ("W_2", "b_2"), ("W_O", "b_O")):
        params[w] = _truncated_normal(generator, shapes[w], 0.1).to(dev)
        params[b] = torch.zeros(shapes[w][1], device=dev)
    return params


def cluster_params_from_numpy(tree: Dict[str, Any],
                              device: Union[str, torch.device] = "cuda"
                              ) -> Params:
    """The JAX package's params (numpy or JAX arrays) -> fp32 tensors."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(tree[k], np.float32), device=dev)
            for k in PARAM_KEYS}


def cluster_params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in PARAM_KEYS}


def cluster_leaves(params: Dict[str, Any]) -> List[Any]:
    """The trainable tensors in a fixed order (the Adam slots follow it)."""
    return [params[k] for k in PARAM_KEYS]


def _dropout(h: torch.Tensor, keep_prob: float,
             generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


def cluster_forward(
    params: Params,
    x: torch.Tensor,
    keep_prob: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, 14) -> (B,) sigmoid methylation fraction in [0, 1]. Dropout
    only with ``keep_prob < 1`` and a generator on ``x``'s device."""
    drop = keep_prob < 1.0 and generator is not None
    h1 = torch.relu(x @ params["W_1"] + params["b_1"])
    if drop:
        h1 = _dropout(h1, keep_prob, generator)
    h2 = torch.relu(h1 @ params["W_2"] + params["b_2"])
    if drop:
        h2 = _dropout(h2, keep_prob, generator)
    return torch.sigmoid(h2 @ params["W_O"] + params["b_O"])[:, 0]
