"""Trainer for the cluster-effect second-stage MLP, on one device.

Counterpart of ``deepmod_tpu/train/cluster_trainer.py``. The reference
ships only the trained checkpoint
(train_deepmod/na12878_cluster_train_mod-keep_prob0.7-nb25-chr1; its
training script is not in the repo), so the trainer reproduces what the
checkpoint implies: the 14->100->20->1 sigmoid MLP of
``models.cluster_mlp``, Adam (the checkpoint carries Adam slots; the
step is ``train.trainer.adam_update``, optax's order of operations),
dropout keep_prob 0.7 (from the bundled directory name), batch 4096
(hm_cluster_predict.py:16). The loss is binary cross-entropy, clipped,
against fractional targets.

Features and targets go to the device once and each minibatch is indexed
there. The initial weights and the minibatch order come from one CPU
``torch.Generator`` seeded by ``seed`` (the same numbers on every
device), the dropout masks from a generator on the device; the trained
weights are therefore not the JAX package's, whose draws come from
``jax.random``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deepmod_tpu_torch.models.cluster_mlp import (
    ClusterMLPConfig,
    cluster_forward,
    cluster_leaves,
    cluster_params_to_numpy,
    init_cluster_params,
)
from deepmod_tpu_torch.train.trainer import adam_update
from deepmod_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ClusterTrainConfig:
    epochs: int = 10
    batch_size: int = 4096       # hm_cluster_predict.py:16
    learning_rate: float = 1e-3
    keep_prob: float = 0.7       # bundled checkpoint name
    seed: int = 0


def cluster_loss(params, x: torch.Tensor, y: torch.Tensor, keep_prob: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    pred = cluster_forward(params, x, keep_prob, generator)
    pred = torch.clamp(pred, 1e-6, 1.0 - 1e-6)
    return -torch.mean(y * torch.log(pred) + (1.0 - y) * torch.log(1.0 - pred))


def train_cluster_model(
    features: np.ndarray,
    targets: np.ndarray,
    config: Optional[ClusterTrainConfig] = None,
    model_config: Optional[ClusterMLPConfig] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """(N, 14) features + (N,) target fractions -> trained params on
    ``device``, and the per-epoch mean loss history."""
    config = config or ClusterTrainConfig()
    model_config = model_config or ClusterMLPConfig()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    params = init_cluster_params(gen, model_config, dev)
    drop = None
    if config.keep_prob < 1.0:
        drop = torch.Generator(device=dev).manual_seed(config.seed)
    state = {"count": 0,
             "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    x_all = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    y_all = torch.as_tensor(np.asarray(targets, np.float32), device=dev)
    leaves = cluster_leaves(params)
    n = len(x_all)
    history: List[float] = []
    for _ in range(config.epochs):
        order = torch.randperm(n, generator=gen).to(dev)
        losses = []
        for lo in range(0, n, config.batch_size):
            idx = order[lo : lo + config.batch_size]
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = cluster_loss(params, x_all[idx], y_all[idx],
                                    config.keep_prob, drop)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            adam_update(params, grads, state, config.learning_rate,
                        leaves=cluster_leaves)
            losses.append(loss.detach())
        history.append(float(torch.stack(losses).double().mean()))
    return params, history


def save_cluster_npz(path: str, params) -> None:
    """The JAX package's layout: one array a key of ``PARAM_KEYS``."""
    np.savez(path, **cluster_params_to_numpy(params))
