"""Bidirectional stacked-LSTM modification classifier, in PyTorch.

The semantics of the reference TF1 graph (bin/DeepMod_scripts/
myMultiBiRNN.py:21-91), as ``deepmod_tpu/models/bilstm.py`` defines them:

- ``num_layers`` stacked LSTM layers per direction with the TF1
  ``BasicLSTMCell`` math: gates = [x; h] @ W + b split in (i, j, f, o)
  order, c' = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j),
  h' = tanh(c') * sigmoid(o);
- the bw stack reads the window time-reversed; outputs concatenated
  [fw; bw] at the CENTER step only, then a (2H, 2) dense projection
  (sigmoid-activated when ``output_layer == 'sigmoid'``).

Parameters keep the JAX package's dict layout: ``fw``/``bw`` lists of
``{kernel (in+H, 4H), bias (4H,)}`` plus ``out_w (2H, C)`` and
``out_b (C,)``, as torch tensors. Inference runs the recurrence in
``ops.bilstm_fused`` (K1 for odd T <= 25, K4 for every other T), training
in ``ops.bilstm_fused_train`` (K2 forward, K3 backward): the CUDA kernels
on the card, their plain versions on the CPU. ``_stack_direction`` runs
one direction's stack layer by layer, through ``ops.lstm_layer`` (K6 on
the card). The projection, softmax, argmax and loss are plain
torch, as the JAX package leaves them to XLA outside its Pallas kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import numpy as np
import torch

from deepmod_tpu_torch.ops.bilstm_fused import (
    PackedBiLSTM,
    bilstm_center_features as _fused_center,
)
from deepmod_tpu_torch.ops.bilstm_fused_train import bilstm_center_train
from deepmod_tpu_torch.ops.lstm_layer import lstm_layer


@dataclasses.dataclass(frozen=True)
class BiLSTMConfig:
    """Hyperparameters (defaults match bin/DeepMod.py:336-338,305-319)."""

    num_input: int = 7          # --fnum
    num_hidden: int = 100       # --hidden
    timesteps: int = 21         # --windowsize
    num_layers: int = 3         # myMultiBiRNN.py:23
    num_classes: int = 2        # myMultiBiRNN.py:21
    forget_bias: float = 1.0    # myMultiBiRNN.py:39-40
    output_layer: str = ""      # "" (linear) or "sigmoid" (myMultiBiRNN.py:50-53)

    @property
    def center(self) -> int:
        return self.timesteps // 2


Params = Dict[str, Any]


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """TF ``truncated_normal``: standard normal resampled beyond 2 sigma."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return out.astype(np.float32)


def init_bilstm_params(seed: int, config: BiLSTMConfig,
                       device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters with TF1-equivalent initializers, from a numpy seed.

    LSTM kernels glorot-uniform, biases zero, the output projection
    truncated normal (myMultiBiRNN.py:31-32). The numbers differ from the
    JAX package's ``jax.random`` draws; tests that compare the two build
    one set with numpy and hand it to both."""
    from deepmod_tpu_torch.models.tf_import import params_from_numpy

    rng = np.random.default_rng(seed)
    h = config.num_hidden
    tree: Params = {"fw": [], "bw": []}
    for direction in ("fw", "bw"):
        for layer in range(config.num_layers):
            in_dim = config.num_input if layer == 0 else h
            limit = np.sqrt(6.0 / (in_dim + h + 4 * h))
            tree[direction].append({
                "kernel": rng.uniform(-limit, limit, (in_dim + h, 4 * h))
                .astype(np.float32),
                "bias": np.zeros(4 * h, np.float32),
            })
    tree["out_w"] = _truncated_normal(rng, (2 * h, config.num_classes))
    tree["out_b"] = _truncated_normal(rng, (config.num_classes,))
    return params_from_numpy(tree, device)


def _stack_direction(layers: List[Dict[str, torch.Tensor]],
                     x_seq: torch.Tensor, forget_bias: float,
                     reverse: bool) -> torch.Tensor:
    """One direction's stack over (B, T, F) -> (B, T, H), layer by layer
    through ``ops.lstm_layer``: K6 on a CUDA tensor, its plain version on
    the CPU (the JAX ``_stack_direction``; its ``use_pallas`` choice
    between the scan and ``lstm_layer_pallas`` is the device here). With
    ``reverse`` the steps run T-1..0 and each output stays at its own
    index, the reverse-run-unreverse composition of
    ``static_bidirectional_rnn`` (myMultiBiRNN.py:47)."""
    out = x_seq
    for lp in layers:
        out = lstm_layer(lp["kernel"], lp["bias"], out, forget_bias, reverse)
    return out


def bilstm_center_features(
    params: Union[Params, PackedBiLSTM], x: torch.Tensor,
    config: BiLSTMConfig, precision: str = "fp32",
) -> torch.Tensor:
    """(B, T, F) windows -> (B, 2H) center-step [fw; bw] features."""
    return _fused_center(params, x, config, precision)


def _raw(params):
    return params.params if isinstance(params, PackedBiLSTM) else params


def bilstm_logits(
    params: Union[Params, PackedBiLSTM], x: torch.Tensor,
    config: BiLSTMConfig, precision: str = "fp32",
) -> torch.Tensor:
    """(B, T, F) -> (B, C) logits, replicating myMultiBiRNN.py:50-55."""
    feats = bilstm_center_features(params, x, config, precision)
    raw = _raw(params)
    out = feats @ raw["out_w"] + raw["out_b"]
    if config.output_layer == "sigmoid":
        out = torch.sigmoid(out)
    return out


def bilstm_probs(
    params: Union[Params, PackedBiLSTM], x: torch.Tensor,
    config: BiLSTMConfig, precision: str = "fp32",
) -> torch.Tensor:
    return torch.softmax(bilstm_logits(params, x, config, precision), dim=-1)


def bilstm_predict(
    params: Union[Params, PackedBiLSTM], x: torch.Tensor,
    config: BiLSTMConfig, precision: str = "fp32",
) -> torch.Tensor:
    """argmax class per window (mfpred, myMultiBiRNN.py:59-61)."""
    return torch.argmax(bilstm_logits(params, x, config, precision), dim=-1)


def bilstm_logits_trainable(
    params: Params, x: torch.Tensor, config: BiLSTMConfig,
    precision: str = "fp32",
) -> torch.Tensor:
    """Differentiable logits: the recurrence runs through the training
    kernels' autograd Function (K2 forward, K3 backward on the card; their
    plain versions on the CPU). ``precision='bf16'`` stores the residual
    and gradient sequences in bfloat16 with fp32 weights and compute; the
    center features leave in that dtype and the projection runs in fp32."""
    feats = bilstm_center_train(params, x, config, precision)
    out = feats.to(torch.float32) @ params["out_w"] + params["out_b"]
    if config.output_layer == "sigmoid":
        out = torch.sigmoid(out)
    return out


# Class weights for unbalanced training (myMultiBiRNN.py:13).
CLASS_WEIGHTS = (0.1, 0.9)


def bilstm_example_losses(
    params: Params, x: torch.Tensor, y: torch.Tensor, config: BiLSTMConfig,
    unbalanced: bool = False, precision: str = "fp32",
) -> torch.Tensor:
    """(B,) softmax cross-entropy of each window on the trainable logits.
    With ``unbalanced`` the LOGITS are scaled by the class weights before
    the softmax, as the reference does (myMultiBiRNN.py:64-65)."""
    logits = bilstm_logits_trainable(params, x, config, precision)
    if unbalanced:
        logits = logits * torch.tensor(CLASS_WEIGHTS, dtype=logits.dtype,
                                       device=logits.device)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.sum(y.to(log_probs.dtype) * log_probs, dim=-1)


def bilstm_loss(
    params: Params, x: torch.Tensor, y: torch.Tensor, config: BiLSTMConfig,
    unbalanced: bool = False, precision: str = "fp32",
) -> torch.Tensor:
    """Mean softmax cross-entropy (``bilstm_example_losses`` averaged)."""
    return bilstm_example_losses(params, x, y, config, unbalanced,
                                 precision).mean()


def count_params(params: Params) -> int:
    leaves = [lp[k] for lane in ("fw", "bw") for lp in params[lane]
              for k in ("kernel", "bias")] + [params["out_w"], params["out_b"]]
    return sum(int(np.prod(tuple(p.shape))) for p in leaves)
