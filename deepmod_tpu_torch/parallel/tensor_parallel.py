"""The BiLSTM forward with its gate axis sharded over a model group.

Counterpart of what the JAX package's SPMD partitioner makes of the XLA
scan under ``bilstm_param_spec(model_axis)`` (``deepmod_tpu/parallel/
shardings.py``): each LSTM kernel (in+H, 4H) is split on its 4H gate axis
over the group's m devices, each bias (4H,) likewise, and ``out_w``
(2H, C) on its input rows. Here the collectives are explicit and, since a
model group lives inside one process, they are copies between its
devices:

- model shard k holds the contiguous column block k*4H/m..(k+1)*4H/m of
  each layer's [Wx; Wh] and bias, and rows k*2H/m..(k+1)*2H/m of
  ``out_w`` (shard 0 also ``out_b``);
- each step, each shard computes its block of the gate pre-activations
  (its input projection, hoisted out of the recurrence as the scan does,
  plus h @ its Wh block); the blocks are gathered on the group's first
  device into the 4H gates, and the TF1 cell (gate order i, j, f, o,
  ``forget_bias`` inside the f sigmoid) runs there once; the new h goes
  back to every shard (replicated);
- both lanes run batched, the bw lane over the time-reversed window, each
  only over its readout cone; the readout is the center step, as in
  ``models/bilstm.py``;
- the projection sums the shards' partial logits.

All of it is plain torch in fp32, as JAX's scan is: the model axis never
runs a Pallas kernel in the JAX package (``shardings.py:74-78``).
Differentiable through autograd across the shard devices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

Params = Dict[str, Any]


def _block(n: int, m: int, k: int) -> slice:
    w = n // m
    return slice(k * w, (k + 1) * w)


def shard_params(params: Params, devices: Sequence[torch.device],
                 copy: bool = False) -> List[Params]:
    """Model shard k's blocks of ``params`` (the JAX dict layout) on
    ``devices[k]``; ``copy`` makes every block a fresh contiguous tensor
    (the train step's leaves), else a block on its own device may be a
    view of ``params``."""
    m = len(devices)
    two_h = params["out_w"].shape[0]
    if (2 * two_h) % m or two_h % m:
        raise ValueError(
            f"hidden {two_h // 2}: the gate axis (4H = {2 * two_h}) and "
            f"out_w's rows (2H = {two_h}) must split over {m} model shards")

    def put(t, dev):
        return t.to(dev, copy=copy, memory_format=torch.contiguous_format)

    shards = []
    for k, dev in enumerate(devices):
        gates = _block(2 * two_h, m, k)
        tree: Params = {lane: [
            {"kernel": put(lp["kernel"][:, gates], dev),
             "bias": put(lp["bias"][gates], dev)}
            for lp in params[lane]] for lane in ("fw", "bw")}
        tree["out_w"] = put(params["out_w"][_block(two_h, m, k)], dev)
        if k == 0:
            tree["out_b"] = put(params["out_b"], dev)
        shards.append(tree)
    return shards


def shard_leaves(shard: Params) -> List[torch.Tensor]:
    """A shard's tensors in ``train.trainer.param_leaves`` order (shard 0
    alone holds ``out_b``)."""
    leaves = [lp[key] for lane in ("fw", "bw") for lp in shard[lane]
              for key in ("kernel", "bias")] + [shard["out_w"]]
    if "out_b" in shard:
        leaves.append(shard["out_b"])
    return leaves


def tp_center_features(shards: Sequence[Params], x: torch.Tensor,
                       config) -> torch.Tensor:
    """(B, T, F) windows -> (B, 2H) center [fw; bw] features on the first
    shard's device."""
    devices = [s["out_w"].device for s in shards]
    home = devices[0]
    hidden = config.num_hidden
    timesteps = x.shape[1]
    center = config.center
    # fw reads out at step `center`, bw (reversed) at T-1-center <= center
    steps = center + 1
    seq = torch.stack([x, x.flip(1)])[:, :, :steps].to(home, torch.float32)
    batch = seq.shape[1]
    for layer in range(config.num_layers):
        in_dim = seq.shape[-1]
        xp, wh = [], []
        for shard, dev in zip(shards, devices):
            fw, bw = shard["fw"][layer], shard["bw"][layer]
            w_x = torch.stack([fw["kernel"][:in_dim], bw["kernel"][:in_dim]])
            bias = torch.stack([fw["bias"], bw["bias"]])
            # (2, B, S, 4H/m): the shard's input projection of every step
            xp.append(torch.matmul(seq.to(dev), w_x.unsqueeze(1))
                      + bias[:, None, None, :])
            wh.append(torch.stack([fw["kernel"][in_dim:],
                                   bw["kernel"][in_dim:]]))
        c = torch.zeros(2, batch, hidden, device=home)
        h = torch.zeros(2, batch, hidden, device=home)
        outs = []
        for t in range(steps):
            gates = torch.cat(
                [(xp_k[:, :, t] + torch.bmm(h.to(dev), wh_k)).to(home)
                 for xp_k, wh_k, dev in zip(xp, wh, devices)], dim=-1)
            i, j, f, o = gates.split(hidden, dim=-1)
            c = (c * torch.sigmoid(f + config.forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
            h = torch.tanh(c) * torch.sigmoid(o)
            outs.append(h)
        seq = torch.stack(outs, dim=2)
    return torch.cat([seq[0, :, center], seq[1, :, timesteps - 1 - center]],
                     dim=-1)


def tp_logits(shards: Sequence[Params], x: torch.Tensor,
              config) -> torch.Tensor:
    """(B, T, F) -> (B, C) logits on the first shard's device: the sum of
    the shards' partial projections, then ``out_b``."""
    feats = tp_center_features(shards, x, config)
    home = feats.device
    two_h = feats.shape[1]
    m = len(shards)
    out = None
    for k, shard in enumerate(shards):
        dev = shard["out_w"].device
        part = (feats[:, _block(two_h, m, k)].to(dev)
                @ shard["out_w"]).to(home)
        out = part if out is None else out + part
    out = out + shards[0]["out_b"]
    if config.output_layer == "sigmoid":
        out = torch.sigmoid(out)
    return out
