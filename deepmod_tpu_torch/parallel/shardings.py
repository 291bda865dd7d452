"""Sharding specs and the sharded predict and train steps over a mesh.

Counterpart of ``deepmod_tpu/parallel/shardings.py``.

Data parallelism: the batch is split contiguously over the mesh's local
data groups, the parameters replicated on each. Each data shard runs the
kernels a one-device run does (K1 or K4 in the predict; K2 forward and K3
backward in the train step on the card, their plain versions on the CPU).
The train step adds the shards' masked loss sums, gradient sums and mask
counts over the local shards, then ``all_reduce``s them over the mesh's
process group, and divides after the reduction, as the JAX per-shard
step (``deepmod_tpu/train/trainer.py:143-163``) does with ``psum``; the
Adam update then runs identically in every process.

Tensor parallelism (``model_axis``, a ``make_2d_mesh`` mesh): each data
group runs the gate-sharded forward of ``parallel.tensor_parallel`` over
its model devices, in plain torch fp32, as JAX's partitioned XLA scan is
(the JAX package never runs a Pallas kernel on the model axis).

One process launches its local shards one after another, so a mesh of
several cards in one process steps slower than one card (PERF.md);
``train_run`` therefore takes one card a process, and several cards train
as a ``torch.distributed`` rank a card.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist

from deepmod_tpu_torch.models.bilstm import (
    CLASS_WEIGHTS,
    BiLSTMConfig,
    bilstm_example_losses,
    bilstm_logits,
)
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused_train as train_ops
from deepmod_tpu_torch.utils.profiling import span

from .aggregation import _as_tensor
from .mesh import Mesh, comm_device
from .tensor_parallel import shard_leaves, shard_params, tp_logits


def bilstm_param_spec(model_axis: Optional[str] = "model",
                      num_layers: int = 3) -> Any:
    """The parameter pytree's sharding, leaf by leaf, as JAX's
    ``bilstm_param_spec``: each leaf a tuple with an entry a tensor
    dimension, the mesh axis that dimension is split over or None (JAX's
    ``PartitionSpec``; ``()`` replicated). With a model axis the kernels
    (in+H, 4H) split their gate dim, the biases (4H,) dim 0 and out_w
    (2H, C) its input dim (partial-sum logits); without, all replicated."""
    if model_axis is None:
        layer = {"kernel": (), "bias": ()}
        return {"fw": [layer] * num_layers, "bw": [layer] * num_layers,
                "out_w": (), "out_b": ()}
    layer = {"kernel": (None, model_axis), "bias": (model_axis,)}
    return {"fw": [layer] * num_layers, "bw": [layer] * num_layers,
            "out_w": (model_axis, None), "out_b": ()}


def _model_axis(mesh: Mesh, model_axis: Optional[str]) -> Optional[str]:
    """JAX's rule: a model axis the mesh does not name is no model axis."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if model_axis is not None and (model_axis not in mesh.axis_names
                                   or len(mesh.axis_names) < 2):
        return None
    return model_axis


def _shard_slices(n: int, shards: int) -> List[slice]:
    if n % shards:
        raise ValueError(
            f"{n} rows do not split over {shards} shards: pad the batch to "
            "a multiple of the shard count")
    rows = n // shards
    return [slice(s * rows, (s + 1) * rows) for s in range(shards)]


def _data_devices(mesh: Mesh) -> List[torch.device]:
    """One device a local data group: every shard of a 1-D mesh, a 2-D
    mesh's groups' first devices (JAX: the batch split over 'data' only,
    replicated over 'model')."""
    return [g[0] for g in mesh.data_groups()]


def _reduce(mesh: Mesh, lsum, msum, gsum: List[torch.Tensor]):
    """(loss sum, mask sum, gradient sums) all-reduced over the mesh's
    processes, in place of ``gsum``'s tensors."""
    if mesh.group is None or mesh.process_count() <= 1:
        return lsum, msum
    home = lsum.device
    flat = torch.cat([lsum.reshape(1), msum.reshape(1)]
                     + [g.reshape(-1).to(home) for g in gsum])
    flat = flat.to(comm_device(mesh.group))
    dist.all_reduce(flat, group=mesh.group)
    flat = flat.to(home)
    off = 2
    for g in gsum:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()
    return flat[0], flat[1]


class ShardedTrainStep:
    """The data-parallel train step (``make_sharded_train_step``);
    ``shard_launches[s]``: the training kernels' launches made for shard s
    (K2 and K3, the wrappers' counts: ``bilstm_fused_train.LAUNCHES``'s
    keys)."""

    def __init__(self, model_config: BiLSTMConfig, learning_rate: float,
                 mesh: Mesh, unbalanced: bool, precision: str):
        self.model_config = model_config
        self.learning_rate = learning_rate
        self.mesh = mesh
        self.unbalanced = unbalanced
        self.precision = precision
        self.devices = _data_devices(mesh)
        self.shard_launches = [dict.fromkeys(train_ops.LAUNCHES, 0)
                               for _ in self.devices]

    def __call__(self, params, opt_state, x, y, mask) -> torch.Tensor:
        from deepmod_tpu_torch.train.trainer import adam_update, param_leaves

        x, y, mask = (_as_tensor(a) for a in (x, y, mask))
        leaves = param_leaves(params)
        home = leaves[0].device
        lsum = torch.zeros((), dtype=torch.float32, device=home)
        msum = torch.zeros((), dtype=torch.float32, device=home)
        gsum = [torch.zeros_like(p) for p in leaves]
        for s, (dev, sl) in enumerate(zip(
                self.devices, _shard_slices(len(mask), len(self.devices)))):
            before = dict(train_ops.LAUNCHES)
            replica = params if dev == home else params_from_numpy(params, dev)
            rleaves = param_leaves(replica)
            for p in rleaves:
                p.requires_grad_(True)
            try:
                with span("train.forward"):
                    ms = mask[sl].to(dev, torch.float32)
                    per_example = bilstm_example_losses(
                        replica, x[sl].to(dev, torch.float32), y[sl].to(dev),
                        self.model_config, self.unbalanced, self.precision)
                    shard_sum = torch.sum(per_example * ms)
                with span("train.backward"):
                    grads = torch.autograd.grad(shard_sum, rleaves)
            finally:
                for p in rleaves:
                    p.requires_grad_(False)
            for key, n in train_ops.LAUNCHES.items():
                self.shard_launches[s][key] += n - before[key]
            lsum += shard_sum.detach().to(home)
            msum += ms.sum().to(home)
            for acc, g in zip(gsum, grads):
                acc += g.to(home)
        lsum, msum = _reduce(self.mesh, lsum, msum, gsum)
        denom = torch.clamp(msum, min=1.0)
        grads = [g / denom for g in gsum]
        with span("train.adam"):
            adam_update(params, grads, opt_state, self.learning_rate)
        return lsum / denom


def _tp_example_losses(shards, x, y, config, unbalanced: bool):
    """(B,) softmax cross-entropy of the gate-sharded logits, the loss of
    ``models.bilstm.bilstm_example_losses``."""
    logits = tp_logits(shards, x, config)
    if unbalanced:
        logits = logits * torch.tensor(CLASS_WEIGHTS, dtype=logits.dtype,
                                       device=logits.device)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.sum(y.to(log_probs.device, log_probs.dtype) * log_probs,
                      dim=-1)


class TensorParallelTrainStep:
    """The train step over a (data, model) mesh: each local data group
    runs the gate-sharded forward and backward (``parallel.
    tensor_parallel``, plain torch fp32) on its contiguous slice of the
    batch. Each parameter block's gradient is summed over the data
    groups on the first group's shard device, then ``all_reduce``d over
    the process group with the loss and mask sums; the division comes
    after the reduction. Adam updates each block on its shard's device.

    ``params`` and ``opt_state`` are in the layout the 1-D step takes: the
    full (unsharded) tensors of the JAX dict layout, on any one device
    (``adam_init``'s state). The step copies their blocks to the shards
    and writes the updated blocks back into them, so the caller gets that
    same layout back, updated in place."""

    def __init__(self, model_config: BiLSTMConfig, learning_rate: float,
                 mesh: Mesh, unbalanced: bool):
        self.model_config = model_config
        self.learning_rate = learning_rate
        self.mesh = mesh
        self.unbalanced = unbalanced

    def __call__(self, params, opt_state, x, y, mask) -> torch.Tensor:
        from deepmod_tpu_torch.train.trainer import adam_update, param_leaves

        x, y, mask = (_as_tensor(a) for a in (x, y, mask))
        groups = self.mesh.data_groups()
        home = groups[0][0]
        # every data group's replica of the blocks, as its autograd leaves
        replicas = [shard_params(params, g, copy=True) for g in groups]
        lsum = torch.zeros((), dtype=torch.float32, device=home)
        msum = torch.zeros((), dtype=torch.float32, device=home)
        gsum = None
        for shards, sl in zip(replicas, _shard_slices(len(mask),
                                                      len(groups))):
            leaves = [t for sh in shards for t in shard_leaves(sh)]
            for p in leaves:
                p.requires_grad_(True)
            dev = shards[0]["out_w"].device
            with span("train.forward"):
                ms = mask[sl].to(dev, torch.float32)
                per_example = _tp_example_losses(
                    shards, x[sl].to(dev, torch.float32), y[sl],
                    self.model_config, self.unbalanced)
                shard_sum = torch.sum(per_example * ms)
            with span("train.backward"):
                grads = torch.autograd.grad(shard_sum, leaves)
            lsum += shard_sum.detach().to(home)
            msum += ms.sum().to(home)
            if gsum is None:
                gsum = list(grads)
            else:
                for acc, g in zip(gsum, grads):
                    acc += g.to(acc.device)
        lsum, msum = _reduce(self.mesh, lsum, msum, gsum)
        denom = torch.clamp(msum, min=1.0)
        # Adam on each block of the first data group, on its device
        mu = shard_params(opt_state["mu"], groups[0], copy=True)
        nu = shard_params(opt_state["nu"], groups[0], copy=True)
        count = opt_state["count"]
        grads = iter(gsum)
        blocks_grads = []
        for blocks in replicas[0]:
            for p in shard_leaves(blocks):
                p.requires_grad_(False)
            blocks_grads.append([next(grads) / denom.to(p.device)
                                 for p in shard_leaves(blocks)])
        with span("train.adam"):
            for blocks, block_grads, m, v in zip(replicas[0], blocks_grads,
                                                 mu, nu):
                state = {"count": count, "mu": m, "nu": v}
                adam_update(blocks, block_grads, state, self.learning_rate,
                            leaves=shard_leaves)
        opt_state["count"] = count + 1
        self._write_back(params, replicas[0])
        self._write_back(opt_state["mu"], mu)
        self._write_back(opt_state["nu"], nu)
        return (lsum / denom).to(param_leaves(params)[0].device)

    @staticmethod
    @torch.no_grad()
    def _write_back(full, shards) -> None:
        """Copy each shard's blocks into the full tensors of ``full``."""
        m = len(shards)
        two_h = full["out_w"].shape[0]
        for k, shard in enumerate(shards):
            gates = slice(k * 2 * two_h // m, (k + 1) * 2 * two_h // m)
            rows = slice(k * two_h // m, (k + 1) * two_h // m)
            for lane in ("fw", "bw"):
                for lp, blk in zip(full[lane], shard[lane]):
                    lp["kernel"][:, gates].copy_(blk["kernel"])
                    lp["bias"][gates].copy_(blk["bias"])
            full["out_w"][rows].copy_(shard["out_w"])
            if "out_b" in shard:
                full["out_b"].copy_(shard["out_b"])


def make_sharded_train_step(
    model_config: BiLSTMConfig,
    learning_rate: float,
    mesh: Mesh,
    unbalanced: bool = False,
    precision: str = "fp32",
    model_axis: Optional[str] = None,
):
    """(params, opt_state, x, y, mask) -> loss, updating params and the Adam
    state in place; x/y/mask are this process's rows (a multiple of the
    local data group count). The loss is the masked mean over every
    process's rows; the gradients the same mean's, divided after the
    reduction. ``model_axis`` (a name of a ``make_2d_mesh`` mesh's axes):
    ``TensorParallelTrainStep``, fp32 (``precision`` is the 1-D step's
    K2/K3 storage, as in JAX the scan ignores it); a name the mesh does
    not have is no model axis, as in JAX."""
    if _model_axis(mesh, model_axis) is not None:
        return TensorParallelTrainStep(model_config, learning_rate, mesh,
                                       unbalanced)
    return ShardedTrainStep(model_config, learning_rate, mesh, unbalanced,
                            precision)


class ShardedPredict:
    """(params, x) -> (N,) int64 predictions on the mesh's first device
    (``make_sharded_predict``); ``logits(params, x)`` the (N, C) logits.
    ``x`` (N, T, F), N a multiple of the local data group count, split
    contiguously over the groups."""

    def __init__(self, model_config: BiLSTMConfig, mesh: Mesh,
                 model_axis: Optional[str], precision: str):
        self.model_config = model_config
        self.mesh = mesh
        self.model_axis = model_axis
        self.precision = precision

    def logits(self, params, x) -> torch.Tensor:
        x = _as_tensor(x)
        groups = self.mesh.data_groups()
        home = groups[0][0]
        outs = []
        with torch.no_grad():
            for group, sl in zip(groups, _shard_slices(len(x), len(groups))):
                if self.model_axis is None:
                    dev = group[0]
                    out = bilstm_logits(params_from_numpy(params, dev),
                                        x[sl].to(dev), self.model_config,
                                        self.precision)
                else:
                    out = tp_logits(shard_params(params, group), x[sl],
                                    self.model_config)
                outs.append(out.to(home))
        return torch.cat(outs)

    def __call__(self, params, x) -> torch.Tensor:
        return torch.argmax(self.logits(params, x), dim=-1)


def make_sharded_predict(
    model_config: BiLSTMConfig,
    mesh: Mesh,
    model_axis: Optional[str] = None,
    precision: str = "fp32",
) -> ShardedPredict:
    """The predict over a mesh, as JAX's ``make_sharded_predict``. Without
    a model axis, K1 (or K4) per data shard in ``precision`` (JAX's
    ``use_pallas`` path under ``shard_map``; the CPU runs the kernels'
    plain versions); with one, the gate-sharded scan of ``parallel.
    tensor_parallel`` per data group, in fp32 whatever ``precision`` says,
    as JAX's scan computes (its precision reaches only the Pallas
    kernel)."""
    return ShardedPredict(model_config, mesh, _model_axis(mesh, model_axis),
                          precision)
