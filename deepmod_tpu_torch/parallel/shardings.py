"""The data-parallel train step over a mesh.

Counterpart of ``deepmod_tpu/parallel/shardings.py``'s train step, data
parallelism only: the batch is split contiguously over the mesh's local
shards, the parameters replicated on each shard's device. Each shard runs
the kernels a one-device step runs (K2 forward and K3 backward on the
card, their plain versions on the CPU). The step adds the shards' masked
loss sums, gradient sums and mask counts over the local shards, then
``all_reduce``s them over the mesh's process group, and divides after the
reduction, as the JAX per-shard step (``deepmod_tpu/train/trainer.py:
143-163``) does with ``psum``; the Adam update then runs identically in
every process.

One process launches its local shards one after another, so a mesh of
several cards in one process steps slower than one card (PERF.md);
``train_run`` therefore takes one card a process, and several cards train
as a ``torch.distributed`` rank a card.

Tensor parallelism (``model_axis``) is not ported: ROADMAP item 6b. The
sharded predict is ``engine.detect.WindowPredictor`` over several devices;
JAX's ``make_sharded_predict`` has no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, bilstm_example_losses
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused_train as train_ops

from .aggregation import _as_tensor
from .mesh import Mesh, comm_device, tensor_parallel_not_ported


def _shard_slices(n: int, shards: int) -> List[slice]:
    if n % shards:
        raise ValueError(
            f"{n} rows do not split over {shards} shards: pad the batch to "
            "a multiple of the shard count")
    rows = n // shards
    return [slice(s * rows, (s + 1) * rows) for s in range(shards)]


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
        self.shard_launches = [dict.fromkeys(train_ops.LAUNCHES, 0)
                               for _ in mesh.devices]

    def __call__(self, params, opt_state, x, y, mask) -> torch.Tensor:
        from deepmod_tpu_torch.train.trainer import adam_update, param_leaves

        mesh = self.mesh
        x, y, mask = (_as_tensor(a) for a in (x, y, mask))
        leaves = param_leaves(params)
        home = leaves[0].device
        lsum = torch.zeros((), dtype=torch.float32, device=home)
        msum = torch.zeros((), dtype=torch.float32, device=home)
        gsum = [torch.zeros_like(p) for p in leaves]
        for s, (dev, sl) in enumerate(zip(
                mesh.devices, _shard_slices(len(mask), mesh.local_size))):
            before = dict(train_ops.LAUNCHES)
            replica = params if dev == home else params_from_numpy(params, dev)
            rleaves = param_leaves(replica)
            for p in rleaves:
                p.requires_grad_(True)
            try:
                ms = mask[sl].to(dev, torch.float32)
                per_example = bilstm_example_losses(
                    replica, x[sl].to(dev, torch.float32), y[sl].to(dev),
                    self.model_config, self.unbalanced, self.precision)
                shard_sum = torch.sum(per_example * ms)
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
        if mesh.group is not None and mesh.process_count() > 1:
            flat = torch.cat([lsum.reshape(1), msum.reshape(1)]
                             + [g.reshape(-1) for g in gsum])
            flat = flat.to(comm_device(mesh.group))
            dist.all_reduce(flat, group=mesh.group)
            flat = flat.to(home)
            lsum, msum = flat[0], flat[1]
            off = 2
            for g in gsum:
                g.copy_(flat[off : off + g.numel()].view_as(g))
                off += g.numel()
        denom = torch.clamp(msum, min=1.0)
        adam_update(params, [g / denom for g in gsum], opt_state,
                    self.learning_rate)
        return lsum / denom


def make_sharded_train_step(
    model_config: BiLSTMConfig,
    learning_rate: float,
    mesh: Mesh,
    unbalanced: bool = False,
    precision: str = "fp32",
    model_axis: Optional[str] = None,
) -> ShardedTrainStep:
    """(params, opt_state, x, y, mask) -> loss, updating params and the Adam
    state in place; x/y/mask are this process's rows (a multiple of the
    local shard count). The loss is the masked mean over every process's
    rows; the gradients the same mean's, divided after the reduction."""
    if model_axis is not None:
        raise tensor_parallel_not_ported()
    return ShardedTrainStep(model_config, learning_rate, mesh, unbalanced,
                            precision)
