"""Device meshes for the port's data-parallel paths.

Counterpart of ``deepmod_tpu/parallel/mesh.py``. A JAX mesh names every
device of every process; here a ``Mesh`` holds this process's local
devices (one entry a shard; a device may be named more than once, which is
how one card or the CPU carries several shards) and the
``torch.distributed`` group the processes share, or ``None`` when no
group is initialized. ``process_index()`` and ``process_count()`` stand
for ``jax.process_index()`` and ``jax.process_count()``.

``make_2d_mesh`` adds a second, 'model' axis for tensor parallelism
(``parallel.tensor_parallel``): the local devices in row-major (data
groups, model) order. The model axis stays inside a process; the data
axis spans the processes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepmod_tpu_torch.utils.device import resolve_device


def default_group() -> Optional[Any]:
    """The default process group, or None when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 without a group."""
    return dist.get_rank() if default_group() is not None else 0


def process_count() -> int:
    """Processes in the default group (``jax.process_count()``)."""
    return dist.get_world_size() if default_group() is not None else 1


def comm_device(group) -> torch.device:
    """Where a collective's tensors must sit for the group's backend: the
    host for gloo (this port's collectives stage through it, on any shard
    device), the current CUDA device for nccl."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unsupported torch.distributed backend {backend!r}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards and the group. ``model`` > 1: ``devices`` in
    row-major (local data groups, model) order, ``axis_names`` the two
    axes' names; a 1-D mesh has ``model`` 1 and one device a data
    shard."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None
    model: int = 1
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Local (data groups, model), or (shards,) for a 1-D mesh."""
        if len(self.axis_names) == 1:
            return (self.local_size,)
        return (self.local_size // self.model, self.model)

    def data_groups(self) -> List[Tuple[torch.device, ...]]:
        """The local data groups, each its ``model`` devices in order."""
        m = self.model
        return [self.devices[i : i + m]
                for i in range(0, self.local_size, m)]

    @property
    def size(self) -> int:
        """Global shards: local shards x processes."""
        return self.local_size * self.process_count()

    def process_index(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    def process_count(self) -> int:
        return (dist.get_world_size(self.group)
                if self.group is not None else 1)


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; a
    machine without one raises, as ``resolve_device`` does), cut to the
    first ``n_devices``. CPU shards only where the caller names them,
    e.g. ``devices=["cpu"] * 8``."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)} "
                f"({[d.type for d in devices[:3]]}...)"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), default_group())


def make_2d_mesh(
    data: int,
    model: int,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """A (``data``, ``model``) mesh, as JAX's ``make_2d_mesh``: ``data``
    counts the data groups of every process, each group ``model``
    devices. This process holds ``data / processes`` groups of its local
    ``devices`` (default: every visible CUDA device; CPU shards only where
    named, e.g. ``devices=["cpu"] * 8``), laid out row-major, so a model
    group never spans processes."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got ({data}, {model})")
    group = default_group()
    nproc = dist.get_world_size(group) if group is not None else 1
    if data % nproc:
        raise ValueError(
            f"the model axis stays inside a process: {data} data groups "
            f"do not split over {nproc} processes, so a group of {model} "
            "model shards would span processes")
    need = data // nproc * model
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(tuple(devices[:need]), group, model, tuple(axis_names))
