"""Device meshes for the port's data-parallel paths.

Counterpart of ``deepmod_tpu/parallel/mesh.py``. A JAX mesh names every
device of every process; here a ``Mesh`` holds this process's local
devices (one entry a shard; a device may be named more than once, which is
how one card or the CPU carries several shards) and the
``torch.distributed`` group the processes share, or ``None`` when no
group is initialized. ``process_index()`` and ``process_count()`` stand
for ``jax.process_index()`` and ``jax.process_count()``.

Tensor parallelism (a second, 'model' axis: ``make_2d_mesh``) is not
ported (ROADMAP port queue item 6b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepmod_tpu_torch.utils.device import resolve_device


def tensor_parallel_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "tensor parallelism (a 'model' mesh axis) is not ported to the "
        "PyTorch package yet (ROADMAP port queue: item 6b, tensor "
        "parallelism); use a 1-D data-parallel mesh"
    )


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
    """A 1-D data-parallel mesh: this process's shards and the group."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

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


def make_2d_mesh(data: int, model: int,
                 axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    raise tensor_parallel_not_ported()
