"""Per-position aggregation over a mesh's shards.

Counterpart of ``deepmod_tpu/parallel/aggregation.py``: each shard
scatter-adds its rows' (position, covered, mod) triples into dense count
vectors (``index_add_`` on the shard's device, JAX's ``.at[].add``), the
shards' vectors are summed over the local devices (JAX's ``psum`` over
the mesh). A caller that wants the sum over processes ``all_reduce``s
the result, as the multihost worker does. The detect engine reduces its
batches locally: the processes' batch counts differ, so a collective per
batch would deadlock; its end-of-run merge is ``parallel.cross_process``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import Mesh


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def sharded_position_counts(
    mesh: Mesh,
    positions,
    covered,
    modded,
    length: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coverage, mod_count) int32 vectors of ``length`` on the mesh's
    first device, summed over every local shard's rows.

    positions/covered/modded: (N,) arrays or tensors, N divisible by the
    local shard count (pad with covered = modded = 0 rows at position 0);
    rows split contiguously over the shards, as JAX's P('data')."""
    pos, cov, mod = (_as_tensor(a) for a in (positions, covered, modded))
    n_shards = mesh.local_size
    if len(pos) % n_shards:
        raise ValueError(
            f"{len(pos)} rows do not split over {n_shards} shards: pad with "
            "covered = modded = 0 rows at position 0")
    rows = len(pos) // n_shards
    home = mesh.devices[0]
    total_cov = torch.zeros(length, dtype=torch.int32, device=home)
    total_mod = torch.zeros(length, dtype=torch.int32, device=home)
    for s, dev in enumerate(mesh.devices):
        sl = slice(s * rows, (s + 1) * rows)
        p = pos[sl].to(dev, torch.int64)
        c = torch.zeros(length, dtype=torch.int32, device=dev).index_add_(
            0, p, cov[sl].to(dev, torch.int32))
        m = torch.zeros(length, dtype=torch.int32, device=dev).index_add_(
            0, p, mod[sl].to(dev, torch.int32))
        total_cov += c.to(home)
        total_mod += m.to(home)
    return total_cov, total_mod
