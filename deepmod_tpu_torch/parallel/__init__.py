"""Data-, tensor-parallel and multi-process runs of detect and train.

Counterpart of ``deepmod_tpu/parallel``: ``mesh`` (a process's shards, a
(data, model) mesh, and its ``torch.distributed`` group), ``aggregation``
(per-position counts summed over shards), ``cross_process`` (the
end-of-run count and index merge across processes), ``tensor_parallel``
(the gate-sharded forward) and ``shardings`` (the sharded predict and
train steps).
"""

from .aggregation import sharded_position_counts
from .mesh import make_2d_mesh, make_mesh
from .shardings import (
    bilstm_param_spec,
    make_sharded_predict,
    make_sharded_train_step,
)
