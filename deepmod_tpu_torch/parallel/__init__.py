"""Data-parallel and multi-process runs of detect and train.

Counterpart of ``deepmod_tpu/parallel``: ``mesh`` (a process's shards and
its ``torch.distributed`` group), ``aggregation`` (per-position counts
summed over shards), ``cross_process`` (the end-of-run count and index
merge across processes) and ``shardings`` (the data-parallel predict and
train steps). Tensor parallelism is not ported (ROADMAP item 6b).
"""
