"""One rank of a real multi-process ``torch.distributed`` run.

Counterpart of ``deepmod_tpu/testing/multihost_worker.py``. The reference
has no distributed backend at all (its "multi-node" story is independent
runs and file merges, docs/Usage.md:22-27). Here the cross-process
primitives (the position-count reduction over shards and processes, and
the data-parallel train step) and the full detect engine run under an
actual process group: one process a rank, two local shards of
``--device`` each (as the JAX worker's two CPU devices a process).

Usage (spawned by tests/test_torch_multiprocess.py and chip_smoke.py;
start every rank with the same <nproc> and <port>):

    python -m deepmod_tpu_torch.testing.multihost_worker \\
        <process_id> <num_processes> <port> <out_json> \\
        [detect <dataset_dir> <out_folder> |
         train <mod_features> <ctl_features> <out_folder> | tp] \\
        [--device cpu|cuda] [--backend gloo|nccl] [--basecalls calls.bam]
        [--host_shard I:N] [--full_width]

Rank r takes card r mod the visible cards. The backend is chosen once:
``--backend``, else nccl for cuda and gloo for cpu; the rank prints it.
nccl takes one rank a card (two ranks on one card are refused), so ranks
sharing a card run over gloo. ``detect`` reads
``<dataset_dir>/fast5`` (``<dataset_dir>/pod5`` with ``--basecalls``) and
``<dataset_dir>/ref.fa``: files stripe over the ranks, each rank reduces
its counts over its local shards (device aggregation), the end-of-run
merge (``parallel.cross_process``) gives ONE BED set from rank 0.
``train`` runs one epoch of ``train_run`` under the group (the
data-parallel step over every rank, checkpoints from rank 0). ``tp``
runs one tensor-parallel train step on a (ranks, 2) mesh, a data group a
rank and its two model shards on the rank's device
(``tp_step_inputs`` gives every rank's rows), and checks that a model
axis across the ranks is refused. A rank that fails exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


class _RulePredictor:
    """Deterministic stand-in classifier (same rule as the reference
    differential suite): 1 iff the center event's mean is positive.
    Removes model float sensitivity so BED comparisons across device
    topologies are exact. ``mesh`` gives the engine the local shards its
    device aggregation reduces over."""

    def __init__(self, mesh=None):
        from types import SimpleNamespace

        self.config = SimpleNamespace(timesteps=21)
        self.mesh = mesh

    def predict_from_features(self, features, centers, window=21,
                              **kwargs):
        import numpy as np

        return (features[centers, features.shape[1] - 3] > 0).astype(np.int8)

    def predict_from_blocks(self, blocks, firsts, counts, window=21,
                            **kwargs):
        import numpy as np

        from deepmod_tpu_torch.engine.outputs import run_centers

        return self.predict_from_features(np.concatenate(blocks),
                                          run_centers(firsts, counts))


def run_detect(dataset_dir: str, out_folder: str, out_path: str, mesh,
               basecalls: str = "", host_shard=None) -> None:
    from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run

    conf = DetectConfig(
        wrk_base=os.path.join(dataset_dir, "pod5" if basecalls else "fast5"),
        ref=os.path.join(dataset_dir, "ref.fa"),
        model_path="unused",
        out_folder=out_folder,
        file_id="mod",
        base="C",
        align_str="builtin",
        threads=1,
        device_aggregation=True,
        basecalls=basecalls,
        write_per_read=not basecalls,
        device=str(mesh.devices[0]),
        host_shard=host_shard,
    )
    res = detect_run(conf, predictor=_RulePredictor(mesh))
    with open(out_path, "w") as fh:
        json.dump(
            {
                "pid": mesh.process_index(),
                "devices": mesh.size,
                "num_reads": res.num_reads,
                "num_windows": res.num_windows,
                "wall_s": res.elapsed_s,
                "stage_seconds": {
                    k: round(v, 4) for k, v in res.stage_seconds.items()
                },
                "beds": sorted(
                    os.path.basename(b) for b in res.bed_files
                ),
                "errors": {k: len(v) for k, v in res.errors.items()},
            },
            fh,
        )


def run_train(mod_dir: str, ctl_dir: str, out_folder: str, out_path: str,
              device, full_width: bool = False) -> None:
    """``train_run`` under the group: one epoch over the feature files
    (every rank loads them all and trains on its share of each padded
    minibatch; rank 0 writes the checkpoints), at hidden 16 and batch 512,
    or with ``full_width`` at TrainConfig's defaults (hidden 100, batch
    2048, the CLI's ``train --epochs 1``). ``train_s``: the run's wall,
    after a barrier that starts the group's communicator."""
    import time

    import torch
    import torch.distributed as dist

    from deepmod_tpu_torch.train.loader import find_feature_files
    from deepmod_tpu_torch.train.trainer import (
        TrainConfig,
        param_leaves,
        train_run,
    )

    small = {} if full_width else dict(hidden=16, batch_size=512,
                                       learning_rate=3e-3, log_every=100,
                                       seed=3)
    dist.barrier()
    t0 = time.perf_counter()
    params, _, _ = train_run(
        [find_feature_files(mod_dir), find_feature_files(ctl_dir)],
        TrainConfig(out_folder=out_folder, epochs=1, device=str(device),
                    **small))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    with open(out_path, "w") as fh:
        json.dump(
            {
                "pid": dist.get_rank(),
                "train_s": train_s,
                "checksum": float(sum(float(leaf.abs().sum().item())
                                      for leaf in param_leaves(params))),
            },
            fh,
        )


def run_primitives(mesh, out_path: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.parallel.aggregation import sharded_position_counts
    from deepmod_tpu_torch.parallel.mesh import comm_device
    from deepmod_tpu_torch.parallel.shardings import make_sharded_train_step
    from deepmod_tpu_torch.train.trainer import adam_init, param_leaves

    pid, nproc = mesh.process_index(), mesh.process_count()
    n_local = mesh.local_size

    # ---- cross-process position-count merge ------------------------------
    # each process contributes DISTINCT observations; the merged counts
    # must equal the numpy sum over all processes (deterministically
    # reconstructable from pid)
    length = 64
    rows_per_proc = 8

    def local_obs(p):
        rng = np.random.RandomState(100 + p)
        pos = rng.randint(0, length, rows_per_proc).astype(np.int32)
        cov = np.ones(rows_per_proc, np.int32)
        mod = (rng.rand(rows_per_proc) < 0.5).astype(np.int32)
        return pos, cov, mod

    pos, cov, mod = local_obs(pid)
    cov_vec, mod_vec = sharded_position_counts(mesh, pos, cov, mod, length)
    both = torch.stack([cov_vec, mod_vec]).to(comm_device(mesh.group))
    dist.all_reduce(both, group=mesh.group)
    cov_vec, mod_vec = both.unbind(0)
    want_cov = np.zeros(length, np.int64)
    want_mod = np.zeros(length, np.int64)
    for p in range(nproc):
        ppos, pcov, pmod = local_obs(p)
        np.add.at(want_cov, ppos, pcov)
        np.add.at(want_mod, ppos, pmod)
    counts_ok = bool(
        np.array_equal(cov_vec.cpu().numpy(), want_cov)
        and np.array_equal(mod_vec.cpu().numpy(), want_mod)
    )

    # ---- cross-process data-parallel train step --------------------------
    config = BiLSTMConfig(num_input=7, num_hidden=16, timesteps=5, num_layers=1)
    params = init_bilstm_params(0, config, device=mesh.devices[0])  # same seed everywhere
    opt_state = adam_init(params)
    step = make_sharded_train_step(config, 1e-3, mesh)

    per_proc = 2 * n_local
    rng = np.random.RandomState(7 + pid)  # distinct shard per process
    x_local = rng.randn(per_proc, 5, 7).astype(np.float32)
    y_local = np.zeros((per_proc, 2), np.float32)
    y_local[np.arange(per_proc) % 2, 0] = 1.0
    y_local[np.arange(per_proc) % 2 == 0, 1] = 1.0
    m_local = np.ones((per_proc,), np.float32)
    loss = step(params, opt_state, x_local, y_local, m_local)
    # updated params are replicated: checksum must agree across processes
    checksum = float(sum(float(leaf.abs().sum().item())
                         for leaf in param_leaves(params)))
    with open(out_path, "w") as fh:
        json.dump(
            {
                "pid": pid,
                "devices": mesh.size,
                "local_devices": n_local,
                "device": str(mesh.devices[0]),
                "counts_ok": counts_ok,
                "loss": float(loss.item()),
                "checksum": checksum,
            },
            fh,
        )


TP_ROWS = 8  # rows a rank of the ``tp`` mode's step


def tp_step_inputs(nproc: int):
    """The ``tp`` mode's model config, params (numpy), and every rank's
    rows in rank order: x, y, mask for ``nproc * TP_ROWS`` windows."""
    import numpy as np

    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import params_to_numpy

    config = BiLSTMConfig(num_input=7, num_hidden=16, timesteps=5,
                          num_layers=2)
    params = params_to_numpy(init_bilstm_params(5, config, device="cpu"))
    rng = np.random.default_rng(17)
    n = nproc * TP_ROWS
    x = rng.standard_normal((n, 5, 7)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 2, 4] > 0).astype(np.int64)]
    mask = np.ones(n, np.float32)
    mask[-3:] = 0.0
    return config, params, x, y, mask


def run_tp(device, out_path: str) -> None:
    """One tensor-parallel train step, data over the ranks, model 2 inside
    each; the loss and the flat params after it."""
    import numpy as np
    import torch.distributed as dist

    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.parallel.mesh import make_2d_mesh
    from deepmod_tpu_torch.parallel.shardings import make_sharded_train_step
    from deepmod_tpu_torch.train.trainer import adam_init, param_leaves

    pid, nproc = dist.get_rank(), dist.get_world_size()
    try:
        make_2d_mesh(1, 2, devices=[device] * 2)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    mesh = make_2d_mesh(nproc, 2, devices=[device] * 2)
    config, tree, x, y, mask = tp_step_inputs(nproc)
    params = params_from_numpy(tree, device)
    opt_state = adam_init(params)
    step = make_sharded_train_step(config, 1e-3, mesh, model_axis="model")
    rows = slice(pid * TP_ROWS, (pid + 1) * TP_ROWS)
    loss = step(params, opt_state, x[rows], y[rows], mask[rows])
    flat = np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in param_leaves(params)])
    with open(out_path, "w") as fh:
        json.dump({"pid": pid, "mesh_shape": list(mesh.shape),
                   "refused": refused, "loss": float(loss.item()),
                   "params": flat.tolist()}, fh)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(nproc: int, out_dir: str, args: Sequence[str] = (),
              env: Optional[Dict[str, str]] = None,
              timeout: float = 240.0) -> List[dict]:
    """Start ``nproc`` ranks of this worker (fresh interpreters, never a
    fork, OMP_NUM_THREADS=1) with ``args`` after the positional ones, wait
    for all, and return each rank's JSON in rank order. A rank that exits
    non-zero, or a run past ``timeout`` seconds (every rank is then
    killed), raises with the ranks' output."""
    port = free_port()
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"rank_{p}.json") for p in range(nproc)]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PYTEST_CURRENT_TEST", None)
    # each rank's output goes to a file: a full pipe would stall a rank
    # that the others then wait for inside a collective
    log_paths = [os.path.join(out_dir, f"rank_{p}.log") for p in range(nproc)]
    procs = []
    try:
        for p in range(nproc):
            with open(log_paths[p], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "deepmod_tpu_torch.testing.multihost_worker",
                     str(p), str(nproc), str(port), outs[p], *args],
                    cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = []
    for path in log_paths:
        with open(path, "rb") as fh:
            logs.append(fh.read().decode(errors="replace"))
    failed = [p for p, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(
            f"ranks {failed} of {nproc} failed:\n"
            + "\n".join(f"--- rank {p}:\n{logs[p][-3000:]}" for p in failed))
    results = []
    for out, log in zip(outs, logs):
        with open(out) as fh:
            results.append(dict(json.load(fh), log=log))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="multihost_worker")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out_json")
    ap.add_argument("mode", nargs="*",
                    metavar="detect DATASET OUT_FOLDER | train MOD CTL OUT "
                    "| tp")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--basecalls", default="")
    ap.add_argument("--host_shard", default=None, metavar="I:N",
                    help="detect --hostShard (refused under a group)")
    ap.add_argument("--full_width", action="store_true",
                    help="train at TrainConfig's defaults (hidden 100, "
                         "batch 2048), not the small test model")
    args = ap.parse_args(argv)
    if args.mode and (args.mode[0], len(args.mode)) not in (
            ("detect", 3), ("train", 4), ("tp", 1)):
        ap.error("the optional mode is: detect <dataset_dir> <out_folder>, "
                 "train <mod_features> <ctl_features> <out_folder> or tp")

    import torch
    import torch.distributed as dist

    from deepmod_tpu_torch.parallel.mesh import make_mesh
    from deepmod_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        # a card a rank while there are cards enough; ranks beyond that
        # share them (which nccl refuses)
        device = torch.device("cuda", args.pid % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    print(f"[multihost_worker] rank {args.pid}/{args.nproc} backend "
          f"{backend} device {device}", flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{args.port}",
        rank=args.pid, world_size=args.nproc,
    )
    try:
        mesh = make_mesh(devices=[device] * 2)
        if mesh.process_count() != args.nproc:
            raise RuntimeError(f"group of {mesh.process_count()} ranks, "
                               f"expected {args.nproc}")
        if args.mode and args.mode[0] == "tp":
            run_tp(device, args.out_json)
        elif args.mode and args.mode[0] == "train":
            run_train(args.mode[1], args.mode[2], args.mode[3],
                      args.out_json, device, args.full_width)
        elif args.mode:
            host_shard = (tuple(map(int, args.host_shard.split(":")))
                          if args.host_shard else None)
            run_detect(args.mode[1], args.mode[2], args.out_json, mesh,
                       args.basecalls, host_shard)
        else:
            run_primitives(mesh, args.out_json)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
