"""Persistent bidirectional host worker pool for detect.

The port's copy of ``deepmod_tpu/engine/host_pool.py``. The reference
forks N workers per run, each owning a TF session AND its batch's
predetail writes (detect_handler, myDetect.py:948-984, 714-760).
``HostPool`` keeps that split without a device in the workers:

- workers own the FULL host side of a batch: ingest/align/features
  before device inference, prediction scatter + predetail HDF5 + COO
  count summary after. Per-batch files guarantee writer exclusivity
  (the reference's own layout), so the gzip'd writes parallelize across
  workers; only the cheap ``add_coo`` accumulation stays in the engine.
- the pool is reusable across ``detect_run`` calls (pass it like a warm
  ``WindowPredictor``): serving and repeated library use pay the spawn
  startup once.

Protocol (engine <-> worker, over per-worker input queues and one shared
output queue):

  engine -> worker:
    ("ingest", bid, batch_id, paths, ct_folder, out_opts, target_base,
     window)
    ("preds", bid, preds_sel)          # classification result for bid
    ("ingest_return", bid, paths)      # host stages only, ship results
    ("drop_pending",)                  # abandon stashed batch state
    ("stop",)
  worker -> engine:
    ("features", wid, bid, features, centers, errors)
    ("outputs", wid, bid, n_reads, n_windows, index_entries, coo,
     seconds, errors)
    ("results", wid, bid, results, errors)   # for ingest_return
    ("error", wid, bid, phase, message)

``bid`` is POOL-unique and routes messages; ``batch_id`` is the run's
batch index and only names output files. The split lets a reused pool
identify (and drop) messages from a previous run that died mid-flight.

Workers are spawned, never forked: the engine process holds a CUDA
context, and a worker must never initialize one. They import only
``host_worker``, ``outputs`` and the host layers, none of which imports
``torch`` (``deepmod_tpu_torch.engine`` loads ``detect`` lazily).
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
from typing import Dict, List, Optional

from .host_worker import HostOptions


def _worker_main(wid: int, inq, outq, host_opts: HostOptions) -> None:
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.engine.outputs import (
        build_batch_request,
        counts_to_coo,
        scatter_selected_preds,
        write_batch_outputs,
    )

    init_worker(host_opts)
    pending: Dict[int, tuple] = {}
    while True:
        msg = inq.get()
        kind = msg[0]
        if kind == "stop":
            break
        if kind == "drop_pending":
            pending.clear()
            continue
        bid = msg[1]
        try:
            if kind == "ingest":
                (_, bid, batch_id, paths, ct_folder, out_opts,
                 target_base, window) = msg
                results, errors = host_process_files(paths)
                if results:
                    feats, centers, selections, n_total = (
                        build_batch_request(results, target_base, window)
                    )
                    pending[bid] = (results, selections, n_total,
                                    batch_id, ct_folder, out_opts)
                    outq.put(("features", wid, bid, feats, centers, errors))
                else:
                    outq.put(
                        ("outputs", wid, bid, 0, 0, [], [], 0.0, errors)
                    )
            elif kind == "preds":
                _, bid, preds_sel = msg
                (results, selections, n_total, batch_id, ct_folder,
                 out_opts) = pending.pop(bid)
                t0 = time.perf_counter()
                preds = scatter_selected_preds(
                    results, selections, preds_sel, n_total
                )
                local_counts: dict = {}
                n_r, n_w, idx = write_batch_outputs(
                    results, preds, out_opts, local_counts, batch_id,
                    ct_folder,
                )
                coo = counts_to_coo(local_counts)
                outq.put(
                    ("outputs", wid, bid, n_r, n_w, idx, coo,
                     time.perf_counter() - t0, {})
                )
            elif kind == "ingest_return":
                _, bid, paths = msg
                results, errors = host_process_files(paths)
                outq.put(("results", wid, bid, results, errors))
        except Exception as exc:  # a bad batch never kills the worker
            pending.pop(bid, None)
            outq.put(
                ("error", wid, bid, kind, f"{type(exc).__name__}: {exc}")
            )


class HostPool:
    """Spawn-context worker pool with per-worker task routing.

    ``submit_ingest`` assigns a batch to the least-loaded worker; the
    classification result MUST be routed back to the same worker with
    ``send_preds`` (it holds the batch's read state). ``next_message``
    surfaces worker death as synthesized "error" messages for the dead
    worker's in-flight batches, so the engine's census sees them and the
    run completes on the surviving workers (reference behavior: a bad
    batch never kills the run).
    """

    def __init__(self, n_workers: int, host_opts: HostOptions):
        import multiprocessing as mp

        # spawn children re-import from scratch: make sure they can find
        # this package even when the parent extended sys.path manually
        import deepmod_tpu_torch as _pkg

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__))
        )
        existing = os.environ.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            os.environ["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        ctx = mp.get_context("spawn")
        self.host_opts = host_opts
        self.n_workers = n_workers
        self.outq = ctx.Queue()
        self._procs: List = []
        self._inqs: List = []
        self._load: List[int] = []
        self._inflight: Dict[int, int] = {}  # bid -> wid
        self._closed = False
        # bids are POOL-unique (monotonic), not caller batch ids: after a
        # run dies mid-flight (device error propagating out of
        # detect_run), a reused pool may still hold that run's messages
        # and worker-side pending state — unique bids make them
        # identifiable as stale, and next_message drops them
        self._next_bid = 0
        for wid in range(n_workers):
            inq = ctx.Queue()
            proc = ctx.Process(
                target=_worker_main,
                args=(wid, inq, self.outq, host_opts),
                daemon=True,
            )
            proc.start()
            self._procs.append(proc)
            self._inqs.append(inq)
            self._load.append(0)

    # -- dispatch ----------------------------------------------------------

    def _pick_worker(self) -> Optional[int]:
        best, best_load = None, None
        for wid, proc in enumerate(self._procs):
            if proc is None or not proc.is_alive():
                continue
            if best_load is None or self._load[wid] < best_load:
                best, best_load = wid, self._load[wid]
        return best

    def min_load(self) -> Optional[int]:
        """Load of the least-loaded live worker (None: all dead)."""
        wid = self._pick_worker()
        return None if wid is None else self._load[wid]

    def submit_ingest(
        self, batch_id: int, paths, ct_folder: str, out_opts, target_base,
        window: int,
    ) -> int:
        """Dispatch a batch; returns the pool-unique bid its messages
        will carry (``batch_id`` is only used for output file naming). Its
        feature rows come back trimmed to the rows the classifier's
        ``window``-row windows read (``outputs.build_batch_request``)."""
        wid = self._pick_worker()
        if wid is None:
            raise RuntimeError("all host-pool workers have died")
        bid = self._next_bid
        self._next_bid += 1
        self._load[wid] += 1
        self._inflight[bid] = wid
        self._inqs[wid].put(
            ("ingest", bid, batch_id, paths, ct_folder, out_opts,
             target_base, window)
        )
        return bid

    def submit_ingest_return(self, paths) -> int:
        """Host stages only; results ship back (the serving pattern)."""
        wid = self._pick_worker()
        if wid is None:
            raise RuntimeError("all host-pool workers have died")
        bid = self._next_bid
        self._next_bid += 1
        self._load[wid] += 1
        self._inflight[bid] = wid
        self._inqs[wid].put(("ingest_return", bid, paths))
        return bid

    def send_preds(self, wid: int, bid: int, preds_sel) -> None:
        self._inqs[wid].put(("preds", bid, preds_sel))

    # -- receive -----------------------------------------------------------

    def next_message(self) -> tuple:
        """Block for the next worker message; detect dead workers.

        Terminal messages ("outputs"/"results"/"error") decrement the
        producing worker's load and retire the batch.
        """
        while True:
            try:
                msg = self.outq.get(timeout=2.0)
            except queue_mod.Empty:
                died = self._reap_dead()
                if died:
                    return died
                if not self._inflight:
                    raise RuntimeError(
                        "host pool has no in-flight batches to wait for"
                    )
                continue
            wid, bid = msg[1], msg[2]
            if bid not in self._inflight:
                # stale message from a run that died mid-flight (its
                # exception propagated out of the engine before this
                # batch finished) — drop it; the worker's matching
                # pending entry, if any, is overwritten on reuse or
                # reaped at close
                continue
            if msg[0] in ("outputs", "results", "error"):
                self._load[wid] = max(0, self._load[wid] - 1)
                self._inflight.pop(bid, None)
            return msg

    def _reap_dead(self) -> Optional[tuple]:
        """Synthesize an error message for one batch lost to a dead
        worker (callers loop, so one at a time keeps the protocol
        single-message)."""
        for bid, wid in list(self._inflight.items()):
            proc = self._procs[wid]
            if proc is not None and not proc.is_alive():
                self._inflight.pop(bid)
                self._load[wid] = 0
                return (
                    "error", wid, bid, "worker",
                    f"WorkerDied: exitcode {proc.exitcode}",
                )
        return None

    # -- lifecycle ---------------------------------------------------------

    def abandon_inflight(self) -> None:
        """Reset after a run died mid-flight with work outstanding: clear
        the routing state (so a reused pool schedules freshly) and tell
        workers to drop any stashed batch state. Stale queue messages are
        dropped by next_message's unknown-bid filter."""
        self._inflight.clear()
        for wid in range(len(self._procs)):
            self._load[wid] = 0
            try:
                self._inqs[wid].put(("drop_pending",))
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for wid, proc in enumerate(self._procs):
            if proc is None:
                continue
            try:
                self._inqs[wid].put(("stop",))
            except (OSError, ValueError):
                pass
        deadline = time.time() + 10.0
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=max(0.1, deadline - time.time()))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)

    def __enter__(self) -> "HostPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
