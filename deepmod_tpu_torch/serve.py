"""Long-lived serving mode of the PyTorch port.

Counterpart of ``deepmod_tpu/serve.py``. Loads the model (an ``.npz`` or
the reference's TF1 checkpoint) and the aligner index ONCE, keeps the
predictor on the card, and answers detection requests over HTTP (stdlib
``http.server``). Its device stage is ``engine.detect.
predict_batch_windows``, the one ``detect`` runs: K1 on the card at the
default window of 21.

Endpoints (JSON in/out):

  GET  /healthz            -> {"status": "ok", "model": ..., "backend":
                               "cuda" | "cpu", "device": the card's name}
  POST /detect             -> body {"fast5": ["/path1", ...]} (fast5, or
       pod5 for a service built with ``basecalls``); returns per-read
       predictions and per-position counts:
       {"reads": [{"read_id", "chrom", "strand", "pos0", "n_aligned",
                   "pred_mod_num"}...],
        "positions": [[chrom, strand, pos, coverage, mod_count], ...],
        "errors": {...}}

Start:  python -m deepmod_tpu_torch serve --Ref ref.fa --modfile m.npz

One deviation from the JAX package: the coalescer's grace window closes
``COALESCE_GRACE_S`` after it takes a batch's first request. The JAX
coalescer restarts its 4 ms wait on every arrival, so under a steady
stream its batch never closes. Answers are the same bits either way.

This module imports no torch at its top: a HostPool worker must not load
it.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

# how long the dispatcher waits, after it takes a batch's first request,
# for other requests to join the batch
COALESCE_GRACE_S = 0.004
_STOP = object()


class _DeviceCoalescer:
    """Batches concurrent requests' windows into ONE device call.

    A dispatcher thread takes a request, gathers every request that
    arrives within ``COALESCE_GRACE_S`` of taking it, concatenates their
    host results into one ``predict`` call (the predictor buckets any
    batch size) and splits the predictions back per request, so k
    concurrent requests pay about one device call instead of k.
    ``DMT_SERVE_COALESCE=0`` makes it single-flight (for A/B probes).

    ``device_calls`` counts the ``predict`` calls; ``max_grace_s`` is the
    longest a batch waited, after taking its first request, for the last
    request it took (at most ``COALESCE_GRACE_S``).
    """

    def __init__(self, predict: Callable):
        self._predict = predict
        self._q: queue.Queue = queue.Queue()
        self.device_calls = 0
        self.max_grace_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def classify(self, results):
        """HostReadResult list -> per-window int8 predictions (ordered
        like the results); blocks until the coalesced call completes."""
        back: queue.Queue = queue.Queue()
        self._q.put((results, back))
        out = back.get()
        if isinstance(out, Exception):
            raise out
        return out

    def close(self) -> None:
        self._q.put(_STOP)
        self._thread.join(timeout=5)

    def _gather(self, batch: list):
        """Add to ``batch`` what arrives within the grace window; returns
        an item taken too late for it (the next batch's first), or None."""
        first = time.monotonic()
        deadline = first + COALESCE_GRACE_S
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                return None
            taken = time.monotonic()
            if item is _STOP or taken >= deadline:
                return item
            batch.append(item)
            self.max_grace_s = max(self.max_grace_s, taken - first)

    def _loop(self) -> None:
        import numpy as np

        carry = None
        while True:
            item = carry if carry is not None else self._q.get()
            carry = None
            if item is _STOP:
                return
            batch = [item]
            if os.environ.get("DMT_SERVE_COALESCE", "1") != "0":
                carry = self._gather(batch)
            all_results = [r for results, _ in batch for r in results]
            try:
                preds = np.empty(0, np.int8)
                if all_results:
                    self.device_calls += 1
                    preds = self._predict(all_results)
            except Exception as exc:  # deliver to every waiter
                for _, back in batch:
                    back.put(exc)
                continue
            off = 0
            for results, back in batch:
                n = int(sum(r.n_aligned for r in results))
                back.put(preds[off : off + n])
                off += n


class DetectService:
    """Holds the warm model + aligner; concurrent requests coalesce
    their device work into shared batches (_DeviceCoalescer)."""

    def __init__(self, ref: str, model_path: str, base: str = "C",
                 align_str: str = "builtin", fnum: int = 7,
                 window_size: int = 21, precision: str = "bf16",
                 threads: int = 1, basecalls: str = "",
                 device: str = "cuda"):
        import dataclasses

        import torch

        from deepmod_tpu_torch.engine.detect import (
            WindowPredictor,
            predict_batch_windows,
        )
        from deepmod_tpu_torch.engine.host_worker import (
            HostOptions,
            init_worker,
        )
        from deepmod_tpu_torch.models.tf_import import load_model

        self.base = base
        params, model_config = load_model(model_path)
        model_config = dataclasses.replace(model_config, timesteps=window_size)
        # bf16 by default, as detect
        self.predictor = WindowPredictor(params, model_config, device=device,
                                         precision=precision)
        self.model_path = model_path
        self.backend = self.predictor.device.type
        self.device_name = (torch.cuda.get_device_name(self.predictor.device)
                            if self.backend == "cuda" else "cpu")
        self._host_opts = HostOptions(
            ref=ref, align_str=align_str, fnum=fnum, window_size=window_size,
            base=base, con_unk=True, regions=((None, None, None),),
            basecall_1d="Basecall_1D_000",
            basecall_2strand="BaseCalled_template",
            signal_group="simple", move=False,
            basecalls=basecalls,
        )
        init_worker(self._host_opts)  # builds reference + aligner index
        # threads>1: a persistent HostPool runs each request's host stage
        # over warm spawn workers (the aligner index is built once a
        # worker, at pool start)
        self._pool = None
        if threads > 1:
            from deepmod_tpu_torch.engine.host_pool import HostPool

            self._pool = HostPool(threads, self._host_opts)
        # the host stage shares one pool / one in-process aligner: it is
        # single-flight; the DEVICE stage coalesces across requests
        self._host_lock = threading.Lock()
        self._coalescer = _DeviceCoalescer(
            lambda results: predict_batch_windows(results, self.predictor))

    def close(self) -> None:
        self._coalescer.close()
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _host_stage(self, paths):
        """Ingest+align+featurize, through the pool when one exists."""
        from deepmod_tpu_torch.engine.host_worker import host_process_files

        if self._pool is None:
            return host_process_files(paths)
        n = min(len(self._pool._procs), max(1, len(paths)))
        chunks = [paths[i::n] for i in range(n)]
        order = [self._pool.submit_ingest_return(chunk) for chunk in chunks]
        by_bid = {}
        merged_errors: dict = {}
        pending = len(chunks)
        while pending:
            msg = self._pool.next_message()
            if msg[0] == "results":
                _, wid, bid, results, errors = msg
                by_bid[bid] = results
                for k, v in errors.items():
                    merged_errors.setdefault(k, []).extend(v)
                pending -= 1
            elif msg[0] == "error":
                _, wid, bid, phase, message = msg
                merged_errors.setdefault(
                    f"Batch worker failed: {message.split(':')[0]}", []
                ).append(f"batch_{bid}")
                pending -= 1
        results = [r for bid in order for r in by_bid.get(bid, [])]
        return results, merged_errors

    def detect(self, fast5_paths):
        with self._host_lock:
            results, errors = self._host_stage(list(fast5_paths))
        reads_out = []
        positions = {}
        if results:
            import numpy as np

            # the device stage of the detect engine, through the
            # cross-request coalescer
            preds = self._coalescer.classify(results)
            off = 0
            for r in results:
                p = preds[off : off + r.n_aligned]
                off += r.n_aligned
                nongap = np.flatnonzero(r.base_map["readbase"] != "-")
                r.base_map["mod_pred"][nongap[p == 1]] = 1
                bm = r.base_map
                sel = (bm["refbase"] == self.base) & (bm["readbase"] != "-")
                for pos, mod in zip(
                    bm["refbasei"][sel].astype(int),
                    bm["mod_pred"][sel].astype(int),
                ):
                    key = (r.rname, r.strand, int(pos))
                    cov, m = positions.get(key, (0, 0))
                    positions[key] = (cov + 1, m + (1 if mod == 1 else 0))
                reads_out.append(
                    {
                        "read_id": r.read_id,
                        "chrom": r.rname,
                        "strand": r.strand,
                        "pos0": r.pos0,
                        "n_aligned": int(r.n_aligned),
                        "pred_mod_num": int((p == 1).sum()),
                    }
                )
        return {
            "reads": reads_out,
            "positions": [
                [c, s, p, cov, mod]
                for (c, s, p), (cov, mod) in sorted(positions.items())
            ],
            "errors": errors,
        }


def make_handler(service: DetectService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "model": service.model_path,
                    "backend": service.backend,
                    "device": service.device_name,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                request = json.loads(self.rfile.read(length) or b"{}")
                paths = request.get("fast5", [])
                if not isinstance(paths, list) or not paths:
                    self._send(400, {"error": "body must carry a non-empty 'fast5' list"})
                    return
                self._send(200, service.detect(paths))
            except Exception as exc:  # noqa: BLE001 - report, never crash
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def serve(ref: str, model_path: str, port: int = 8765, host: str = "127.0.0.1",
          base: str = "C", align_str: str = "builtin",
          precision: str = "bf16", threads: int = 1,
          basecalls: str = "", device: str = "cuda") -> ThreadingHTTPServer:
    """Build the warm service and return a ready (unstarted) HTTP server;
    ``server.dmt_service.close()`` stops its dispatcher and host pool."""
    service = DetectService(ref, model_path, base=base, align_str=align_str,
                            precision=precision, threads=threads,
                            basecalls=basecalls, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.dmt_service = service
    return server


def main(argv: Optional[list] = None) -> int:
    """``python -m deepmod_tpu_torch serve``'s flags (cli.py)."""
    import sys

    from deepmod_tpu_torch.cli import main as cli_main

    return cli_main(["serve", *(sys.argv[1:] if argv is None else argv)])
