"""Serving latency: warm ``DetectService`` request round trips on the card.

    python -m deepmod_tpu_torch.tools.probe_serve_latency [--requests 20]
        [--dataset DIR [--modfile M]] [--precision bf16] [--device cuda]

Counterpart of ``scripts/probe_serve_latency.py``. The service is built in
process (the model and the aligner index once, the predictor warm) over
pod5 requests, through ``--basecalls`` (the card's machine has no h5py).
Without ``--dataset`` it simulates 16 reads of 5-10 kb, one a pod5 file,
with a random full-width model; with it, DIR holds ``ref.fa``,
``calls.bam`` and ``pod5/*.pod5`` (as ``synth --pod5`` writes them) and
the model is ``--modfile`` (default ``DIR/model.npz``; a TF1 checkpoint
prefix works too).

Prints the host's core count and the card's ``nvidia-smi`` line, then one
JSON line a row:

- serial requests of 1 and of 8 files: p50 / p95 / best ms, the reads and
  windows of a request, the device calls a request;
- 1, 4 and 8 concurrent clients, each sending one 1-file request at once,
  with the coalescer on and off (``DMT_SERVE_COALESCE``): p50 / p95 ms and
  the device calls a request;

and last a summary line with all rows. Request times are host clock
around ``DetectService.detect``, which returns after the predictions are
back on the host. The HTTP layer is left out (``tests/test_torch_serve.py``
covers it).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _host_bench

SERIAL_FILES = (1, 8)
CLIENTS = (1, 4, 8)


def _ms(lat: list) -> dict:
    p50, p95 = np.percentile(np.asarray(lat) * 1e3, [50, 95])
    return {"p50_ms": float(p50), "p95_ms": float(p95),
            "best_ms": float(min(lat) * 1e3)}


def _serial(svc, files: list, requests: int) -> dict:
    svc.detect(files)  # warm
    calls0 = svc._coalescer.device_calls
    lat = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = svc.detect(files)
        lat.append(time.perf_counter() - t0)
    return dict(
        _ms(lat), files_per_request=len(files),
        reads_per_request=len(out["reads"]),
        windows_per_request=sum(r["n_aligned"] for r in out["reads"]),
        device_calls_per_request=(svc._coalescer.device_calls - calls0)
        / requests)


def _concurrent(svc, files: list, clients: int, requests: int) -> dict:
    paths = [files[i % len(files)] for i in range(clients)]
    svc.detect(paths[:1])  # warm
    calls0 = svc._coalescer.device_calls
    lat = []
    for _ in range(requests):
        per = [0.0] * clients
        barrier = threading.Barrier(clients)

        def hit(i):
            barrier.wait()
            t0 = time.perf_counter()
            svc.detect([paths[i]])
            per[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lat.extend(per)
    return dict(_ms(lat), device_calls_per_request=(
        svc._coalescer.device_calls - calls0) / (requests * clients))


def run(dataset: str, modfile: str, requests: int = 20,
        precision: str = "bf16", device: str = "cuda") -> dict:
    """Build the service over ``dataset`` and print / return every row."""
    from deepmod_tpu_torch.serve import DetectService

    files = sorted(glob.glob(os.path.join(dataset, "pod5", "*.pod5")))
    if len(files) < max(SERIAL_FILES):
        raise ValueError(f"{dataset}/pod5 holds {len(files)} pod5 files; "
                         f"the probe needs {max(SERIAL_FILES)}")
    t0 = time.perf_counter()
    svc = DetectService(
        os.path.join(dataset, "ref.fa"), modfile, align_str="builtin",
        precision=precision, basecalls=os.path.join(dataset, "calls.bam"),
        device=device)
    startup_s = time.perf_counter() - t0
    before = os.environ.get("DMT_SERVE_COALESCE")
    rows, conc = [], []
    try:
        for n in SERIAL_FILES:
            rows.append(_serial(svc, files[:n], requests))
            print(json.dumps(rows[-1]), flush=True)
        for clients in CLIENTS:
            for coalesce in (True, False):
                os.environ["DMT_SERVE_COALESCE"] = "1" if coalesce else "0"
                conc.append(dict(
                    _concurrent(svc, files, clients, requests),
                    concurrent_clients=clients, coalesce=coalesce))
                print(json.dumps(conc[-1]), flush=True)
    finally:
        if before is None:
            os.environ.pop("DMT_SERVE_COALESCE", None)
        else:
            os.environ["DMT_SERVE_COALESCE"] = before
        svc.close()
    out = {"metric": "serve_request_latency", "backend": svc.backend,
           "device": svc.device_name, "precision": precision,
           "requests": requests, "service_startup_s": startup_s,
           "rows": rows, "concurrent": conc}
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_serve_latency",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--modfile", default=None)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    print(_host_bench.machine_line(), flush=True)
    work = None
    try:
        dataset = args.dataset
        modfile = args.modfile
        if dataset is None:
            from deepmod_tpu_torch.models.bilstm import (
                BiLSTMConfig,
                init_bilstm_params,
            )
            from deepmod_tpu_torch.models.tf_import import save_bilstm_npz

            dataset = work = tempfile.mkdtemp(prefix="dmt_serve_probe_")
            _host_bench.write_dataset(
                work, "pod5", n_files=16, num_reads=16,
                read_length=(5000, 10000), genome_sizes={"chrS": 100_000},
                seed=7)
            config = BiLSTMConfig()
            save_bilstm_npz(os.path.join(work, "model.npz"),
                            init_bilstm_params(0, config, device="cpu"),
                            config)
        run(dataset, modfile or os.path.join(dataset, "model.npz"),
            args.requests, args.precision, args.device)
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
