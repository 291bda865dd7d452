"""Same-process A/B: host ``np.bincount`` against the device reduction
``parallel.aggregation.sharded_position_counts`` over a mesh.

    python -m deepmod_tpu_torch.tools.probe_device_agg [--cpu-mesh N]
        [--reps 5] [--cases 100000:1000000,...]

Counterpart of ``scripts/probe_device_agg.py``, the data behind
``DetectConfig.device_aggregation``'s default (off). Per detect batch the
engine turns (position, covered, mod) observations into dense per-(chr,
strand) count vectors, either

  host:   ``np.bincount`` into the numpy vectors (no device traffic), or
  device: ``index_add_`` a shard and the sum over the mesh's local shards
          (``sharded_position_counts``), then one device->host copy of
          the two vectors.

The mesh is every visible card, or with ``--cpu-mesh N`` the CPU named N
times (JAX's N virtual CPU devices). The two run in turns in one process;
each case's counts must be equal (checked, a mismatch exits non-zero).
Times: the host clock around each, the cards synchronized. Prints a JSON
line a case (the medians) and a summary line. ``--cases`` lists
``observations:chromosome length`` pairs (default the JAX probe's: a
1,000-file batch carries ~1-5 M target-base observations; E. coli's
chromosome is 4.6 Mbp).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.tools import _probe

CASES = "100000:1000000,1000000:1000000,1000000:4600000,4000000:4600000"


def observations(rng: np.random.Generator, n_obs: int, length: int,
                 n_dev: int):
    """(positions, covered, modded): ``n_obs`` observations padded to a
    multiple of the shard count, 30% modified, all covered."""
    n_pad = n_obs + ((-n_obs) % n_dev)
    pos = rng.integers(0, length, n_pad).astype(np.int64)
    mod = (rng.random(n_pad) < 0.3).astype(np.int64)
    return pos, np.ones(n_pad, np.int64), mod


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_device_agg",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="a mesh naming the CPU N times")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", default=CASES,
                    help="comma-separated observations:length pairs")
    args = ap.parse_args(argv)

    from deepmod_tpu_torch.parallel.aggregation import sharded_position_counts
    from deepmod_tpu_torch.parallel.mesh import make_mesh

    mesh = (make_mesh(devices=["cpu"] * args.cpu_mesh) if args.cpu_mesh
            else make_mesh())
    n_dev = mesh.local_size
    home = mesh.devices[0]
    print(_probe.header(f"{n_dev} x {home}"), flush=True)
    rng = np.random.default_rng(0)

    def on_device(pos, cov, mod, length):
        c, m = sharded_position_counts(mesh, pos, cov, mod, length)
        return c.cpu().numpy(), m.cpu().numpy()

    def timed(fn):
        for dev in set(mesh.devices):
            _probe.sync(dev)
        t0 = time.perf_counter()
        out = fn()
        for dev in set(mesh.devices):
            _probe.sync(dev)
        return out, time.perf_counter() - t0

    rows = []
    for case in args.cases.split(","):
        n_obs, length = (int(v) for v in case.split(":"))
        pos, covered, mod = observations(rng, n_obs, length, n_dev)
        host_cov = np.zeros(length, np.int64)
        host_mod = np.zeros(length, np.int64)
        dev_cov = np.zeros(length, np.int64)
        dev_mod = np.zeros(length, np.int64)
        on_device(pos, covered, mod, length)  # warm-up
        t_host, t_dev = [], []
        for _ in range(args.reps):
            _, dt = timed(lambda: (
                np.add(host_cov, np.bincount(pos, weights=covered,
                                             minlength=length)
                       .astype(np.int64), out=host_cov),
                np.add(host_mod, np.bincount(pos, weights=mod,
                                             minlength=length)
                       .astype(np.int64), out=host_mod)))
            t_host.append(dt)
            (c, m), dt = timed(lambda: on_device(pos, covered, mod, length))
            dev_cov += c
            dev_mod += m
            t_dev.append(dt)
        if not (np.array_equal(host_cov, dev_cov)
                and np.array_equal(host_mod, dev_mod)):
            raise SystemExit(f"case {case}: device counts differ from "
                             "the host's")
        rows.append({
            "n_obs": n_obs, "chrom_len": length,
            "host_ms": 1e3 * float(np.median(t_host)),
            "device_ms": 1e3 * float(np.median(t_dev)),
            "device_over_host": float(np.median(t_dev))
            / float(np.median(t_host)),
            "counts_equal": True,
        })
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "metric": "device_aggregation_ab", "backend": home.type,
        "devices": n_dev, "rows": rows,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
