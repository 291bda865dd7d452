"""What ``bench_host``, ``bench_e2e`` and ``chip_smoke.py`` share: the
machine line, the synthetic datasets they time and the card's idle share
in a detect trace."""

from __future__ import annotations

import json
import os
import subprocess


def machine_line() -> str:
    """The host's core count and the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (or why there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        smi = (out.stdout.strip().splitlines() or ["no GPU"])[0]
    except (OSError, subprocess.TimeoutExpired):
        smi = "no nvidia-smi"
    return f"os.cpu_count()={os.cpu_count()} | nvidia-smi: {smi}"


def default_format() -> str:
    """fast5 where h5py is importable (the native fast5 reader needs its
    libhdf5), else pod5 + basecall BAM."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "pod5"
    return "fast5"


def write_dataset(work: str, fmt: str, n_files: int = 1, **synth) -> str:
    """Simulate a dataset under ``work``; returns the folder detect reads:
    ``work/fast5`` (the synthetic generator's default albacore-v2 event
    tables, one read a file) or ``work/pod5`` (move tables, with
    ``work/calls.bam``; ``n_files`` spreads the reads over that many
    files)."""
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        generate_dataset,
        write_move_dataset_pod5,
    )

    if fmt == "pod5":
        write_move_dataset_pod5(work, SynthConfig(fast5_style="move", **synth),
                                n_files=n_files)
        return os.path.join(work, "pod5")
    if fmt != "fast5":
        raise ValueError(f"format {fmt!r}: expected fast5 or pod5")
    generate_dataset(work, SynthConfig(**synth))
    return os.path.join(work, "fast5")


def trace_idle_share(path: str) -> tuple:
    """(device busy seconds, span seconds, idle share) of a torch.profiler
    chrome trace: the union of the card's kernel, copy and set intervals
    over the span of every event in the trace."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    span = hi - lo
    return busy / 1e6, span / 1e6, 1.0 - busy / span if span else 1.0
