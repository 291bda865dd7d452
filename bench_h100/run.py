"""Run one cell of the benchmark of ``deepmod_tpu_torch`` and print its
result line.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the traffic's ``kind`` picks the job
(``jobs/detect.py``, ``jobs/train.py``), which sets up from the seed,
measures for ``--seconds`` and checks what the window produced against the
plain reference. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones (the window,
then two spans under ``torch.profiler``, ``window.py``). The last line of standard output
is one JSON object; the compared numbers and their limits are also the
last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, the run
prints no result and exits with 2; with ``jax``, ``jaxlib``, ``flax`` or
``deepmod_tpu`` loaded once the window has closed, with 3.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    # the checkout: this package and the program beside it
    sys.path.insert(0, os.path.dirname(HERE))

from bench_h100.registry import CHECKOUT, Registry  # noqa: E402

# whole top-level module names a run may not load (deepmod_tpu_torch
# begins with deepmod_tpu, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepmod_tpu")
# torch's intra-op threads on the host. One: on the card's 8 shared
# cores, detect_f7_bf16_long ran as fast on one as on four and eight, and
# steadily (535 and 532 batches in 20 s against 462-538 on four)
HOST_THREADS = 1


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return (out.stdout.strip().splitlines() or ["not read"])[0]
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def window_line(m) -> str:
    """What the window did, for the record: iterations, their host-clock
    times, the process's CPU seconds and page faults."""
    times = sorted(b - a for a, b, _ in m.records)
    pick = [times[0], times[len(times) // 2],
            times[max(0, -(-len(times) * 95 // 100) - 1)], times[-1]]
    return (f"window: {m.iters} iterations, work {m.work} in "
            f"{m.window_s:.4f} s; after it, device span {m.traced_iters} "
            f"iterations in {m.traced_s:.4f} s, spans {m.span_iters} "
            f"iterations, profilers' starts, stops and exports "
            f"{m.trace_stall_s:.4f} s; set-up {m.setup_s:.3f} s "
            f"after {m.reference_setup_s:.3f} s for the reference left out; "
            f"reference check {m.counters.get('reference_s', 0.0):.3f} s; "
            f"iteration ms min/median/p95/max "
            f"{'/'.join(f'{t * 1e3:.3f}' for t in pick)}; process CPU user "
            f"{m.counters.get('host_user_s', 0.0):.3f} s, system "
            f"{m.counters.get('host_sys_s', 0.0):.3f} s, minor faults "
            f"{m.counters.get('host_minor_faults', 0):.0f}")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: str = CHECKOUT, device=None) -> int:
    """Run a cell; ``device`` set (``"cpu"``) skips the look for a card,
    for the harness's own tests."""
    args = parse(argv)
    # the program under test: without it beside the benchmark, no result
    importlib.import_module("deepmod_tpu_torch")
    reg = Registry(root)
    cell = reg.cell(args.workload)
    import torch

    on_card = device is None
    if on_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"bench_h100: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); torch.cuda.is_available()="
                  f"{torch.cuda.is_available()}, device_count()={have}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    torch.set_num_threads(HOST_THREADS)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    job = importlib.import_module(f"bench_h100.jobs.{traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench_h100_") as tmp:
        path = os.path.join(tmp, "trace.json")
        m, checks, failed = job.run(
            cfg, traffic, args.seed, args.seconds, bool(args.trace), device,
            path)
        if args.trace:
            from bench_h100.trace import Trace
            from bench_h100.window import host_trace_path

            m.trace = Trace.load(path, m.traced_s)
            if os.path.exists(host_trace_path(path)):
                m.host_trace = Trace.load(host_trace_path(path))
    metrics = {}
    for spec in reg.metrics(cell["name"], per_layer=bool(args.trace)):
        value = reg.reader(spec["name"])(m)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"bench_h100: modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0,
           "memory_peak_bytes": int(m.counters["memory_peak_bytes"]),
           "power_limit": card_line() if on_card else "none"}
    result = {"correct": correct, "attempted": m.iters + m.span_iters,
              "failed": failed,
              "metrics": metrics, "device": dev}
    if m.trace is not None:
        dev["busy_s"] = m.trace.busy_s
        dev["window_s"] = m.trace.window_s
        result["breakdown"] = {"device_ops": m.trace.device_ops()}
        if m.host_trace is not None:
            result["breakdown"]["idle_gaps"] = m.host_trace.idle_gaps()
    result["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    print(window_line(m), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
