"""The measured window, the same for every job.

The window runs one iteration (a batch, a step) after another until
``seconds`` have passed, then synchronises the device: a rate is taken
over all the work and all the time of it. No profiler runs in it.

With ``trace``, two spans follow the window under ``torch.profiler``,
each opened and closed on a synchronised device:

- the device span (``TRACE_SPAN_S``): the card's activity alone (CUDA,
  no host events); the kernels' times, the launches and the busy share
  come from it;
- the host span (``HOST_SPAN_S``): host and card, inside a
  ``bench.window`` annotation, which names what the host was doing while
  the card idled (the breakdown's ``idle_gaps``).

Each span lasts at least ``TRACE_MIN_ITERS`` iterations. The host-clock
per-layer metrics of a traced run are read over its window, which no
profiler slowed: a profiler slows every launch while it traces, and a
train step's launches stayed slower after it had stopped. A trace of the
whole window would hold hundreds of thousands of events at a train
step's launch rate, more than a run can export and read in its time.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import resource
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

TRACE_SPAN_S = 2.0
HOST_SPAN_S = 1.0
TRACE_MIN_ITERS = 2


def process_age() -> float:
    """Seconds since this process started (Linux's /proc; the interpreter's
    own start-up included)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - started


@dataclasses.dataclass
class Measurement:
    """What a run measured; the metric readers read it."""

    kind: str
    config: Dict
    traffic: Dict
    setup_s: float = 0.0
    # seconds of set-up spent on the reference's behalf (left out of
    # setup_s)
    reference_setup_s: float = 0.0
    # (start, end, work) an iteration, host clock; a train step's end is
    # when it was enqueued
    records: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None       # the device span's Trace
    host_trace: Optional[object] = None  # the host span's Trace
    # the device span after the window: its iterations, their work and
    # its seconds
    traced_iters: int = 0
    traced_work: int = 0
    traced_s: float = 0.0
    # iterations the spans ran, and the seconds their profilers took to
    # start, stop and export
    span_iters: int = 0
    trace_stall_s: float = 0.0

    @property
    def work(self) -> int:
        return sum(w for _, _, w in self.records)

    @property
    def iters(self) -> int:
        return len(self.records)


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def load_kernels(device) -> None:
    """Build the program's kernel library, or load it from the checkout's
    ``build/kernels/<hash>/`` (set-up; the first run in a checkout builds)."""
    if on_card(device):
        from deepmod_tpu_torch.ops import _build

        _build.library()


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Start the device-memory peak afresh: the inputs' generation, which
    the benchmark does on the card, stays out of it; what it leaves
    allocated stays in."""
    if on_card(device):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    """The process's peak of device memory so far (0 on the CPU)."""
    return int(torch.cuda.max_memory_allocated(device)) if on_card(device) else 0


def free(device) -> None:
    """Give back what the program held before the reference runs."""
    if on_card(device):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def host_trace_path(trace_path: str) -> str:
    """Where the host span's trace goes, beside the device span's."""
    root, ext = os.path.splitext(trace_path)
    return f"{root}.host{ext}"


def measure(m: Measurement, one: Callable[[], int], seconds: float,
            trace: bool, device, label: str, trace_path: str = "",
            on_close: Optional[Callable[[], None]] = None) -> None:
    """Run ``one`` (returns the work it did) for ``seconds`` into ``m``,
    then ``on_close`` (the job reads its counters over the window); with
    ``trace``, then run the device span, exported to ``trace_path``, and
    the host span, exported to ``host_trace_path(trace_path)``."""
    from torch.autograd.profiler import record_function

    # set-up's objects (the pool, the feed) out of the collector's way,
    # before the window opens
    gc.collect()
    gc.freeze()
    m.setup_s = process_age() - m.reference_setup_s
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        work = one()
        t1 = time.perf_counter()
        m.records.append((t0, t1, work))
        if t1 - start >= seconds:
            break
    sync(device)
    m.window_s = time.perf_counter() - start
    if on_close is not None:
        on_close()
    use = resource.getrusage(resource.RUSAGE_SELF)
    m.counters["host_user_s"] = use.ru_utime - use0.ru_utime
    m.counters["host_sys_s"] = use.ru_stime - use0.ru_stime
    m.counters["host_minor_faults"] = use.ru_minflt - use0.ru_minflt
    gc.unfreeze()
    if not trace:
        return

    import warnings

    from torch.profiler import ProfilerActivity, profile

    # one start and one stop a span: no cycles whose events could be cleared
    warnings.filterwarnings("ignore", message=".*clears events at the end")
    card = [ProfilerActivity.CUDA] if on_card(device) else []
    spans = [("device", card or [ProfilerActivity.CPU], TRACE_SPAN_S,
              trace_path),
             ("host", [ProfilerActivity.CPU] + card, HOST_SPAN_S,
              host_trace_path(trace_path))]
    for name, acts, span_s, path in spans:
        sync(device)
        paused = time.perf_counter()
        prof = profile(activities=acts)
        prof.start()
        mark = None
        if name == "host":
            mark = record_function("bench.window")
            mark.__enter__()
        t_open = time.perf_counter()
        m.trace_stall_s += t_open - paused
        iters = work = 0
        while True:
            if name == "host":
                with record_function(label):
                    work += one()
            else:
                work += one()
            iters += 1
            if (time.perf_counter() - t_open >= span_s
                    and iters >= TRACE_MIN_ITERS):
                break
        sync(device)
        t_close = time.perf_counter()
        if mark is not None:
            mark.__exit__(None, None, None)
        prof.stop()
        prof.export_chrome_trace(path)
        m.trace_stall_s += time.perf_counter() - t_close
        m.span_iters += iters
        if name == "device":
            m.traced_iters, m.traced_work = iters, work
            m.traced_s = t_close - t_open
