"""What a ``torch.profiler`` chrome trace says about a traced span.

A host span's window is its ``bench.window`` annotation (it closes after
a device synchronise). A device span holds no host events: its window is
the span's length on the host clock, given by the caller, between two
synchronises, so every device event of the trace lies inside it. Device
activity is the union of the card's kernel, copy and set intervals in
the window: the reader of ``_host_bench.trace_idle_share`` in the
program's tools, copied here and clipped to the window.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that say what the host was doing
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
BREAKDOWN_ROWS = 10


def kernel_base(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    and parameters: ``void (anonymous namespace)::train_fwd_kernel<2, 2,
    float>(...)`` -> ``train_fwd_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """The traced window of one span (times in microseconds); a device
    span's ``window_s`` is given, a host span's is its annotation."""

    def __init__(self, events: List[Dict], window_s: Optional[float] = None):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        if window_s is None:
            marks = [e for e in events if e.get("name") == WINDOW
                     and e.get("cat") == "user_annotation"]
            if not marks:
                raise ValueError(f"trace holds no {WINDOW!r} annotation")
            self.t0 = float(marks[0]["ts"])
            self.t1 = self.t0 + float(marks[0]["dur"])
        else:
            starts = [float(e["ts"]) for e in events
                      if e.get("cat") in DEVICE_CATS]
            self.t0 = min(starts, default=0.0)
            self.t1 = self.t0 + window_s * 1e6
        self.device: List[Tuple[float, float, str, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            a, b = max(a, self.t0), min(b, self.t1)
            if e.get("cat") in DEVICE_CATS:
                self.device.append((a, b, str(e.get("name")), e["cat"]))
            elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
                self.host.append((a, b, str(e.get("name"))))
        self.busy = _merge((a, b) for a, b, _, _ in self.device)

    @classmethod
    def load(cls, path: str, window_s: Optional[float] = None) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []), window_s)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self, names: Optional[Iterable[str]] = None):
        """The kernel intervals, of the given base names only if named."""
        keep = None if names is None else set(names)
        return [(a, b, n) for a, b, n, cat in self.device if cat == "kernel"
                and (keep is None or kernel_base(n) in keep)]

    def kernel_seconds(self, names: Iterable[str]) -> float:
        return sum(b - a for a, b, _ in self.kernels(names)) / 1e6

    def device_ops(self) -> List[List]:
        """[base name, seconds] of the device operations that took most
        time in the window."""
        total: Dict[str, float] = defaultdict(float)
        for a, b, n, cat in self.device:
            total[kernel_base(n) if cat == "kernel" else n] += (b - a) / 1e6
        rows = sorted(total.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in rows[:BREAKDOWN_ROWS]]

    def idle_gaps(self) -> List[List]:
        """[host activity, seconds] of the device's idle time in the
        window, each gap named by the innermost host event running at its
        middle ("host, no traced call" where none is), summed by name."""
        gaps = []
        end = self.t0
        for a, b in self.busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = sorted(self.host)
        total: Dict[str, float] = defaultdict(float)
        active: List[Tuple[float, float, str]] = []  # (end, length, name)
        j = 0
        for a, b in gaps:  # in time order: sweep the host events once
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                ha, hb, name = host[j]
                active.append((hb, hb - ha, name))
                j += 1
            active = [x for x in active if x[0] >= mid]
            name = min(active, key=lambda x: x[1])[2] if active else (
                "host, no traced call")
            total[name] += (b - a) / 1e6
        rows = sorted(total.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in rows[:BREAKDOWN_ROWS]]
