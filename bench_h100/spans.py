"""What the program's own spans say in a traced run's host span
(``window.Measurement.host_trace``): the ``record_function`` annotations
that ``deepmod_tpu_torch.utils.profiling.span`` makes while a profiler
records. A program without them gives nothing to read: None, never an
error."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

BATCH = "device_inference"   # detect's batch span
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # host launch calls


def _host(m) -> List[Tuple[float, float, str]]:
    trace = getattr(m, "host_trace", None)
    return trace.host if trace is not None else []


def per_batch_ms(m, names: Iterable[str]) -> Optional[float]:
    """The seconds of the spans named ``names`` a detect batch span, in
    ms; None in a run whose host span holds no batch span."""
    names = set(names)
    events = _host(m)
    batches = sum(1 for _, _, n in events if n == BATCH)
    if m.kind != "detect" or not batches:
        return None
    return sum(b - a for a, b, n in events if n in names) / 1e3 / batches


def launches_per_span(m, name: str) -> Optional[float]:
    """The host's kernel launch calls inside the spans named ``name``, over
    the count of those spans; None where the host span holds no such span
    or no launch at all (the CPU)."""
    events = _host(m)
    spans = [(a, b) for a, b, n in events if n == name]
    starts = sorted(a for a, _, n in events if n.startswith(LAUNCHES))
    if not spans or not starts:
        return None
    inside = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in spans)
    return inside / len(spans)
