"""Stage timing, and the program's spans and counters.

The reference scatters elapsed-time prints behind outLevel checks
(myDetect.py:349-384, 395-465, 982; myMultiBiRNN.py:119-121). Here a
StageTimer accumulates per-stage wall time centrally.

``span`` and ``count`` mark the program's layers for a ``torch.profiler``
run (the benchmark's traced spans, ``detect --trace``): while a profiler
records in this thread, a span is a ``record_function`` annotation, on
the profiler's clock beside the card's kernel and copy events, and a
counter advances; while none records, each costs one check of the
profiler's state. Spans live in the profiler's trace and are written by
its own export. Their names carry no ids: a batch's spans are tied
together by nesting inside its batch span.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import ContextManager, Dict, Optional

from torch.autograd import _profiler_enabled as _recording
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
# process-wide counters; they advance only while a profiler records
_COUNTS: Dict[str, int] = defaultdict(int)


class StageTimer:
    """Accumulates wall time per named stage; cheap enough to always run."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


def span(name: str, timer: Optional[StageTimer] = None) -> ContextManager:
    """A context manager around one piece of a layer: a ``record_function``
    named ``name`` while a profiler records, nothing otherwise; with a
    ``timer``, its host-clock seconds are also added to ``name`` there."""
    on = _recording()
    if timer is None:
        return record_function(name) if on else _OFF
    return _timed(name, timer, record_function(name) if on else _OFF)


@contextlib.contextmanager
def _timed(name: str, timer: StageTimer, mark: ContextManager):
    with mark:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            timer.add(name, time.perf_counter() - t0)


def count(name: str, n: int = 1) -> None:
    """Advance the counter ``name`` by ``n`` while a profiler records."""
    if _recording():
        _COUNTS[name] += int(n)


def counters() -> Dict[str, int]:
    """A snapshot of the counters."""
    return dict(_COUNTS)
