"""Stage timing.

The reference scatters elapsed-time prints behind outLevel checks
(myDetect.py:349-384, 395-465, 982; myMultiBiRNN.py:119-121). Here a
StageTimer accumulates per-stage wall time centrally.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulates wall time per named stage; cheap enough to always run."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.totals.values())
        lines = [f"stage timing (total {total:.2f}s):"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            frac = t / total if total else 0.0
            lines.append(
                f"  {name:<24s} {t:8.2f}s  {100 * frac:5.1f}%  "
                f"x{self.counts[name]}"
            )
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)

