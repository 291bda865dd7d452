"""detect_batch_p95_ms.host (ms, host clock): the 95th percentile (nearest
rank) of one ``predict_batch_windows`` call, from hand-off to predictions
on the host, over the window's batches (a traced run reports it; no
profiler runs in the window). The per-layer form of
``detect_batch_p95_ms``: the engine's host side sets the pace of a
detect batch, and the host's speed, shared with other machines, moves a
tail more than a bound can hold."""

import math


def read(m):
    if m.kind != "detect" or not m.records:
        return None
    times = sorted(b - a for a, b, _ in m.records)
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3
