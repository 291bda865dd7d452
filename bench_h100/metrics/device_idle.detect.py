"""device_idle.detect (%, device trace): the share of the window in which
the card idles, in a detect cell: 1 - the device's busy seconds a unit of work
(the union of kernel, copy and set intervals in the device span, over
the work it did) times the window's work, over the window's seconds. The
device span traces the card alone, and a batch's device time does not
change under it; its own length does, since the profiler slows every
launch, so the span's idle share (the line's ``busy_s`` and
``window_s``) reads high where launches are many."""


def read(m):
    if (m.kind != "detect" or m.trace is None or not m.traced_work
            or not m.window_s):
        return None
    busy = m.trace.busy_s / m.traced_work * m.work
    return 100.0 * (1.0 - busy / m.window_s)
