"""detect_windows_run_per_asked (windows/window, program counter): the
windows K1 ran (``detect.windows_run``: every chunk's, pad rows and the
bucket's tail included) over the windows detect asked for
(``detect.windows_asked``), from the program's counters
(``deepmod_tpu_torch.utils.profiling.counters``), which advance only
while a profiler records: the traced spans after the window."""


def read(m):
    if m.kind != "detect":
        return None
    from deepmod_tpu_torch.utils import profiling

    # a program older than its counters reads None, as the span readers do
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    now = counters()
    asked = now.get("detect.windows_asked", 0)
    return now.get("detect.windows_run", 0) / asked if asked else None
