"""detect_windows_per_s (windows/s, host clock): the windows detect asked
to classify (every aligned event of every read of every batch) over the
whole window's seconds; the window ends on a synchronised device."""


def read(m):
    if m.kind != "detect" or not m.window_s:
        return None
    return m.work / m.window_s
