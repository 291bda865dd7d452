"""detect_transfer_bytes_per_window (B/window, program counter):
``WindowPredictor.transfer_bytes`` (host-to-device payload) over the
window, per window asked for. Layer: the engine's device stage."""


def read(m):
    if m.kind != "detect" or not m.work or "transfer_bytes" not in m.counters:
        return None
    return m.counters["transfer_bytes"] / m.work
