"""detect_mfu (%, host clock): the FLOP the windows asked for need (the
readout cone and the projection, ``yardstick.detect_flops``) over the
window's seconds, as a share of the published peak of the configuration's
precision (bf16 989, fp32 67 TFLOP/s). A traced run reports it over its
window, which no profiler slows (the spans come after it)."""

from bench_h100 import yardstick


def read(m):
    if m.kind != "detect" or not m.window_s:
        return None
    rate = yardstick.detect_flops(m.config) * m.work / m.window_s
    return 100.0 * rate / yardstick.PEAK_OPS[m.config["precision"]]
