"""train_mfu (%, host clock): the FLOP the samples stepped need (the
forward cone and projection, their backward dX and dW products,
``yardstick.train_flops``) over the window's seconds, as a share of the
fp32 peak (67 TFLOP/s: both train kernels run fp32 on the CUDA cores). A
traced run reports it over its window, which no profiler slows (the
spans come after it)."""

from bench_h100 import yardstick


def read(m):
    if m.kind != "train" or not m.window_s:
        return None
    rate = yardstick.train_flops(m.config) * m.work / m.window_s
    return 100.0 * rate / yardstick.PEAK_OPS["fp32"]
