"""k2_roofline (%, device trace): the least time the forward cone of the
traced samples could take (``cone_flops``, ``k2_bytes``, fp32 peak) over
K2's summed device time (``train_fwd_kernel``, ``csrc/bilstm_train.cu``)."""

from bench_h100 import yardstick

K2 = ("train_fwd_kernel",)


def read(m):
    if m.kind != "train" or m.trace is None or not m.traced_work:
        return None
    busy = m.trace.kernel_seconds(K2)
    if busy <= 0:
        return None
    least, _ = yardstick.least_seconds(
        yardstick.cone_flops(m.config) * m.traced_work,
        yardstick.k2_bytes(m.config, m.traced_work), "fp32")
    return 100.0 * least / busy
