"""k3_roofline (%, device trace): the least time the backward's dX and dW
products of the traced samples could take (``backward_flops``,
``k3_bytes``, fp32 peak) over the summed device time of K3's kernels
(``rows_kernel``, ``train_bwd_kernel``, ``gemm_kernel`` for the gate, dx
and dW products, ``sum_splits_kernel``; ``csrc/bilstm_train.cu``). K3's
gate recompute and its padded columns are not counted as work."""

from bench_h100 import yardstick

K3 = ("rows_kernel", "train_bwd_kernel", "gemm_kernel", "sum_splits_kernel")


def read(m):
    if m.kind != "train" or m.trace is None or not m.traced_work:
        return None
    busy = m.trace.kernel_seconds(K3)
    if busy <= 0:
        return None
    least, _ = yardstick.least_seconds(
        yardstick.backward_flops(m.config) * m.traced_work,
        yardstick.k3_bytes(m.config, m.traced_work), "fp32")
    return 100.0 * least / busy
