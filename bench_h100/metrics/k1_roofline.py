"""k1_roofline (%, device trace): the least time the cone's work of the
traced windows could take on the card (``yardstick.least_seconds`` of
``cone_flops`` and ``k1_bytes``) over K1's summed device time in the
trace (``bilstm_center_tc_kernel`` in bf16, ``bilstm_center_f32_kernel``
in fp32, ``csrc/bilstm_fused.cu``)."""

from bench_h100 import yardstick

K1 = ("bilstm_center_tc_kernel", "bilstm_center_f32_kernel")


def read(m):
    if m.kind != "detect" or m.trace is None or not m.traced_work:
        return None
    busy = m.trace.kernel_seconds(K1)
    if busy <= 0:
        return None
    precision = m.config["precision"]
    least, _ = yardstick.least_seconds(
        yardstick.cone_flops(m.config) * m.traced_work,
        yardstick.k1_bytes(m.config, m.traced_work, precision), precision)
    return 100.0 * least / busy
