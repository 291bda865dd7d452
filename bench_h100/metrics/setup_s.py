"""setup_s (s, host clock): process start to the first timed call:
interpreter and imports, the CUDA context, loading (or, in a fresh
checkout, building) the kernel library, the weights, the inputs and the
warm-up. The seconds set-up spends on the reference's behalf (a detect
cell's class balance) are left out."""


def read(m):
    return m.setup_s
