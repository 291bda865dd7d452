"""train_launches_per_step (launches/step, device trace): the kernels in
the device span over the steps it traced: K2, K3's five a layer, and the
autograd glue and Adam's per-tensor updates around them."""


def read(m):
    if m.kind != "train" or m.trace is None or not m.traced_iters:
        return None
    return len(m.trace.kernels()) / m.traced_iters
