"""train_samples_per_s (samples/s, host clock): samples stepped (steps x
batch) over the whole window's seconds, synchronised at its end."""


def read(m):
    if m.kind != "train" or not m.window_s:
        return None
    return m.work / m.window_s
