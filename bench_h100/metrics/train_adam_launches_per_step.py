"""train_adam_launches_per_step (launches/step, program span): the host's
kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) inside
the program's ``train.adam`` spans (``train/trainer.py::adam_update``, a
tensor at a time) over the count of those spans, in the traced host span;
None on the CPU, where nothing launches."""

from bench_h100.spans import launches_per_span


def read(m):
    if m.kind != "train":
        return None
    return launches_per_span(m, "train.adam")
