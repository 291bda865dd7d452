"""detect_serial_host_ms (ms, program span): the seconds a detect batch
spends in the part of ``predict_batch_windows`` with none of its chunks
on the card, the program's spans ``detect.request`` (the batch's
concatenation and centers), ``detect.pack`` (the one-hot codes and the
host cast) and ``detect.scatter``, over the batch spans
``device_inference`` of the traced host span (CPU and CUDA profiler)."""

from bench_h100.spans import per_batch_ms


def read(m):
    return per_batch_ms(m, ("detect.request", "detect.pack",
                            "detect.scatter"))
