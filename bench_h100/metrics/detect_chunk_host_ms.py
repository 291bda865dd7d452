"""detect_chunk_host_ms (ms, program span): the host work of a detect
batch's chunk loop, the program's spans ``detect.chunk`` (a chunk's
bucket, index and padded copies) and ``detect.dispatch`` (the pinned
copy, the LUT rebuild, the kernel's and argmax's enqueue, the result
copy), over the batch spans ``device_inference`` of the traced host span;
waiting on the card (``detect.fetch``) left out."""

from bench_h100.spans import per_batch_ms


def read(m):
    return per_batch_ms(m, ("detect.chunk", "detect.dispatch"))
