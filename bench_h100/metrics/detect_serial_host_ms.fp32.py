"""detect_serial_host_ms.fp32 (ms, program span): ``detect_serial_host_ms``
(its reader, ``detect_serial_host_ms.py``) in the detect cells that
report ``detect_windows_per_s.fp32``, where K1 on the fp32 core sets the
pace."""

import os

from bench_h100.registry import load_reader

read = load_reader(os.path.dirname(os.path.abspath(__file__)),
                   "detect_serial_host_ms")
