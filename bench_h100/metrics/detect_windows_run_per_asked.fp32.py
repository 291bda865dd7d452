"""detect_windows_run_per_asked.fp32 (windows/window, program counter):
``detect_windows_run_per_asked``
(its reader, ``detect_windows_run_per_asked.py``) in the detect cells that
report ``detect_windows_per_s.fp32``, where K1 on the fp32 core sets the
pace."""

import os

from bench_h100.registry import load_reader

read = load_reader(os.path.dirname(os.path.abspath(__file__)),
                   "detect_windows_run_per_asked")
