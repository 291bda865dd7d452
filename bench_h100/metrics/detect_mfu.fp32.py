"""detect_mfu.fp32 (%, host clock): ``detect_mfu`` (its reader,
``detect_mfu.py``) in the detect cells that report
``detect_windows_per_s.fp32``, where K1 on the fp32 core sets the pace."""

import os

from bench_h100.registry import load_reader

read = load_reader(os.path.dirname(os.path.abspath(__file__)),
                   "detect_mfu")
