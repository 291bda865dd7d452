"""detect_windows_per_s.fp32 (windows/s, host clock):
``detect_windows_per_s`` (its reader, ``detect_windows_per_s.py``) in
the detect cells at fp32, where K1 on the fp32 core sets the pace and
runs spread little: a bound of their own, not the wider one that the
cells paced by the host's shared cores need."""

import os

from bench_h100.registry import load_reader

read = load_reader(os.path.dirname(os.path.abspath(__file__)),
                   "detect_windows_per_s")
