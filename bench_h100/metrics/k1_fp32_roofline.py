"""k1_fp32_roofline (%, device trace): ``k1_roofline`` (its reader,
``k1_roofline.py``) of K1 at fp32 (``bilstm_center_f32_kernel`` on the
fp32 core), in the detect cells that report
``detect_windows_per_s.fp32``, where it sets the pace."""

import os

from bench_h100.registry import load_reader

read = load_reader(os.path.dirname(os.path.abspath(__file__)),
                   "k1_roofline")
