"""The port's native host library (C++ through ctypes), built with g++ at
first use; see ``lib``. Its numpy twins in the host layers run wherever it
cannot be built or loaded."""

from .lib import (
    build,
    build_info,
    event_stats_native,
    global_align_ops_native,
    loaded_functions,
    minimizers_native,
    native_available,
    normalize_signal_native,
    use_native,
)
