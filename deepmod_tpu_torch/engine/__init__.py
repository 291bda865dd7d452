"""The detect and getfeatures pipelines.

The names below load on first use (module ``__getattr__``), so that a
HostPool worker, which imports only ``host_pool``, ``host_worker``,
``outputs`` and the host layers, never imports ``torch``.
"""

_LAZY = {
    "DetectConfig": "detect",
    "DetectResult": "detect",
    "WindowPredictor": "detect",
    "detect_run": "detect",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    globals()[name] = value
    return value
