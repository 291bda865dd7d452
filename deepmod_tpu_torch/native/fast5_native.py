"""ctypes wrapper for the native fast5 reader (dmt_fast5.cpp).

The port's copy of ``deepmod_tpu/native/fast5_native.py``. It reads the
raw HDF5 content (channel attrs, fastq, signal, events/move) through a
dlopen'd libhdf5 — the one h5py bundles — then hands off to the same
event-collapse/normalization code as the h5py path, so the two ingestion
paths produce identical Fast5Read objects (pinned by
tests/test_torch_native.py). Where h5py is absent,
``native_fast5_available()`` is false and fast5 input is not read at all
(pod5 input needs neither).
"""

from __future__ import annotations

import ctypes
import glob as globmod
import os
from typing import Optional

import numpy as np

from .lib import _load


def _find_libhdf5() -> Optional[str]:
    try:
        import h5py

        libs_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(h5py.__file__))),
            "h5py.libs",
        )
        hits = sorted(globmod.glob(os.path.join(libs_dir, "libhdf5-*.so*")))
        if hits:
            return hits[0]
    except Exception:
        pass
    for cand in (
        "/lib/x86_64-linux-gnu/libhdf5_serial.so.103",
        "libhdf5.so",
    ):
        if cand.startswith("/") and os.path.isfile(cand):
            return cand
    return None


_initialized: Optional[bool] = None


def _ensure_init():
    global _initialized
    lib = _load()
    if lib is None:  # unavailable, or switched off by lib.use_native
        return False
    if _initialized is not None:
        return _initialized
    libhdf5 = _find_libhdf5()
    if libhdf5 is None:
        _initialized = False
        return False
    lib.dmt_f5_init.restype = ctypes.c_int
    lib.dmt_f5_init.argtypes = [ctypes.c_char_p]
    lib.dmt_f5_open.restype = ctypes.c_void_p
    lib.dmt_f5_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int]
    for name, restype in (
        ("dmt_f5_status", ctypes.c_int),
        ("dmt_f5_sampling_rate", ctypes.c_double),
        ("dmt_f5_start_time", ctypes.c_longlong),
        ("dmt_f5_version", ctypes.c_char_p),
        ("dmt_f5_fastq", ctypes.c_char_p),
        ("dmt_f5_signal_len", ctypes.c_longlong),
        ("dmt_f5_n_events", ctypes.c_longlong),
        ("dmt_f5_move_len", ctypes.c_longlong),
        ("dmt_f5_first_sample", ctypes.c_longlong),
    ):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.dmt_f5_signal.restype = None
    lib.dmt_f5_signal.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.dmt_f5_events.restype = None
    lib.dmt_f5_events.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
    ]
    lib.dmt_f5_events_packed.restype = None
    lib.dmt_f5_events_packed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char), ctypes.c_int,
    ]
    lib.dmt_f5_n_collapsed_v2.restype = ctypes.c_longlong
    lib.dmt_f5_n_collapsed_v2.argtypes = [ctypes.c_void_p]
    lib.dmt_f5_events_collapsed_v2.restype = None
    lib.dmt_f5_events_collapsed_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char),
    ]
    lib.dmt_f5_events_collapsed_v1.restype = ctypes.c_longlong
    lib.dmt_f5_events_collapsed_v1.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_char),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.dmt_f5_move.restype = None
    lib.dmt_f5_move.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.dmt_f5_free.restype = None
    lib.dmt_f5_free.argtypes = [ctypes.c_void_p]
    rc = lib.dmt_f5_init(libhdf5.encode())
    _initialized = rc == 0
    return _initialized


def native_fast5_available() -> bool:
    return bool(_ensure_init())


def _hdf5_lock():
    """libhdf5 is NOT thread-safe and this reader dlopens the very same
    library h5py bundles. h5py serializes all ITS calls behind a global
    FastRLock ('phil'), but a native read on another thread bypasses it —
    in the single-process detect path the ingest prefetch thread raced
    the predetail h5py writer thread and segfaulted inside libhdf5
    (seen on an 800-read cohort as a segfault inside libhdf5). Taking phil around every native file
    read serializes correctly with ALL in-process h5py usage; in pool
    workers it is uncontended (~ns)."""
    global _HDF5_LOCK
    if _HDF5_LOCK is None:
        try:
            from h5py._objects import phil as _HDF5_LOCK  # noqa: N813
        except Exception:  # h5py internals moved: lock native-vs-native
            import threading

            _HDF5_LOCK = threading.RLock()
    return _HDF5_LOCK


_HDF5_LOCK = None


def read_fast5_native(path: str, options=None):
    """Native-IO twin of io.fast5.read_fast5_file; returns Fast5Read or
    raises the same error classes. None when the native path is absent."""
    if not _ensure_init():
        return None
    with _hdf5_lock():
        return _read_fast5_native_locked(path, options)


def _read_fast5_native_locked(path: str, options=None):
    from deepmod_tpu_torch.io.events import (
        EventError,
        collapse_events_v2,
        move_table_events,
        resegment_events,
    )
    from deepmod_tpu_torch.io.fast5 import (
        Fast5Read,
        Fast5ReadOptions,
        _basecall_from_events,
        _version_class,
    )
    from deepmod_tpu_torch.io.signal_norm import normalize_and_event_stats

    options = options or Fast5ReadOptions()
    lib = _load()
    handle = lib.dmt_f5_open(
        path.encode(), options.basecall_1d.encode(),
        options.basecall_2strand.encode(), 1 if options.move else 0,
    )
    try:
        status = lib.dmt_f5_status(handle)
        if status != 0:
            messages = {
                -1: "Cannot open fast5 or other errors",
                -2: "Channel information could not be found",
                -3: "No Fastq data",
                -4: "No Raw_reads/Signal",
                -5: "No Raw_reads/Signal",
                -6: "No move data",
                -7: "No events data",
            }
            raise EventError(messages.get(status, "Cannot open fast5 or other errors"))
        sampling_rate = lib.dmt_f5_sampling_rate(handle)
        start_time = int(lib.dmt_f5_start_time(handle))
        version = lib.dmt_f5_version(handle).decode()
        fastq = lib.dmt_f5_fastq(handle).decode().split("\n")
        header = fastq[0]
        read_id = (header[1:] if header.startswith("@") else header)
        read_id = read_id.replace(" ", ":::").replace("\t", "|||")
        fq_seq = fastq[1] if len(fastq) > 1 else ""
        n_sig = lib.dmt_f5_signal_len(handle)
        raw_signals = np.empty(n_sig, np.float64)
        lib.dmt_f5_signal(
            handle, raw_signals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )

        if options.move:
            n_move = lib.dmt_f5_move_len(handle)
            move_data = np.empty(n_move, np.int64)
            lib.dmt_f5_move(
                handle, move_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            )
            first = int(lib.dmt_f5_first_sample(handle))
            if first < 0:
                # Segmentation summary absent: the h5py path raises
                # KeyError there, which the batch readers classify as
                # "Cannot open fast5 or other errors" — match it instead
                # of silently building events from start=-1
                raise EventError("Cannot open fast5 or other errors")
            m_event, skip = move_table_events(
                move_data, raw_signals, fq_seq, first
            )
            basecall = fq_seq
        else:
            n_ev = lib.dmt_f5_n_events(handle)
            version_class = _version_class(version)
            if (
                version_class != 1
                and options.signal_group == "simple"
                and n_ev > 0
            ):
                # hot path: the C side collapses stay events straight from
                # its interleaved record buffer into the numpy EVENT_DTYPE
                # layout — no intermediate events array, no numpy collapse
                # (bit-identical to collapse_events_v2; pinned by
                # tests/test_native_fast5.py)
                from deepmod_tpu_torch.io.events import EVENT_DTYPE

                n_out = int(lib.dmt_f5_n_collapsed_v2(handle))
                m_event = np.empty(n_out, EVENT_DTYPE)
                assert m_event.dtype.itemsize == 44
                lib.dmt_f5_events_collapsed_v2(
                    handle,
                    m_event.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                )
                skip = (0, 0)
            elif version_class == 1:
                if start_time < 0:
                    # attr absent: the h5py path (and the reference,
                    # via KeyError) reject such v1 reads
                    raise EventError("Cannot open fast5 or other errors")
                # C-side v1 collapse (seconds -> samples, gap patching),
                # bit-identical to collapse_events_v1 incl. its
                # python-round means (pinned by tests/test_native_fast5)
                from deepmod_tpu_torch.io.events import EVENT_DTYPE

                buf = np.empty(2 * int(n_ev) + 2, EVENT_DTYPE)
                assert buf.dtype.itemsize == 44
                skl = ctypes.c_longlong()
                skr = ctypes.c_longlong()
                cnt = int(lib.dmt_f5_events_collapsed_v1(
                    handle, float(sampling_rate), int(start_time),
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                    ctypes.byref(skl), ctypes.byref(skr),
                ))
                if cnt == -1:
                    raise EventError("Remove too many bases on left")
                if cnt == -2:
                    raise EventError("Remove too many bases on right")
                if cnt == -3:
                    raise EventError(
                        "The index of the first base is less than -2"
                    )
                m_event = buf[:cnt].copy()
                skip = (skl.value, skr.value)
            else:
                # rundif re-segmentation (re-splits raw signal, not a stay
                # collapse) and the empty-table v2 corner: build the packed
                # events array and reuse the python paths
                dtype = [("mean", "<f8"), ("stdv", "<f8"),
                         ("start", "<u8"), ("length", "<u8"),
                         ("model_state", "S5"), ("move", "<i8")]
                events = np.empty(int(n_ev), dtype=dtype)
                # C fills the packed record layout directly (offsets
                # 0/8/16/24/32/37, itemsize 45)
                assert events.dtype.itemsize == 45
                lib.dmt_f5_events_packed(
                    handle,
                    events.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                    1,
                )
                if options.signal_group == "simple":
                    # n_ev == 0 routes here; collapse_events_v2 raises
                    # EventError("No events data") for the empty table
                    m_event, skip = collapse_events_v2(events)
                else:
                    m_event, skip = resegment_events(
                        events, raw_signals, fq_seq
                    )
            basecall = _basecall_from_events(m_event)
    finally:
        lib.dmt_f5_free(handle)

    span_start = int(m_event["start"][0])
    span_end = int(m_event["start"][-1] + m_event["length"][-1])
    raw_signals, m_event, n_valid = normalize_and_event_stats(
        m_event, raw_signals, span_start, span_end, in_place=True
    )
    if n_valid < len(basecall):
        basecall = basecall[:n_valid]

    return Fast5Read(
        read_id=read_id,
        basecall=basecall,
        m_event=m_event,
        raw_signals=raw_signals,
        path=path,
        left_right_skip=skip,
        albacore_version=version,
    )
