"""ctypes bindings for the port's native host library.

``dmt_native.cpp`` (normalize, event stats, DP, minimizers, chain band,
hash index, the ``%.3f`` formatter, CpG swap) and ``dmt_fast5.cpp`` (the
fast5 reader over h5py's libhdf5, bound in ``fast5_native``) are compiled
with g++ at first use, from this directory's sources only, into
``build/native/<digest>/libdmt_native.so`` at the repository root. The
digest covers the sources, the flags and the host CPU (``-march=native``),
so a build is reused while none of them changes. A build goes to a
temporary name and is moved into place with ``os.replace``: concurrent
first builds (test workers, pool workers) each load a whole library.

Every binding has a numpy twin in the host layers; callers use the
``*_native`` functions through the dispatch there, so where the library
cannot be built or loaded the numpy path runs (said once on stderr).
``use_native(False)`` switches the dispatch to the numpy twins in this
process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("dmt_native.cpp", "dmt_fast5.cpp")
BUILD_DIR = os.environ.get(
    "DMT_NATIVE_BUILD_DIR",
    os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native"),
)
LIB_NAME = "libdmt_native.so"
# -ffp-contract=off: no FMA fusion — float arithmetic must match numpy's
# pure IEEE operation sequence bit-for-bit (event stats, normalization)
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-fPIC", "-Wall", "-shared"]
# the functions the library exports, as chip_smoke and the tools list them
EXPORTS = (
    "dmt_event_stats", "dmt_normalize_signal", "dmt_normalize_event_stats",
    "dmt_global_align", "dmt_global_align_multi", "dmt_chain_band",
    "dmt_minimizers", "dmt_cpg_swap", "dmt_format_matrix_f3",
    "dmt_hash_build", "dmt_hash_lookup", "dmt_f5_init", "dmt_f5_open",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_enabled = True
# what the last build did: seconds, whether a cached build was reused,
# the library's path and, where it failed, why
build_info = {"seconds": 0.0, "cached": False, "path": "", "error": ""}


def use_native(on: bool) -> None:
    """Route the host layers to the native library (True) or to their
    numpy twins (False) in this process."""
    global _enabled
    _enabled = bool(on)


def _cpu_key() -> bytes:
    """What ``-march=native`` resolves from: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return os.uname().machine.encode()


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(CXX_FLAGS).encode() + b"\0" + _cpu_key())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if its sources changed; return the .so path.
    Raises RuntimeError when g++ is missing or fails."""
    lib_path = os.path.join(BUILD_DIR, _digest(), LIB_NAME)
    build_info["path"] = lib_path
    if os.path.exists(lib_path):
        build_info.update(seconds=0.0, cached=True)
        return lib_path
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp,
           *(os.path.join(_HERE, s) for s in SOURCES), "-ldl"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ could not run: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, cached=False)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    if not _enabled:
        return None
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as exc:
        _load_failed = True
        build_info["error"] = str(exc)
        print(f"deepmod_tpu_torch.native: the host library could not be "
              f"built or loaded ({str(exc).splitlines()[0]}); the numpy "
              "host path runs", file=sys.stderr)
        return None
    lib.dmt_event_stats.restype = ctypes.c_int
    lib.dmt_event_stats.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.dmt_normalize_signal.restype = None
    lib.dmt_normalize_signal.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.dmt_normalize_event_stats.restype = ctypes.c_int64
    lib.dmt_normalize_event_stats.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.dmt_global_align.restype = ctypes.c_int
    lib.dmt_global_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int,
    ]
    lib.dmt_global_align_multi.restype = ctypes.c_int64
    lib.dmt_global_align_multi.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dmt_chain_band.restype = ctypes.c_int64
    lib.dmt_chain_band.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dmt_minimizers.restype = ctypes.c_int64
    lib.dmt_minimizers.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dmt_cpg_swap.restype = None
    lib.dmt_cpg_swap.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.dmt_format_matrix_f3.restype = ctypes.c_int64
    lib.dmt_format_matrix_f3.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
    ]
    lib.dmt_hash_build.restype = ctypes.c_int
    lib.dmt_hash_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.dmt_hash_lookup.restype = ctypes.c_int64
    lib.dmt_hash_lookup.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def loaded_functions() -> dict:
    """{exported function: found in the loaded library} (empty when the
    library is not loaded)."""
    lib = _load()
    if lib is None:
        return {}
    return {name: hasattr(lib, name) for name in EXPORTS}


def event_stats_native(
    signal: np.ndarray, starts: np.ndarray, lengths: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(means, stds, n_valid) or None if unavailable; raises ValueError on
    the 'Less event' condition like the numpy path."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(signal, np.float64)
    st = np.ascontiguousarray(starts, np.uint64)
    ln = np.ascontiguousarray(lengths, np.uint64)
    n_events = len(st)
    means = np.empty(n_events, np.float32)
    stds = np.empty(n_events, np.float32)
    rc = lib.dmt_event_stats(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(sig),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_events,
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc < 0:
        raise ValueError("Less event")
    return means[:rc], stds[:rc], rc


def normalize_signal_native(
    signal: np.ndarray, span_start: int, span_end: int,
    in_place: bool = False,
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    if in_place and isinstance(signal, np.ndarray) and \
            signal.dtype == np.float64 and signal.flags.c_contiguous:
        sig = signal
    else:
        sig = np.array(signal, np.float64)  # copy; modified in place
    lib.dmt_normalize_signal(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(sig),
        span_start, span_end,
    )
    return sig


def normalize_event_stats_native(
    signal: np.ndarray, span_start: int, span_end: int,
    starts: np.ndarray, lengths: np.ndarray, in_place: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Fused normalize + per-event stats in ONE native pass.

    Returns (normalized_signal, means, stds, n_valid); n_valid is -1 for
    the 'Less event' rejection (the caller raises — this module cannot
    import io.signal_norm's exception without a cycle). None when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if in_place and isinstance(signal, np.ndarray) and \
            signal.dtype == np.float64 and signal.flags.c_contiguous:
        sig = signal
    else:
        sig = np.array(signal, np.float64)  # copy; modified in place
    st = np.ascontiguousarray(starts, np.uint64)
    ln = np.ascontiguousarray(lengths, np.uint64)
    n_events = len(st)
    means = np.empty(n_events, np.float32)
    stds = np.empty(n_events, np.float32)
    n_valid = lib.dmt_normalize_event_stats(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(sig),
        span_start, span_end,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_events,
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return sig, means, stds, int(n_valid)


def global_align_ops_native(a: str, b: str) -> Optional[List[Tuple[str, int]]]:
    lib = _load()
    if lib is None:
        return None
    cap = len(a) + len(b) + 1
    buf = ctypes.create_string_buffer(cap)
    n = lib.dmt_global_align(
        a.encode(), len(a), b.encode(), len(b), buf, cap
    )
    if n < 0:
        return None
    if n == 0:
        return []
    # vectorized run-length encode of the op string
    arr = np.frombuffer(buf.raw, np.uint8, count=n)
    bounds = np.concatenate(
        [[0], np.flatnonzero(arr[1:] != arr[:-1]) + 1, [n]]
    )
    return [
        (chr(arr[bounds[i]]), int(bounds[i + 1] - bounds[i]))
        for i in range(len(bounds) - 1)
    ]


_I64P = ctypes.POINTER(ctypes.c_int64)


def _rle_ops(arr: np.ndarray) -> List[Tuple[str, int]]:
    """Run-length encode an op-byte array into [(op, count), ...]."""
    n = len(arr)
    if n == 0:
        return []
    bounds = np.concatenate(
        [[0], np.flatnonzero(arr[1:] != arr[:-1]) + 1, [n]]
    )
    return [
        (chr(arr[bounds[i]]), int(bounds[i + 1] - bounds[i]))
        for i in range(len(bounds) - 1)
    ]


def global_align_multi_bytes(
    q: bytes,
    r: bytes,
    segments: np.ndarray,  # (n_seg, 4) int64 [q_start, q_end, r_start, r_end]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """All gap segments of one read in ONE native call; returns the raw
    per-column op bytes (concatenated) plus per-segment lengths, or None
    if unavailable (caller falls back per segment)."""
    lib = _load()
    if lib is None:
        return None
    # columns must be CONTIGUOUS buffers (a column view of an (n, 4) array
    # is strided and ctypes would hand C the raw base pointer)
    segs = np.ascontiguousarray(np.asarray(segments, np.int64).T)
    n_seg = segs.shape[1]
    cap = int((segs[1] - segs[0]).sum() + (segs[3] - segs[2]).sum()) + 1
    buf = np.empty(cap, np.uint8)
    seg_lens = np.empty(n_seg, np.int64)
    total = lib.dmt_global_align_multi(
        q, r,
        segs[0].ctypes.data_as(_I64P), segs[1].ctypes.data_as(_I64P),
        segs[2].ctypes.data_as(_I64P), segs[3].ctypes.data_as(_I64P),
        n_seg, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), cap,
        seg_lens.ctypes.data_as(_I64P),
    )
    if total < 0:
        return None
    return buf[:total], seg_lens


def global_align_multi_native(
    q: bytes,
    r: bytes,
    segments: np.ndarray,  # (n_seg, 4) int64 [q_start, q_end, r_start, r_end]
) -> Optional[List[List[Tuple[str, int]]]]:
    """Like global_align_multi_bytes but run-length encoded per segment."""
    raw = global_align_multi_bytes(q, r, segments)
    if raw is None:
        return None
    buf, seg_lens = raw
    out = []
    off = 0
    for ln in seg_lens:
        out.append(_rle_ops(buf[off : off + int(ln)]))
        off += int(ln)
    return out


def chain_band_native(
    qpos: np.ndarray, rpos: np.ndarray, band: int
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(kept_q, kept_r, second_score) for one reference sequence's anchors,
    matching align.minimizer._best_chain's per-rid semantics."""
    lib = _load()
    if lib is None:
        return None
    qp = np.ascontiguousarray(qpos, np.int64)
    rp = np.ascontiguousarray(rpos, np.int64)
    n = len(qp)
    keep_q = np.empty(n, np.int64)
    keep_r = np.empty(n, np.int64)
    second = ctypes.c_int64(0)
    kept = lib.dmt_chain_band(
        qp.ctypes.data_as(_I64P), rp.ctypes.data_as(_I64P), n, band,
        keep_q.ctypes.data_as(_I64P), keep_r.ctypes.data_as(_I64P),
        ctypes.byref(second),
    )
    return keep_q[:kept], keep_r[:kept], int(second.value)


def minimizers_native(
    seq: str, k: int, w: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    n = len(seq)
    pos = np.empty(max(n, 1), np.int64)
    hashes = np.empty(max(n, 1), np.uint64)
    count = lib.dmt_minimizers(
        seq.encode(), n, k, w,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return pos[:count].copy(), hashes[:count].copy()


_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)


class HashIndexNative:
    """Open-addressing minimizer-hash table over a sorted hit array.

    ``build(sorted_hashes)`` derives unique runs in numpy, sizes the table
    to the next power of two above 2x the unique count, and fills it in C.
    ``lookup(queries, max_hits)`` returns (query_idx, source_row) pairs,
    source_row indexing the ORIGINAL sorted arrays — output-identical to
    the two-searchsorted ragged expansion it replaces.
    """

    __slots__ = ("_lib", "_keys", "_offs", "_cnts", "_cap", "_args")

    def __init__(self, sorted_hashes: np.ndarray):
        lib = _load()
        assert lib is not None
        # a table keeps the library it was built with: ``use_native``
        # switches later dispatch, not the lookups of a built index
        self._lib = lib
        n = len(sorted_hashes)
        if n == 0:
            uniq = np.empty(0, np.uint64)
            lefts = np.empty(0, np.int64)
            counts = np.empty(0, np.int64)
        else:
            starts = np.concatenate(
                [[0], np.flatnonzero(sorted_hashes[1:] != sorted_hashes[:-1]) + 1]
            )
            uniq = np.ascontiguousarray(sorted_hashes[starts])
            lefts = np.ascontiguousarray(starts, np.int64)
            counts = np.diff(np.concatenate([starts, [n]]))
        m = len(uniq)
        cap = 1
        while cap < 2 * m + 1:
            cap *= 2
        self._cap = cap
        self._keys = np.zeros(cap, np.uint64)
        self._offs = np.zeros(cap, np.int64)
        self._cnts = np.zeros(cap, np.int32)
        cnts32 = np.ascontiguousarray(
            np.minimum(counts, np.iinfo(np.int32).max), np.int32
        )
        lib.dmt_hash_build(
            uniq.ctypes.data_as(_U64P), lefts.ctypes.data_as(_I64P),
            cnts32.ctypes.data_as(_I32P), m,
            self._keys.ctypes.data_as(_U64P),
            self._offs.ctypes.data_as(_I64P),
            self._cnts.ctypes.data_as(_I32P), cap,
        )
        # pre-marshalled table pointers: per-call ctypes casts dominate
        # short-read lookups otherwise (the owning arrays are pinned by
        # the attributes above)
        self._args = (
            self._keys.ctypes.data_as(_U64P),
            self._offs.ctypes.data_as(_I64P),
            self._cnts.ctypes.data_as(_I32P),
            cap,
        )

    # past this, a worst-case nq*max_hits allocation is too big (a 1 Mb
    # read at max_hits 64 would be ~200 MB) and a count pass sizes the
    # outputs exactly; below it, one pass into worst-case buffers wins
    _SINGLE_PASS_CAP = 1 << 20

    def lookup(
        self, queries: np.ndarray, max_hits: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        lib = self._lib
        q = np.ascontiguousarray(queries, np.uint64)
        nq = len(q)
        qp = q.ctypes.data_as(_U64P)
        worst = nq * max_hits
        if worst <= self._SINGLE_PASS_CAP:
            qidx = np.empty(worst, np.int64)
            src = np.empty(worst, np.int64)
            total = lib.dmt_hash_lookup(
                *self._args, qp, nq, max_hits,
                qidx.ctypes.data_as(_I64P), src.ctypes.data_as(_I64P),
            )
            # .copy() releases the worst-case buffers
            return qidx[:total].copy(), src[:total].copy()
        null = ctypes.POINTER(ctypes.c_int64)()
        total = lib.dmt_hash_lookup(*self._args, qp, nq, max_hits, null, null)
        qidx = np.empty(total, np.int64)
        src = np.empty(total, np.int64)
        lib.dmt_hash_lookup(
            *self._args, qp, nq, max_hits,
            qidx.ctypes.data_as(_I64P), src.ctypes.data_as(_I64P),
        )
        return qidx, src


def hash_index_native(sorted_hashes: np.ndarray):
    """HashIndexNative or None when the library is unavailable."""
    if _load() is None:
        return None
    return HashIndexNative(sorted_hashes)


def format_matrix_f3_native(matrix: np.ndarray):
    """np.savetxt(fmt='%.3f')-identical text for a 2-D float64 matrix as
    a bytes-like numpy view (no copy — pass straight to a file write),
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(matrix, np.float64)
    rows, cols = m.shape
    # worst case ~24 chars + separator per value; np.empty skips the
    # create_string_buffer zero fill
    cap = max(int(rows * cols) * 48, 64)
    out = np.empty(cap, np.uint8)
    n = lib.dmt_format_matrix_f3(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), cap,
    )
    if n < 0:
        return None
    return out[:n].data


def cpg_swap_native(ref_codes: np.ndarray, read_codes: np.ndarray) -> bool:
    """In-place CpG indel canonicalization (myDetect.py:680-700) in C.

    ref_codes/read_codes are contiguous uint8 arrays; returns False when
    the native library is unavailable (caller falls back to Python).
    """
    lib = _load()
    if lib is None:
        return False
    lib.dmt_cpg_swap(
        ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        read_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(ref_codes),
    )
    return True
