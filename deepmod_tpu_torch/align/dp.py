"""Banded edit-distance alignment with traceback, vectorized per row.

Used by the built-in aligner (deepmod_tpu_torch.align.minimizer) to align the
short segments between chained minimizer anchors and the read tails. The
reference delegates all of this to minimap2/bwa subprocesses
(myDetect.py:406-424); the built-in path replaces them in-process.

The row recurrence ``cur[j] = min(base[j], cur[j-1] + 1)`` is a prefix
minimum, computed without an inner Python loop as
``minimum.accumulate(base - j) + j``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# CIGAR op characters produced here
M, I, D = "M", "I", "D"

try:
    from deepmod_tpu_torch.native.lib import global_align_ops_native as _native_align
except Exception:  # pragma: no cover
    _native_align = None


def _encode(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def global_align_ops(a: str, b: str) -> List[Tuple[str, int]]:
    """Globally align read segment ``a`` to ref segment ``b``.

    Returns run-length CIGAR ops (M/I/D) with unit costs
    (mismatch=1, gap=1). I consumes read (a); D consumes ref (b).
    Dispatches to the C++ core (deepmod_tpu_torch.native) when built; the two
    implementations share cost model and tie-breaking and are pinned
    equal by tests/test_torch_native.py.

    FULL-matrix O(n*m) DP (int32 backpointers): callers must bound the
    segment sizes — BuiltinAligner caps every gap/tail at max_dp (2000,
    a 16 MB matrix) and soft-clips / splits past it.
    """
    if _native_align is not None:
        result = _native_align(a, b)
        if result is not None:
            return result
    n, m = len(a), len(b)
    if n == 0 and m == 0:
        return []
    if n == 0:
        return [(D, m)]
    if m == 0:
        return [(I, n)]

    av = _encode(a)
    bv = _encode(b)
    js = np.arange(m + 1, dtype=np.int32)

    dp = np.empty((n + 1, m + 1), dtype=np.int32)
    dp[0] = js
    prev = dp[0]
    for i in range(1, n + 1):
        sub = prev[:-1] + (bv != av[i - 1]).astype(np.int32)
        base = np.empty(m + 1, dtype=np.int32)
        base[0] = prev[0] + 1
        base[1:] = np.minimum(sub, prev[1:] + 1)
        cur = np.minimum.accumulate(base - js) + js
        dp[i] = cur
        prev = cur

    # traceback, preferring diagonal moves
    ops: List[Tuple[str, int]] = []
    i, j = n, m

    def push(op: str) -> None:
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    while i > 0 and j > 0:
        sub_cost = dp[i - 1, j - 1] + (av[i - 1] != bv[j - 1])
        if dp[i, j] == sub_cost:
            push(M)
            i -= 1
            j -= 1
        elif dp[i, j] == dp[i - 1, j] + 1:
            push(I)
            i -= 1
        else:
            push(D)
            j -= 1
    while i > 0:
        push(I)
        i -= 1
    while j > 0:
        push(D)
        j -= 1
    ops.reverse()
    return ops


def merge_ops(ops: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
    """Merge adjacent runs of the same op."""
    out: List[Tuple[str, int]] = []
    for op, count in ops:
        if count <= 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + count)
        else:
            out.append((op, count))
    return out


def ops_to_cigar(ops: List[Tuple[str, int]]) -> str:
    return "".join(f"{count}{op}" for op, count in ops)
