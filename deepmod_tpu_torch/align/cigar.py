"""CIGAR expansion: aligner record -> per-column base map + event clips.

Replicates, with vectorized numpy instead of per-base Python loops, the
reference's handle_record walk (myDetect.py:488-711 for detect — which
adds the mod_pred column — and myGetFeatureBasedPos.py:109-350 for
feature extraction), including every parity-critical incidental behavior:

- tail clip stripping where X is treated as BOTH read- and ref-consuming
  (myDetect.py:620-640 clip loops);
- first/last exact-match trimming of both the event array and the base
  map (myDetect.py:630-657);
- minus-strand flip + per-column complement + clip swap
  (myDetect.py:661-666);
- the CpG ``C-G``/``CCG`` indel canonicalization swap, run sequentially so
  earlier swaps are visible to later ones (myDetect.py:680-700);
- the reference's rejection thresholds (<50 events for detect at
  myDetect.py:702, <500 for getfeatures at myGetFeatureBasedPos.py:318).

The output dtype mirrors base_map_info (myDetect.py:660).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

from deepmod_tpu_torch.utils.common import complement_codes

BASE_MAP_DTYPE = np.dtype(
    [
        ("refbase", "U1"),
        ("readbase", "U1"),
        ("refbasei", np.uint64),
        ("readbasei", np.uint64),
        ("mod_pred", np.int64),
    ]
)

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHPX=])")

# op codes
_OPS = "MIDNSHP=X"
_OP_INDEX = {op: i for i, op in enumerate(_OPS)}
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = range(9)

_DASH = ord("-")

# per-op boolean lookup tables (indexed by op code) — one fancy-index
# replaces a sort-based np.isin per category
_LUT_CONSUMES_READ = np.zeros(9, bool)
_LUT_CONSUMES_READ[[_M, _I, _S, _EQ, _X]] = True
_LUT_CONSUMES_REF = np.zeros(9, bool)
_LUT_CONSUMES_REF[[_M, _D, _N, _EQ, _X]] = True
_LUT_MAKES_ROW = np.zeros(9, bool)
_LUT_MAKES_ROW[[_M, _I, _D, _N, _EQ, _X]] = True
_LUT_ROW_HAS_READ = np.zeros(9, bool)
_LUT_ROW_HAS_READ[[_M, _I, _EQ, _X]] = True
_LUT_ROW_HAS_REF = np.zeros(9, bool)
_LUT_ROW_HAS_REF[[_M, _D, _N, _EQ, _X]] = True


def _codes_to_u1(codes: np.ndarray) -> np.ndarray:
    """uint8 ASCII codes -> U1 array via codepoint widening (no per-item
    string casting)."""
    return np.ascontiguousarray(codes.astype(np.uint32)).view("<U1")


@dataclasses.dataclass
class BaseMapResult:
    base_map: np.ndarray          # BASE_MAP_DTYPE, strand-oriented
    event_slice: Tuple[int, int]  # [start, stop) into the clip-stripped m_event
    left_clip: int                # events clipped at read 5' (strand-oriented)
    right_clip: int
    strand: str
    rname: str
    first_match_pos: int
    num_match: int
    num_mismatch: int
    num_insert: int
    num_del: int


class AlignmentRejected(ValueError):
    """Message is the reference's error-class string."""


def parse_cigar(cigar: str) -> Tuple[np.ndarray, np.ndarray]:
    nums = []
    ops = []
    for m in _CIGAR_RE.finditer(cigar):
        nums.append(int(m.group(1)))
        ops.append(_OP_INDEX[m.group(2)])
    return np.asarray(nums, np.int64), np.asarray(ops, np.int64)


def _strip_clips(
    nums: np.ndarray, ops: np.ndarray, pos: int, read_len: int
) -> Tuple[np.ndarray, np.ndarray, int, int, int, int, int]:
    """Strip non-M/= ops from both tails (myDetect.py:616-640).

    Returns (nums, ops, pos, leftclip, rightclip, read_start, read_stop)
    where read_start/stop delimit the surviving read-sequence slice.
    """
    left = 0
    right = len(nums)
    leftclip = 0
    rightclip = 0
    read_start = 0
    read_stop = read_len
    while left < right and ops[left] in (_I, _D, _N, _S, _H, _P, _X):
        op, n = ops[left], int(nums[left])
        if op in (_I, _S, _X):
            leftclip += n
            read_start += n
        if op == _H:
            leftclip += n
        if op in (_D, _N, _X):
            pos += n
        left += 1
    while right > left and ops[right - 1] in (_I, _D, _N, _S, _H, _P, _X):
        op, n = ops[right - 1], int(nums[right - 1])
        if op in (_I, _S, _X):
            rightclip += n
            read_stop -= n
        if op == _H:
            rightclip += n
        right -= 1
    if left >= right:
        raise AlignmentRejected("no first and/or last match")
    return nums[left:right], ops[left:right], pos, leftclip, rightclip, read_start, read_stop


def _cpg_swap(ref_codes: np.ndarray, read_codes: np.ndarray) -> None:
    """In-place CpG indel canonicalization (myDetect.py:680-700).

    Sequential, like the reference, so each swap is visible to later
    positions; the C path (native.lib.cpg_swap_native) runs the full
    reference scan, the Python fallback only candidate indices.
    """
    if (ref_codes.flags.c_contiguous and read_codes.flags.c_contiguous
            and read_codes.flags.writeable):
        from deepmod_tpu_torch.native.lib import cpg_swap_native

        if cpg_swap_native(ref_codes, read_codes):
            return
    c, g, dash = ord("C"), ord("G"), _DASH
    n = len(ref_codes)
    candidates = np.flatnonzero(
        ((ref_codes == c) & (read_codes == c)) | ((ref_codes == g) & (read_codes == g))
    )
    for ali in candidates:
        if ref_codes[ali] == c and read_codes[ali] == c:
            if ali + 1 < n and read_codes[ali + 1] == dash and ref_codes[ali + 1] == g:
                addali = 2
                while ali + addali < n and read_codes[ali + addali] == dash and ref_codes[ali + addali] == g:
                    addali += 1
                if ali + addali < n and read_codes[ali + addali] == g and ref_codes[ali + addali] == g:
                    read_codes[ali + 1], read_codes[ali + addali] = (
                        read_codes[ali + addali],
                        read_codes[ali + 1],
                    )
        if ref_codes[ali] == g and read_codes[ali] == g:
            if ali - 1 > -1 and read_codes[ali - 1] == dash and ref_codes[ali - 1] == c:
                addali = 2
                while ali - addali > -1 and read_codes[ali - addali] == dash and ref_codes[ali - addali] == c:
                    addali += 1
                if ali - addali > -1 and read_codes[ali - addali] == c and ref_codes[ali - addali] == c:
                    read_codes[ali - 1], read_codes[ali - addali] = (
                        read_codes[ali - addali],
                        read_codes[ali - 1],
                    )


def expand_alignment(
    refseq: str,
    readseq: str,
    pos0: int,
    cigar: str,
    strand: str,
    rname: str,
    num_events: int,
    min_events: int = 50,
    cpg_canonicalize: bool = True,
    cigar_arrays=None,
    strict_ref_clips: bool = True,
) -> BaseMapResult:
    """Expand one filtered SAM record into the strand-oriented base map.

    ``pos0`` is the 0-based mapped position (SAM pos - 1); ``num_events``
    is the length of the read's m_event array; ``min_events`` is 50 for
    detect (myDetect.py:702) and 500 for getfeatures
    (myGetFeatureBasedPos.py:318). Event clipping is returned as a slice
    into the event array rather than a copy. ``cigar_arrays`` is an
    optional pre-parsed (nums, op_codes) pair (SamRecord.cigar_arrays)
    that skips the string parse.

    ``strict_ref_clips`` replicates a reference inconsistency: for '-'
    alignments the reference attributes the SEQ-left unmatched trim
    (firstmatch) and the SEQ-right tail trim to the OPPOSITE clip
    variables (myDetect.py:634-635 + the :666 swap), then walks the
    ORIGINAL event table with those clips (get_Feature, :855-874) — so
    whenever firstmatch != tail the walk is event-shifted, its
    model_state check fires, and the read is dropped as 'Error Does not
    match' (~2-3%% of minus-strand reads on realistic data). True keeps
    that exact read set for BED parity; False keeps such reads with
    self-consistent windows (more coverage, beyond the reference).
    """
    parsed = cigar_arrays if cigar_arrays is not None else parse_cigar(cigar)
    nums, ops, pos, leftclip, rightclip, rstart, rstop = _strip_clips(
        *parsed, pos0, len(readseq)
    )
    read_codes_full = np.frombuffer(readseq.encode(), np.uint8)[rstart:rstop]
    ref_codes_full = np.frombuffer(refseq.encode(), np.uint8)

    # events surviving the tail clips (myDetect.py:641-647); slice bounds
    # tracked, array untouched
    if strand == "+":
        ev_lo, ev_hi = leftclip, num_events - rightclip
    else:
        ev_lo, ev_hi = rightclip, num_events - leftclip
    m_event_len = ev_hi - ev_lo

    # --- vectorized walk -------------------------------------------------
    op_arr = np.repeat(ops, nums)
    consumes_read = _LUT_CONSUMES_READ[op_arr]
    consumes_ref = _LUT_CONSUMES_REF[op_arr]
    read_idx = np.cumsum(consumes_read) - consumes_read  # exclusive prefix
    ref_idx = pos + np.cumsum(consumes_ref) - consumes_ref

    makes_row = _LUT_MAKES_ROW[op_arr]
    row_ops = op_arr[makes_row]
    row_read_idx = read_idx[makes_row]
    row_ref_idx = ref_idx[makes_row]

    row_has_read = _LUT_ROW_HAS_READ[row_ops]
    row_has_ref = _LUT_ROW_HAS_REF[row_ops]
    read_col = np.where(
        row_has_read,
        read_codes_full[np.minimum(row_read_idx, len(read_codes_full) - 1)],
        _DASH,
    ).astype(np.uint8)
    ref_col = np.where(
        row_has_ref,
        ref_codes_full[np.minimum(row_ref_idx, len(ref_codes_full) - 1)],
        _DASH,
    ).astype(np.uint8)

    # exact matches: M rows with equal bases, plus every '=' row
    is_match = ((row_ops == _M) & (read_col == ref_col)) | (row_ops == _EQ)
    match_rows = np.flatnonzero(is_match)
    if len(match_rows) == 0:
        raise AlignmentRejected("no first and/or last match")
    first_al_match = int(match_rows[0])
    last_al_match = int(match_rows[-1])
    firstmatch = int(row_read_idx[first_al_match])
    lastmatch = int(row_read_idx[last_al_match])
    first_match_pos = int(row_ref_idx[first_al_match])

    num_mismatch = int(np.sum((row_ops == _M) & (read_col != ref_col)) + np.sum(row_ops == _X))
    num_insert = int(np.sum(row_ops == _I))
    num_del = int(np.sum(row_ops == _D))

    # un-matched tail trimming of events (myDetect.py:630-647); the slice
    # expressions intentionally use the pre-trim event length
    if strand == "+":
        leftclip += firstmatch
        if m_event_len - lastmatch > 1:
            rightclip += m_event_len - lastmatch - 1
            new_lo = ev_lo + firstmatch
            new_hi = ev_hi + (lastmatch + 1 - m_event_len)
        elif firstmatch > 0:
            new_lo, new_hi = ev_lo + firstmatch, ev_hi
        else:
            new_lo, new_hi = ev_lo, ev_hi
    else:
        # SEQ is the reverse-complemented read: a trim at the SEQ-left
        # (firstmatch) removes READ-RIGHT events, which pre-swap is the
        # SEQ-left clip variable, and vice versa — the event-slice
        # expressions below encode exactly this (ev_hi -= firstmatch)
        tail_trim = (
            m_event_len - lastmatch - 1 if m_event_len - lastmatch > 1 else 0
        )
        if strict_ref_clips and firstmatch != tail_trim:
            # the reference's swapped accounting shifts its event walk by
            # (firstmatch - tail) for such reads and its consistency gate
            # drops them (see docstring); match its read set and census
            raise AlignmentRejected("Error Does not match")
        leftclip += firstmatch
        if m_event_len - lastmatch > 1:
            rightclip += m_event_len - lastmatch - 1
        if firstmatch > 0:
            new_lo = ev_lo + (m_event_len - 1 - lastmatch)
            new_hi = ev_hi - firstmatch
        elif m_event_len - lastmatch > 1:
            new_lo, new_hi = ev_lo + (m_event_len - 1 - lastmatch), ev_hi
        else:
            new_lo, new_hi = ev_lo, ev_hi
    ev_lo, ev_hi = new_lo, new_hi

    # base-map trim to first/last exact match (myDetect.py:648-657)
    nrows = len(row_ops)
    if nrows - last_al_match > 1:
        sl = slice(first_al_match, last_al_match + 1 - nrows)
    elif first_al_match > 0:
        sl = slice(first_al_match, None)
    else:
        sl = slice(None)
    ref_col = ref_col[sl].copy()
    read_col = read_col[sl].copy()
    row_ref_idx = row_ref_idx[sl]
    row_read_idx = row_read_idx[sl]

    if strand == "-":
        ref_col = complement_codes(ref_col[::-1]).copy()
        read_col = complement_codes(read_col[::-1]).copy()
        row_ref_idx = row_ref_idx[::-1]
        row_read_idx = row_read_idx[::-1]
        leftclip, rightclip = rightclip, leftclip

    if cpg_canonicalize:
        _cpg_swap(ref_col, read_col)

    if ev_hi - ev_lo < min_events:
        raise AlignmentRejected(
            "Less Event" if min_events <= 50 else "Less(<500) events"
        )

    base_map = np.empty(len(ref_col), dtype=BASE_MAP_DTYPE)
    base_map["refbase"] = _codes_to_u1(ref_col)
    base_map["readbase"] = _codes_to_u1(read_col)
    base_map["refbasei"] = row_ref_idx.astype(np.uint64)
    base_map["readbasei"] = row_read_idx.astype(np.uint64)
    base_map["mod_pred"] = 0

    num_match = len(base_map) - num_mismatch - num_insert - num_del
    return BaseMapResult(
        base_map=base_map,
        event_slice=(ev_lo, ev_hi),
        left_clip=leftclip,
        right_clip=rightclip,
        strand=strand,
        rname=rname,
        first_match_pos=first_match_pos,
        num_match=num_match,
        num_mismatch=num_mismatch,
        num_insert=num_insert,
        num_del=num_del,
    )
