"""Per-event feature matrices and model windows, vectorized.

Reproduces the reference's detect-time feature construction
(get_Feature, myDetect.py:839-903) and window extraction
(mPredict1, myDetect.py:787-834) without per-event Python loops:

Row layout (one row per event ie in [start_clip-100, L-end_clip+100)):
    col 0                : aligned reference position (aligned rows only)
    cols 1..2            : neg/pos labels (always 0 at detect time)
    [fnum=57: cols 3..52 : 50-bin histogram of the event's normalized
                           signal, bin width 0.2 over [-5, 5)]
    cols fnum-4..fnum-1  : ref-base one-hot A,C,G,T (aligned rows only)
                           (reference index fnum-3+3-4+g_ACGT.index,
                           myDetect.py:896 — absolute 3..6 for fnum=7,
                           53..56 for fnum=57)
    cols fnum..fnum+2    : event mean, stdv, length (cur_index_add =
                           fnum-3+3, myDetect.py:898-900)

The +-100-row context pad gives every aligned event a full 21-row window
(myDetect.py:794,855); windows are a zero-copy strided view.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from deepmod_tpu_torch.align.cigar import BaseMapResult
from deepmod_tpu_torch.utils.common import BASE_TO_INDEX


class FeatureBuildError(ValueError):
    """Message is the reference's error-class string."""


def _aligned_ref_positions(bmr: BaseMapResult) -> np.ndarray:
    """col-0 reference positions of the base map's non-gap rows.

    Equals the reference's running align_ref_pos at each row with
    readbase != '-': start +- (number of preceding rows with
    refbase != '-') with start/direction depending on strand
    (myDetect.py:843-848, 875).
    """
    base_map = bmr.base_map
    ref_consuming = (base_map["refbase"] != "-").astype(np.int64)
    prefix = np.cumsum(ref_consuming) - ref_consuming  # exclusive prefix
    if bmr.strand == "+":
        positions = bmr.first_match_pos + prefix
    else:
        start = bmr.first_match_pos + len(base_map) - bmr.num_insert - 1
        positions = start - prefix
    return positions[base_map["readbase"] != "-"]


def build_feature_matrix(
    m_event: np.ndarray,
    raw_signals: np.ndarray,
    basecall: str,
    bmr: BaseMapResult,
    fnum: int = 7,
    pad: int = 100,
) -> Tuple[np.ndarray, int, int]:
    """Build the per-event feature matrix for one read.

    ``m_event`` is the FULL event array (the reference passes the unclipped
    f5data tuple into get_Feature and indexes with clip offsets,
    myDetect.py:840,855). Returns (mfeatures, start_clip, end_clip).

    Raises FeatureBuildError('Error Does not match') when the base map's
    non-gap read bases disagree with the event basecall — the reference's
    consistency gate (myDetect.py:868-874).
    """
    start_clip = bmr.left_clip
    end_clip = bmr.right_clip
    n_events = len(m_event)
    n_rows = (n_events - end_clip + pad) - (start_clip - pad)
    n_aligned = n_events - end_clip - start_clip

    base_map = bmr.base_map
    nongap = base_map["readbase"] != "-"
    aligned_read_bases = base_map["readbase"][nongap]
    if len(aligned_read_bases) != n_aligned:
        raise FeatureBuildError("Error Does not match")
    # basecall centers of the aligned event span must equal the mapped read
    # bases (both in read orientation)
    span_calls = np.frombuffer(
        basecall[start_clip : n_events - end_clip].encode(), np.uint8
    )
    # U1 -> codepoint via uint32 view (boolean-mask result is contiguous);
    # avoids the much slower unicode->bytes astype('S1') conversion
    mapped_calls = aligned_read_bases.view(np.uint32)
    if not np.array_equal(span_calls, mapped_calls.astype(np.uint8)):
        raise FeatureBuildError("Error Does not match")

    mfeatures = np.zeros((n_rows, fnum + 3), np.float64)

    # absolute event index per row: ie = row + (start_clip - pad), so the
    # in-range events [max(0, start_clip-pad), min(n, n-end_clip+pad))
    # occupy one CONTIGUOUS row span — slice assignments, no index arrays
    row0 = start_clip - pad
    ie_lo = max(0, row0)
    ie_hi = min(n_events, n_events - end_clip + pad)
    vrows = slice(ie_lo - row0, ie_hi - row0)
    vie = slice(ie_lo, ie_hi)

    # aligned rows: [pad, pad + n_aligned)
    mfeatures[pad : pad + n_aligned, 0] = _aligned_ref_positions(bmr)

    # one-hot of the ALIGNED base's refbase (non-aligned pad rows stay 0;
    # '-'/'N' ref bases leave all four columns 0, myDetect.py:893-895):
    # one flat scatter over the rows whose base is in ACGT
    ref_at_aligned = base_map["refbase"][nongap]
    ref_codes = ref_at_aligned.view(np.uint32)  # U1 codepoints
    col_of = np.full(256, -1, np.int64)  # non-ACGT (incl. '-'/'N') -> -1
    for base, idx in BASE_TO_INDEX.items():
        col_of[ord(base)] = fnum - 4 + idx
    cols = col_of[np.minimum(ref_codes, 255)]
    known = np.flatnonzero(cols >= 0)
    ncol = fnum + 3
    mfeatures.reshape(-1)[(pad + known) * ncol + cols[known]] = 1.0

    # signal-derived columns for every in-range event
    mfeatures[vrows, fnum + 0] = m_event["mean"][vie]
    mfeatures[vrows, fnum + 1] = m_event["stdv"][vie]
    mfeatures[vrows, fnum + 2] = m_event["length"][vie]

    if fnum == 57:
        binnum, binlen = 50, 0.2
        vrows = np.arange(vrows.start, vrows.stop)
        starts = m_event["start"][vie].astype(np.int64)
        # int(length + 0.5) like myDetect.py:883
        lens = (m_event["length"][vie].astype(np.float64) + 0.5).astype(np.int64)
        ends = np.minimum(starts + lens, len(raw_signals))
        counts = np.maximum(ends - starts, 0)
        sig_rows = np.repeat(vrows, counts)
        flat_idx = np.concatenate(
            [np.arange(s, e) for s, e in zip(starts, ends)]
        ) if len(starts) else np.empty(0, np.int64)
        sig = raw_signals[flat_idx]
        bins = ((sig + 5.0) / binlen).astype(np.int64)
        np.clip(bins, 0, binnum - 1, out=bins)
        np.add.at(mfeatures, (sig_rows, bins + 3), 1.0)

    return mfeatures, start_clip, end_clip


def extract_windows(
    mfeatures: np.ndarray,
    n_aligned: int,
    window: int = 21,
    pad: int = 100,
    dtype=np.float32,
) -> np.ndarray:
    """(N_rows, fnum+3) matrix -> (n_aligned, window, fnum) model input.

    Window i covers rows [pad + i - w//2, pad + i + w//2] of the feature
    block (cols 3..), i.e. the reference's tx[mind-10 : mind+11]
    (myDetect.py:795-799). Always in range thanks to the +-100 pad.
    """
    half = window // 2
    tx = np.ascontiguousarray(mfeatures[:, 3:], dtype=dtype)
    view = np.lib.stride_tricks.sliding_window_view(tx, window, axis=0)
    # view[j] = rows j..j+window-1; window centered at pad+i starts at
    # pad+i-half
    start = pad - half
    out = view[start : start + n_aligned]
    return np.moveaxis(out, 2, 1)  # (n_aligned, window, fnum)


def map_predictions_to_base_map(
    bmr: BaseMapResult, predictions: np.ndarray
) -> int:
    """Scatter per-event class predictions onto base-map rows.

    Equivalent of the aligni walk in mPredict1 (myDetect.py:823-833):
    prediction i belongs to the i-th non-gap row. Returns pred_mod_num.
    """
    nongap = np.flatnonzero(bmr.base_map["readbase"] != "-")
    if len(nongap) != len(predictions):
        raise FeatureBuildError("Error Does not match")
    hits = nongap[predictions == 1]
    bmr.base_map["mod_pred"][hits] = 1
    return int(len(hits))
