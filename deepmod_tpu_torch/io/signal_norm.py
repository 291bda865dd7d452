"""Raw-signal normalization and per-event statistics, vectorized.

The reference normalizes per read with median shift / MAD scale computed
over the event-spanned signal range, then winsorizes at read_med +- 5*MAD
and rounds to 3 decimals ("normalize as nanoraw did", myDetect.py:266-282).
It then loops event-by-event recomputing mean/std over each event's raw
slice (myDetect.py:332-343). Both are pure-Python hot loops there; here
they are single-pass vectorized numpy (cumulative-sum mean/variance), the
kind of host-side work that must not starve the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SignalRangeError(ValueError):
    """Event slice fell outside the raw signal (reference 'Less event')."""


def normalize_signal(
    raw_signals: np.ndarray, span_start: int, span_end: int,
    in_place: bool = False,
) -> np.ndarray:
    """Median/MAD normalize + 5xMAD winsorize + round to 3 decimals.

    ``span_start/span_end`` delimit the event-covered slice
    (m_event start[0] .. start[-1]+length[-1], myDetect.py:271-274); the
    whole array is transformed but statistics come from the span only.
    ``in_place=True`` lets the native path overwrite ``raw_signals``
    (only safe when the caller owns and discards the input).
    """
    raw = np.asarray(raw_signals, np.float64)
    if span_end > span_start:
        from deepmod_tpu_torch.native.lib import normalize_signal_native

        native = normalize_signal_native(
            raw, span_start, span_end, in_place=in_place
        )
        if native is not None:
            return native
    span = raw[span_start:span_end]
    mshift = np.median(span)
    mscale = np.median(np.abs(span - mshift))
    raw = (raw - mshift) / mscale
    span = raw[span_start:span_end]
    read_med = np.median(span)
    read_mad = np.median(np.abs(span - read_med))
    lower = read_med - read_mad * 5
    upper = read_med + read_mad * 5
    return np.round(np.clip(raw, lower, upper), 3)


def normalize_and_event_stats(
    m_event: np.ndarray, raw_signals: np.ndarray,
    span_start: int, span_end: int, in_place: bool = False,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fused ``normalize_signal`` + ``event_mean_std`` for the ingestion
    hot path: one native call per read instead of a normalize pass plus a
    python re-quantization and two full-signal cumulative sums.

    Returns (normalized_signals, m_event, n_valid) — identical results to
    calling the two functions in sequence (pinned by
    tests/test_torch_native.py).
    """
    if span_end > span_start:
        from deepmod_tpu_torch.native.lib import normalize_event_stats_native

        fused = normalize_event_stats_native(
            raw_signals, span_start, span_end,
            m_event["start"], m_event["length"], in_place=in_place,
        )
        if fused is not None:
            sig, means, stds, n_valid = fused
            if n_valid < 0:
                raise SignalRangeError("Less event")
            out = m_event[:n_valid].copy()
            out["mean"] = means[:n_valid]
            out["stdv"] = stds[:n_valid]
            return sig, out, n_valid
    sig = normalize_signal(
        raw_signals, span_start, span_end, in_place=in_place
    )
    m_event, n_valid = event_mean_std(m_event, sig)
    return sig, m_event, n_valid


def event_mean_std(
    m_event: np.ndarray, raw_signals: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Fill per-event mean/stdv from normalized raw slices.

    Replicates myDetect.py:332-343 BIT-FOR-BIT (the literal
    round(np.mean/np.std, 3) calls; see the arithmetic note below),
    including its
    out-of-range handling: if an event's slice is empty, the event table
    is truncated there when the offending index is > 500, else the read
    is rejected as 'Less event'. Returns (m_event, n_valid).

    Deliberate deviation: the reference's rejection line is
    ``sp_param['f5status']=="Less event"`` (myDetect.py:340) — a
    comparison, not an assignment — so it actually KEEPS such reads and
    processes them with stale un-normalized means for every event from
    the empty slice onward. That is a bug, not behavior worth
    byte-matching; here the read is rejected, which is what the
    surrounding raiseError calls do for every comparable condition.
    """
    starts = m_event["start"].astype(np.int64)
    lengths = m_event["length"].astype(np.int64)
    ends = starts + lengths
    n_sig = len(raw_signals)

    # effective slice bounds after python-slice clamping
    eff_start = np.minimum(starts, n_sig)
    eff_end = np.minimum(ends, n_sig)
    counts = np.maximum(eff_end - eff_start, 0)
    bad = np.flatnonzero(counts == 0)
    n_valid = len(m_event)
    if len(bad) > 0:
        first_bad = int(bad[0])
        if first_bad > 500:
            n_valid = first_bad - 1  # truncate like myDetect.py:337-339
        else:
            raise SignalRangeError("Less event")

    # the LITERAL reference operations (myDetect.py:342-343):
    # round(np.mean(slice), 3) / round(np.std(slice), 3). np.mean returns
    # an np.float64, whose __round__ is numpy's scale-rint-unscale — NOT
    # python float's correctly-rounded decimal — and np.mean's pairwise
    # summation order decides exact .0005 ties, so any re-derivation
    # (integer milli-arithmetic included) flips the last digit on ~3% of
    # events. The native kernel replicates this arithmetic step for step
    # (numpy 8-accumulator pairwise sum + rint(x*1000)/1000), pinned
    # bit-exact against this path in tests/test_torch_native.py.
    sig = np.asarray(raw_signals, np.float64)
    m_event = m_event[:n_valid].copy()
    means = m_event["mean"]
    stds = m_event["stdv"]
    s = eff_start[:n_valid]
    e = eff_end[:n_valid]
    for i in range(n_valid):
        seg = sig[s[i] : e[i]]
        means[i] = round(np.mean(seg), 3)
        stds[i] = round(np.std(seg), 3)
    return m_event, n_valid
