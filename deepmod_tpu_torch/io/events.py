"""Event-table normalization: basecaller events -> per-base signal events.

Reproduces the reference's three event-construction paths:

- ``collapse_events_v1``: Albacore 1.x tables where event starts are in
  seconds (myDetect.py:166-238) — collapses stay events (move==0),
  converts start times to raw-sample indices, and patches gaps between
  consecutive events exactly like the reference (including its uint64
  truncation and the >2-sample gap-filler event).
- ``collapse_events_v2``: Albacore 2.x 'simple' tables where starts are
  already sample indices (myDetect.py:239-259).
- ``resegment_events``: the 'rundif' re-segmentation that re-splits raw
  signal at maximal cumulative-sum-difference change points so every base
  keeps >= 4 samples (EventTable.py:21-108).
- ``move_table_events``: Guppy-style Move tables with stride 2
  (MoveTable.py:7-50).

All return the reference's m_event structured dtype
(mean f4, stdv f4, start u8, length u8, model_state U5) so downstream
feature construction is format-identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EVENT_DTYPE = np.dtype(
    [
        ("mean", "<f4"),
        ("stdv", "<f4"),
        ("start", np.uint64),
        ("length", np.uint64),
        ("model_state", "U5"),
    ]
)


class EventError(ValueError):
    """Raised with the reference's error-class string as the message."""


def collapse_events_v1(
    events: np.ndarray,
    sampling_rate: float,
    raw_start_time: int,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Albacore v1: seconds -> sample indices + stay collapse + gap patch.

    ``events`` needs fields mean, stdv, start (seconds, f8), length
    (seconds, f8), move (int), model_state (bytes or str).
    Returns (m_event, (left_skip, right_skip)).
    """
    move = np.asarray(events["move"])
    n = len(events)
    nonstay = np.flatnonzero(move != 0)
    if len(nonstay) == 0:
        raise EventError("Remove too many bases on left")
    move0_left = int(nonstay[0])
    move0_right = int(nonstay[-1])
    # reference walks inward from both tails and rejects reads whose
    # non-stay span is too short (myDetect.py:168-180); the LEFT check
    # compares against the UNTRIMMED right end (move0_right is still n-1
    # there), which decides the attributed error class
    if move0_left > (n - 1) - 20:
        raise EventError("Remove too many bases on left")
    if move0_right < move0_left + 20:
        raise EventError("Remove too many bases on right")

    starts_sec = np.asarray(events["start"], np.float64)
    based_ind = starts_sec[move0_left] * sampling_rate - raw_start_time
    first_idx = np.round(starts_sec[move0_left] * sampling_rate).astype(
        np.int64
    ) - raw_start_time
    if first_idx < -2:
        raise EventError("The index of the first base is less than -2")
    if first_idx < 0:
        first_idx = 0
    first_idx = np.uint64(first_idx)

    # per-event lengths in samples, truncated per event exactly like
    # (length * rate).astype('uint64') in the reference
    lens_samples = (
        np.asarray(events["length"], np.float64) * sampling_rate
    ).astype(np.uint64)

    # the reference rounds np.float64 structured-array elements
    # (round(events_data['mean'][pre_i], 3), myDetect.py:199-231), which
    # under py3/modern numpy is numpy scalar __round__ = rint(x*1000)/1000
    # — NOT CPython's correctly-rounded decimal round (they differ at
    # doubles adjacent to .0005 midpoints, e.g. 2.6755; pinned against
    # the executed reference by tests/test_reference_differential.py)
    means3 = np.round(np.asarray(events["mean"], np.float64), 3)
    stdvs3 = np.round(np.asarray(events["stdv"], np.float64), 3)

    def state_of(i: int) -> str:
        s = events["model_state"][i]
        if isinstance(s, bytes):
            s = s.decode()
        return s.upper()

    out = []
    pre_i = move0_left
    cur_length = lens_samples[pre_i]

    def emit(i: int) -> None:
        nonlocal pre_i
        if pre_i == move0_left:
            out.append(
                (
                    float(means3[pre_i]),
                    float(stdvs3[pre_i]),
                    first_idx,
                    cur_length,
                    state_of(pre_i),
                )
            )
            return
        cal_st = (starts_sec[pre_i] - starts_sec[move0_left]) * sampling_rate + based_ind
        prev_end = np.uint64(out[-1][2]) + np.uint64(out[-1][3])
        gap_f = cal_st - float(prev_end)
        mean3 = float(means3[pre_i])
        stdv3 = float(stdvs3[pre_i])
        st = state_of(pre_i)
        if cal_st > 0 and gap_f > 0 and np.uint64(gap_f) > 0:
            gap = np.uint64(gap_f)
            if gap > 2:
                # insert a gap-filler pseudo-event then the real one
                out.append((mean3, stdv3, prev_end, gap, st))
                out.append((mean3, stdv3, np.uint64(cal_st), cur_length, st))
            else:
                out.append((mean3, stdv3, prev_end, gap + cur_length, st))
        else:
            out.append((mean3, stdv3, prev_end, cur_length, st))

    for i in range(move0_left + 1, move0_right + 1):
        if move[i] > 0:
            emit(i)
            pre_i = i
            cur_length = lens_samples[i]
        else:
            cur_length = cur_length + lens_samples[i]
    emit(move0_right + 1)  # final pending event (index unused by emit)

    m_event = np.array(out, dtype=EVENT_DTYPE)
    return m_event, (move0_left, n - move0_right - 1)


def collapse_events_v2(events: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Albacore v2 'simple': stay collapse with sample-index starts
    (myDetect.py:239-259). Vectorized with reduceat over stay groups."""
    move = np.asarray(events["move"])
    n = len(events)
    if n == 0:
        # reduceat on an empty table would raise a raw IndexError (the
        # reference crashes the same way at myDetect.py:243); surface the
        # standard error class so the census counts the file instead
        raise EventError("No events data")
    # group leaders: event 0 plus every later non-stay event
    leaders = np.flatnonzero(move > 0)
    if len(leaders) == 0 or leaders[0] != 0:
        leaders = np.concatenate([[0], leaders[leaders > 0]])
    lens = np.asarray(events["length"]).astype(np.uint64)
    group_len = np.add.reduceat(lens, leaders)
    states = events["model_state"][leaders]
    if states.dtype.kind == "S":
        # ASCII-only widen (bytes -> uint32 codepoints -> U5 view): the
        # 5-mers are ACGT/N so this equals np.char.decode at ~1% the cost
        width = states.dtype.itemsize
        states = np.ascontiguousarray(
            np.ascontiguousarray(states)
            .view(np.uint8)
            .reshape(-1, width)
            .astype(np.uint32)
        ).view(f"<U{width}").reshape(-1)
    m_event = np.empty(len(leaders), dtype=EVENT_DTYPE)
    m_event["mean"] = np.round(np.asarray(events["mean"], np.float64)[leaders], 3)
    m_event["stdv"] = np.round(np.asarray(events["stdv"], np.float64)[leaders], 3)
    m_event["start"] = np.asarray(events["start"])[leaders].astype(np.uint64)
    m_event["length"] = group_len
    m_event["model_state"] = states
    return m_event, (0, 0)


def _get_extreme_n(
    m_signal_dif: np.ndarray,
    n_splits: int,
    p_signal_start: int,
    p_signal_end: int,
    min_signal_num: int,
) -> list:
    """Top-N change points spaced >= min_signal_num apart
    (EventTable.py:7-19)."""
    lo = int(p_signal_start - min_signal_num + 0.5)
    hi = int(p_signal_end - min_signal_num + 0.5)
    order = m_signal_dif[lo:hi].argsort()[::-1] + p_signal_start
    blocked = set()
    blocked.update(range(int(p_signal_start), int(p_signal_start + min_signal_num - 0.5)))
    blocked.update(range(int(p_signal_end - min_signal_num + 1.5), int(p_signal_end)))
    split_points = []
    for c_pos in order:
        if c_pos not in blocked:
            split_points.append(int(c_pos))
            if len(split_points) == n_splits:
                break
            blocked.update(range(c_pos - min_signal_num + 1, c_pos + min_signal_num + 1))
    return sorted(split_points)


def resegment_events(
    events: np.ndarray, raw_signals: np.ndarray, fq_seq: str
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """'rundif' re-segmentation (EventTable.py:21-108).

    Re-splits the raw signal between consecutive non-stay events at the
    most extreme cumulative-difference points, guaranteeing each base at
    least min_signal_num=4 samples, then repairs under-sized splits by
    halving the following event.
    """
    min_signal_num = 4
    signal_sum = np.cumsum(np.insert(np.round(raw_signals / 50.0, 5), 0, 0))
    m_signal_dif = np.abs(
        signal_sum[min_signal_num:-min_signal_num] * 2
        - signal_sum[: -2 * min_signal_num]
        - signal_sum[2 * min_signal_num :]
    )

    event_info = []
    last_signal_i = int(events[0]["start"])
    fq_seq_i = 2
    c_move_num = 1
    incorrect = []
    for ev_i in range(1, len(events)):
        if events["move"][ev_i] == 0:
            continue
        c_move_num += int(events["move"][ev_i])
        split_points = _get_extreme_n(
            m_signal_dif,
            c_move_num - 1,
            last_signal_i,
            int(events[ev_i]["start"] + events[ev_i]["length"]),
            min_signal_num,
        )
        for c_m_i in range(c_move_num - 1):
            if c_m_i < len(split_points):
                c_e_p = split_points[c_m_i]
            else:
                c_e_p = last_signal_i + min_signal_num
                incorrect.append(len(event_info))
            seg = raw_signals[last_signal_i:c_e_p]
            event_info.append(
                (
                    float(np.mean(seg)),
                    float(np.std(seg)),
                    last_signal_i,
                    c_e_p - last_signal_i,
                    fq_seq[fq_seq_i - 2 : fq_seq_i + 3],
                )
            )
            last_signal_i = split_points[min(c_m_i, len(split_points) - 1)]
            fq_seq_i += 1
        c_move_num = 1
    ev_i = len(events) - 1
    c_e_p = int(events[ev_i]["start"] + events[ev_i]["length"])
    seg = raw_signals[last_signal_i:c_e_p]
    event_info.append(
        (
            float(np.mean(seg)),
            float(np.std(seg)),
            last_signal_i,
            c_e_p - last_signal_i,
            fq_seq[fq_seq_i - 2 : fq_seq_i + 3],
        )
    )
    out = np.array(event_info, dtype=EVENT_DTYPE)
    # repair undersized splits by halving into the next event
    # (EventTable.py:95-101)
    for c_ev_i in incorrect:
        h_2 = int(
            (out[c_ev_i + 1]["length"] + out[c_ev_i + 1]["start"] - out[c_ev_i]["start"]) / 2
            + 0.2
        )
        out[c_ev_i]["length"] = h_2
        out[c_ev_i + 1]["start"] = out[c_ev_i]["start"] + out[c_ev_i]["length"]
        out[c_ev_i + 1]["length"] = out[c_ev_i + 1]["length"] - h_2
    return out, (0, 0)


def move_table_events(
    move_data: np.ndarray,
    raw_signals: np.ndarray,
    fq_seq: str,
    first_sample_template: int,
    stride: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Guppy Move-table events (MoveTable.py:7-50).

    Builds one event per base: boundaries at stride*i + first for each
    move==1, 5-mer model_state cut from the fastq with N padding at the
    read ends. The reference hardcodes stride 2 (MoveTable.py:31-43).

    The boundaries are found in one numpy pass (the reference walks the move
    table in python); start, length and model_state are the reference's,
    and a table with more moves than bases or a negative start or length
    raises ValueError where the reference fails. Mean and stdv are left
    0: the reference's per-event ``np.mean``/``np.std`` of the raw
    signal are overwritten by the normalized signal's
    (``normalize_and_event_stats``) before anything reads them, and they
    were most of the host stage's time on move tables.
    """
    nrow = len(fq_seq)
    nsig = len(raw_signals)
    first = int(first_sample_template)
    moves = np.asarray(move_data)
    ends = stride * (np.flatnonzero(moves[1:] == 1) + 1) + first
    n = len(ends) + 1
    starts = np.concatenate([[first], ends]).astype(np.int64)
    lengths = np.concatenate([ends, [nsig]]) - starts
    # the reference fails on these too (with numpy's IndexError or
    # OverflowError); every caller files them as an open error
    if n > nrow or first < 0 or lengths[-1] < 0:
        raise ValueError(
            f"move table: {n} events for {nrow} bases, first sample "
            f"{first}, last length {int(lengths[-1])}"
        )

    def kmer(i: int) -> str:
        if i == 0:
            return "N" * 2 + fq_seq[0:3]
        if i == 1:
            return "N" + fq_seq[0:4]
        if i == nrow - 2:
            return fq_seq[i - 2 : i + 2] + "N"
        return fq_seq[i - 2 : i + 3]

    move_info = np.zeros(n, dtype=EVENT_DTYPE)
    move_info["start"] = starts
    move_info["length"] = lengths
    move_info["model_state"] = [kmer(i) for i in range(n - 1)] + [
        fq_seq[n - 3 : n] + "N" * 2
    ]
    return move_info, (0, 0)
