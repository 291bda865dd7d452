"""Training-time labeled feature construction.

Reproduces the labeled get_Feature variant
(myGetFeatureBasedPos.py:355-528) on top of the shared detect-time
feature matrix (deepmod_tpu_torch.features.builder):

- alignment-quality gating of methylated sites: a fulmod site only
  becomes a positive label when its +-3/+-6 neighborhood has at most 2/3
  gap columns (checkratios, :372-374); rejected sites and their
  neighborhoods join the not-used set;
- motif-mismatch masking: read positions matching the motif where the
  reference does NOT carry the motif poison their neighborhood (:380-383);
- label columns: col 1 = negative, col 2 = positive, with the
  posneg==0 / posneg==1 rules of :469-488;
- window truncation: keep only rows within +-25 of a labeled row unless
  that keeps >90% of the matrix (:513-526).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Set, Tuple

import numpy as np

from deepmod_tpu_torch.align.cigar import BaseMapResult
from .builder import build_feature_matrix
from .labels import LabelSet


@dataclasses.dataclass
class LabelOptions:
    posneg: int = 0
    fulmod: Optional[LabelSet] = None
    anymod: Optional[LabelSet] = None
    nomod: Optional[LabelSet] = None
    motif: Optional[str] = None       # e.g. 'CG'
    mod_offset: int = 0
    affect_neighbor: int = 1          # :376
    truncate_margin: int = 25         # :516


# gap-count thresholds per check window (myGetFeatureBasedPos.py:373-374;
# the second assignment in the reference wins)
_CHECK_WINDOWS = (3, 6)
_MAX_GAPS = {3: 2, 6: 3}


def _quality_gate(
    bmr: BaseMapResult, opts: LabelOptions
) -> Tuple[Set[int], Set[int]]:
    """Row-index sets (methylated, not-used) — the cgpos pair (:377-444).

    Returned as BASE-MAP ROW indices; the caller converts to (strand,
    refpos) space for label assignment, matching the reference which
    stores (strand, refbasei) tuples.
    """
    bm = bmr.base_map
    refbase = bm["refbase"]
    readbase = bm["readbase"]
    n = len(bm)
    strand = bmr.strand
    fulmod = (opts.fulmod or {}).get(bmr.rname, set())
    aff = opts.affect_neighbor

    meth_rows: Set[int] = set()
    unused_rows: Set[int] = set()

    # motif-mismatch poisoning (:380-383), vectorized: a hit poisons its
    # neighborhood when the READ window equals the motif but the REF
    # window does not (shifted elementwise compares replace the per-hit
    # string building)
    if opts.motif:
        motif = opts.motif
        mpos = opts.mod_offset
        hits = np.flatnonzero(readbase == motif[mpos])
        hits = hits[(hits - mpos > -1) & (hits + len(motif) - mpos <= n)]
        if len(hits):
            read_eq = np.ones(len(hits), bool)
            ref_eq = np.ones(len(hits), bool)
            for k in range(len(motif)):
                idx = hits - mpos + k
                read_eq &= readbase[idx] == motif[k]
                ref_eq &= refbase[idx] == motif[k]
            for aligni in hits[read_eq & ~ref_eq]:
                lo = max(int(aligni) - aff, 0)
                hi = min(int(aligni) + aff + 1, n)
                unused_rows.update(range(lo, hi))

    if not fulmod:
        return meth_rows, unused_rows

    # membership of each non-gap row's (strand, refpos) in fulmod,
    # vectorized against a per-(rname,strand) sorted position array
    # (cached on opts — a python set probe per row dominated this gate)
    pos_arr = _strand_pos_cached(opts, "fulmod", fulmod, bmr.rname, strand)
    is_fulmod = np.zeros(n, bool)
    ng_idx = np.flatnonzero(refbase != "-")
    if len(ng_idx) and len(pos_arr):
        refpos = bm["refbasei"][ng_idx].astype(np.int64)
        is_fulmod[ng_idx[_in_sorted(refpos, pos_arr)]] = True

    is_gap_col = (refbase == "-") | (readbase == "-")
    is_match_col = refbase == readbase

    for aligni in np.flatnonzero(is_fulmod):
        aligni = int(aligni)
        if readbase[aligni] != "-":
            nextnogap = aligni + 1
            while nextnogap < n and refbase[nextnogap] == "-":
                nextnogap += 1
            iscg = False
            for w in _CHECK_WINDOWS:
                if not nextnogap < n:
                    continue
                lo = max(aligni - w, 0)
                hi = min(aligni + w + 1, n)
                gapnum = int(is_gap_col[lo:hi].sum())
                if gapnum <= _MAX_GAPS[w]:
                    lo2 = max(aligni - aff, 0)
                    hi2 = min(nextnogap + aff, n)
                    for addi in range(lo2, hi2):
                        if addi == aligni:
                            meth_rows.add(addi)
                        else:
                            unused_rows.add(addi)
                    iscg = True
                    break
            if iscg:
                continue
            # rejected site: poison an expanded neighborhood (:411-444)
            nextng = aligni
            for _ in range(aff):
                nextng += 1
                while nextng < n and refbase[nextng] == "-":
                    nextng += 1
            preng = aligni
            for _ in range(aff):
                preng -= 1
                while preng > -1 and refbase[preng] == "-":
                    preng -= 1
            read0 = aligni
            read1 = aligni
            for _ in range(aff):
                read0 -= 1
                while read0 > -1 and readbase[read0] == "-":
                    read0 -= 1
                read1 += 1
                while read1 < n and readbase[read1] == "-":
                    read1 += 1
            if read0 < preng:
                preng = read0 if read0 > -1 else 0
            if read1 > nextng:
                nextng = read1 if read1 < n else n - 1
            preng = max(preng, 0)
            nextng = min(nextng, n - 1)
            preng = min(preng, n - 1)
            unused_rows.update(range(preng, nextng + 1))
    return meth_rows, unused_rows


def build_labeled_features(
    m_event: np.ndarray,
    raw_signals: np.ndarray,
    basecall: str,
    bmr: BaseMapResult,
    opts: LabelOptions,
    fnum: int = 7,
    pad: int = 100,
) -> Optional[np.ndarray]:
    """Labeled per-event feature matrix, truncated to labeled windows.

    Returns None when no rows survive (the reference returns []).
    """
    mfeat, start_clip, end_clip = build_feature_matrix(
        m_event, raw_signals, basecall, bmr, fnum=fnum, pad=pad
    )
    n_aligned = len(m_event) - start_clip - end_clip
    bm = bmr.base_map
    strand = bmr.strand
    rname = bmr.rname

    meth_rows, unused_rows = _quality_gate(bmr, opts)
    # convert row sets to refpos space like cgpos (:404-409); strand is
    # constant per read so (strand, pos) keys reduce to positions
    meth_pos = _rows_to_pos(bm, meth_rows)
    unused_pos = _rows_to_pos(bm, unused_rows)

    fulmod = (opts.fulmod or {}).get(rname, set())
    anymod = None if opts.anymod is None else opts.anymod.get(rname, set())
    nomod = None if opts.nomod is None else opts.nomod.get(rname, set())
    fulmod_arr = _strand_pos_cached(opts, "fulmod", fulmod, rname, strand)
    anymod_arr = (
        None if anymod is None
        else _strand_pos_cached(opts, "anymod", anymod, rname, strand)
    )
    nomod_arr = (
        None if nomod is None
        else _strand_pos_cached(opts, "nomod", nomod, rname, strand)
    )

    nongap = np.flatnonzero(bm["readbase"] != "-")
    assert len(nongap) == n_aligned
    arows = pad + np.arange(n_aligned)  # feature-matrix rows of aligned events

    # vectorized label assignment — one membership probe per label source
    # instead of python set lookups per aligned row (:469-488 semantics,
    # pinned by the property tests)
    keypos = bm["refbasei"][nongap].astype(np.int64)
    if opts.posneg == 0:
        # control sample: trusted negatives (:469-476)
        neg = _in_sorted(keypos, fulmod_arr)
        if anymod_arr is not None and nomod_arr is not None:
            neg |= _in_sorted(keypos, nomod_arr)
        if anymod_arr is not None:
            neg |= _in_sorted(keypos, anymod_arr)
        mfeat[arows[neg], 1] = 1.0
    else:
        pos = _in_sorted(keypos, meth_pos) & (bm["refbase"][nongap] != "-")
        rest = ~pos & ~_in_sorted(keypos, unused_pos)
        if anymod_arr is None:
            neg = rest if nomod_arr is None else rest & _in_sorted(keypos, nomod_arr)
        else:
            neg = rest & ~_in_sorted(keypos, anymod_arr)
            if nomod_arr is not None:
                neg &= _in_sorted(keypos, nomod_arr)
        mfeat[arows[pos], 2] = 1.0
        mfeat[arows[neg], 1] = 1.0

    # truncation to +-25 rows around labeled rows (:513-526), as a
    # range-union via prefix sums
    labeled = np.flatnonzero(mfeat[:, 1] + mfeat[:, 2] > 0.9)
    if len(labeled) == 0:
        return None
    margin = opts.truncate_margin
    delta = np.zeros(len(mfeat) + 1, np.int32)
    np.add.at(delta, np.maximum(labeled - margin, 0), 1)
    np.add.at(delta, np.minimum(labeled + margin + 1, len(mfeat)), -1)
    keep_idx = np.flatnonzero(np.cumsum(delta[:-1]) > 0)
    if len(keep_idx) > len(mfeat) * 0.9:
        return mfeat
    return mfeat[keep_idx]


def _rows_to_pos(bm: np.ndarray, rows: Set[int]) -> np.ndarray:
    """Sorted unique refbasei values of a base-map row set."""
    if not rows:
        return np.empty(0, np.int64)
    idx = np.fromiter(rows, np.int64, len(rows))
    return np.unique(bm["refbasei"][idx].astype(np.int64))


def _in_sorted(values: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Membership of each value in a sorted array."""
    if len(sorted_arr) == 0:
        return np.zeros(len(values), bool)
    loc = np.searchsorted(sorted_arr, values)
    return (loc < len(sorted_arr)) & (
        sorted_arr[np.minimum(loc, len(sorted_arr) - 1)] == values
    )


def _strand_pos_cached(
    opts: LabelOptions, tag: str, label_set: Set[Tuple[str, int]],
    rname: str, strand: str,
) -> np.ndarray:
    """Sorted positions of one label source for (rname, strand), cached
    on the (worker-lifetime) LabelOptions."""
    cache = getattr(opts, "_label_pos_cache", None)
    if cache is None:
        cache = {}
        opts._label_pos_cache = cache
    key = (tag, rname, strand)
    arr = cache.get(key)
    if arr is None:
        arr = np.sort(np.fromiter(
            (p for s, p in label_set if s == strand), np.int64,
        ))
        cache[key] = arr
    return arr
