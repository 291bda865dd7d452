"""Minimizer index + seed-chain-extend read mapper (built-in aligner core).

The reference requires an external minimap2 or bwa binary and round-trips
reads through temp FASTA/SAM files per batch (myDetect.py:397-424). This
module provides the in-process replacement: a minimap2-style (k, w)
minimizer index over the reference genome, anchor chaining per strand,
and edit-distance stitching of inter-anchor gaps into a CIGAR
(deepmod_tpu_torch.align.dp). Everything host-side is vectorized numpy; this is
CPU feeding code, deliberately kept off the device.

Algorithm (standard minimizer mapping, written from scratch):
  1. 2-bit encode; rolling k-mer codes; mix with a splitmix64 finalizer.
  2. minimizers = per-window (w) minima of the hash sequence.
  3. query seeds on both strands; anchors grouped by diagonal; the best
     diagonal band wins; anchors in band are chained monotonically.
  4. gaps between anchors (and read tails) aligned by banded edit
     distance; runs merged into a CIGAR with soft-clipped tails.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepmod_tpu_torch.utils.common import reverse_complement
from .cigar import _OP_INDEX
from .dp import global_align_ops

try:
    from deepmod_tpu_torch.native.lib import minimizers_native as _native_minimizers
    from deepmod_tpu_torch.native.lib import chain_band_native as _native_chain
    from deepmod_tpu_torch.native.lib import (
        global_align_multi_bytes as _native_align_multi,
    )
    from deepmod_tpu_torch.native.lib import hash_index_native as _native_hash_index
except Exception:  # pragma: no cover
    _native_minimizers = None
    _native_chain = None
    _native_align_multi = None
    _native_hash_index = None
from .sam import SamRecord

_M_BYTE = ord("M")
_S_BYTE = ord("S")
# op byte -> cigar._OPS index, for attaching pre-parsed runs to SamRecord
_OP_BYTE_TO_INDEX = np.zeros(256, np.int64)
for _op, _idx in _OP_INDEX.items():
    _OP_BYTE_TO_INDEX[ord(_op)] = _idx

_BASE_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate("ACGT"):
    _BASE_CODE[ord(_b)] = _i
    _BASE_CODE[ord(_b.lower())] = _i


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


def _kmer_hashes(seq: str, k: int) -> np.ndarray:
    """Hashed k-mer codes; kmers containing non-ACGT get uint64 max."""
    codes = _BASE_CODE[np.frombuffer(seq.encode(), np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.uint64)
    valid = codes != 255
    codes64 = np.where(valid, codes, 0).astype(np.uint64)
    kmers = np.zeros(n, np.uint64)
    ok = np.ones(n, bool)
    for offset in range(k):
        kmers = (kmers << np.uint64(2)) | codes64[offset : offset + n]
        ok &= valid[offset : offset + n]
    hashes = _splitmix64(kmers)
    hashes[~ok] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return hashes


def _minimizers(seq: str, k: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, hashes) of (k, w) minimizers.

    Uses the C++ core when built (identical splitmix64 hashing and
    leftmost-min window semantics; pinned equal by tests/test_torch_native.py).
    """
    if _native_minimizers is not None:
        result = _native_minimizers(seq, k, w)
        if result is not None:
            return result
    hashes = _kmer_hashes(seq, k)
    if len(hashes) == 0:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    if len(hashes) <= w:
        pos = np.array([int(np.argmin(hashes))], np.int64)
        sel = hashes[pos]
        # an all-invalid-kmer sequence must yield NO minimizers (the BAD
        # sentinel would otherwise enter the index and match other all-N
        # sequences); mirrors the long path and the native core
        keep = sel != np.uint64(0xFFFFFFFFFFFFFFFF)
        return pos[keep], sel[keep]
    windows = np.lib.stride_tricks.sliding_window_view(hashes, w)
    mins = windows.argmin(axis=1) + np.arange(len(windows))
    pos = np.unique(mins)
    sel = hashes[pos]
    keep = sel != np.uint64(0xFFFFFFFFFFFFFFFF)
    return pos[keep], sel[keep]


@dataclasses.dataclass
class _Chain:
    rid: int          # reference sequence id
    strand: str
    anchors_q: np.ndarray
    anchors_r: np.ndarray
    score: int
    second_score: int = 0  # best non-adjacent diagonal band elsewhere
                           # (same-strand multi-mapping indicator)


class MinimizerIndex:
    """Reference-genome minimizer index (host-side, replicated per host)."""

    def __init__(self, seqs: Dict[str, str], k: int = 15, w: int = 10,
                 max_hits: int = 64):
        self.k = k
        self.w = w
        self.max_hits = max_hits
        self.names: List[str] = list(seqs.keys())
        # ONE copy of the genome per index, as bytes (the native DP reads
        # bytes directly; the python fallback decodes tiny slices) — a
        # parallel str list would double per-worker genome memory
        self.seqs_b: List[bytes] = [seqs[n].encode() for n in self.names]
        # hash -> concatenated (rid, pos) hit lists, built via sorting
        all_hash = []
        all_rid = []
        all_pos = []
        for rid, name in enumerate(self.names):
            pos, hsh = _minimizers(seqs[name], k, w)
            all_hash.append(hsh)
            all_rid.append(np.full(len(pos), rid, np.int32))
            all_pos.append(pos.astype(np.int64))
        hashes = np.concatenate(all_hash) if all_hash else np.empty(0, np.uint64)
        rids = np.concatenate(all_rid) if all_rid else np.empty(0, np.int32)
        positions = np.concatenate(all_pos) if all_pos else np.empty(0, np.int64)
        order = np.argsort(hashes, kind="stable")
        self._hashes = hashes[order]
        self._rids = rids[order]
        self._positions = positions[order]
        # native open-addressing table: O(1)/query vs searchsorted's
        # O(log n) — the log factor dominates lookups on large genomes
        self._table = (
            _native_hash_index(self._hashes)
            if _native_hash_index is not None
            else None
        )

    def lookup(self, query_hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """For each query hash, all index hits: (query_idx, rid, rpos)."""
        if self._table is not None:
            qidx, src = self._table.lookup(query_hashes, self.max_hits)
            return (
                qidx,
                self._rids[src].astype(np.int64),
                self._positions[src],
            )
        left = np.searchsorted(self._hashes, query_hashes, side="left")
        right = np.searchsorted(self._hashes, query_hashes, side="right")
        counts = np.minimum(right - left, self.max_hits)
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.int64),) * 3
        qidx = np.repeat(np.arange(len(query_hashes)), counts)
        # ragged ranges [l, l+c) for every query, fully vectorized
        cum_ends = np.cumsum(counts)
        offsets = (
            np.arange(total)
            - np.repeat(cum_ends - counts, counts)
            + np.repeat(left, counts)
        )
        return qidx, self._rids[offsets].astype(np.int64), self._positions[offsets]


def _best_chain(
    qpos: np.ndarray, rid: np.ndarray, rpos: np.ndarray, strand: str,
    band: int = 500,
) -> Optional[_Chain]:
    """Pick the densest diagonal band per rid and chain its anchors.

    The returned chain's ``second_score`` also reflects the strongest
    chain on any OTHER reference sequence (same strand): a read from a
    region duplicated across chromosomes must come back ambiguous, not
    as a confident unique mapping.
    """
    if len(qpos) == 0:
        return None
    best: Optional[_Chain] = None
    runner_up_score = 0
    for cur_rid in np.unique(rid):
        mask = rid == cur_rid
        q = qpos[mask]
        r = rpos[mask]
        if _native_chain is not None:
            native = _native_chain(q, r, band)
            if native is not None:
                keep_q_n, keep_r_n, second_n = native
                if len(keep_q_n) == 0:
                    continue
                chain = _Chain(
                    rid=int(cur_rid),
                    strand=strand,
                    anchors_q=keep_q_n,
                    anchors_r=keep_r_n,
                    score=len(keep_q_n),
                    second_score=second_n,
                )
                if best is None or chain.score > best.score:
                    if best is not None:
                        runner_up_score = max(runner_up_score, best.score)
                    best = chain
                else:
                    runner_up_score = max(runner_up_score, chain.score)
                continue
        diag = r - q
        # histogram diagonals into `band`-wide bins; densest bin wins
        bins = diag // band
        uniq, counts = np.unique(bins, return_counts=True)
        # consider the top bin together with each neighbor bin
        top = uniq[np.argmax(counts)]
        sel = (bins == top) | (bins == top - 1) | (bins == top + 1)
        # second-best band strength (non-adjacent bins): flags same-strand
        # repeats so map_read can lower mapq
        count_by_bin = dict(zip(uniq.tolist(), counts.tolist()))
        second = 0
        for b in uniq:
            if abs(int(b) - int(top)) <= 1:
                continue
            group = (
                count_by_bin.get(int(b) - 1, 0)
                + count_by_bin.get(int(b), 0)
                + count_by_bin.get(int(b) + 1, 0)
            )
            second = max(second, group)
        q_sel, r_sel = q[sel], r[sel]
        order = np.argsort(q_sel, kind="stable")
        q_sel, r_sel = q_sel[order], r_sel[order]
        # greedy monotonic chain: keep anchors with increasing rpos
        keep_q: List[int] = []
        keep_r: List[int] = []
        last_r = -1
        last_q = -1
        for qq, rr in zip(q_sel, r_sel):
            if rr > last_r and qq > last_q:
                keep_q.append(int(qq))
                keep_r.append(int(rr))
                last_r = int(rr)
                last_q = int(qq)
        if len(keep_q) == 0:
            continue
        chain = _Chain(
            rid=int(cur_rid),
            strand=strand,
            anchors_q=np.asarray(keep_q, np.int64),
            anchors_r=np.asarray(keep_r, np.int64),
            score=len(keep_q),
            second_score=second,
        )
        if best is None or chain.score > best.score:
            if best is not None:
                runner_up_score = max(runner_up_score, best.score)
            best = chain
        else:
            runner_up_score = max(runner_up_score, chain.score)
    if best is not None and runner_up_score > best.second_score:
        best = dataclasses.replace(best, second_score=runner_up_score)
    return best


class BuiltinAligner:
    """Map reads against a MinimizerIndex, emitting SAM-equivalent records."""

    def __init__(self, index: MinimizerIndex, min_chain_anchors: int = 3,
                 max_dp: int = 2000):
        self.index = index
        self.min_chain_anchors = min_chain_anchors
        # the gap/tail DP is a full O(n*m) matrix (16 MB at 2000x2000):
        # inter-anchor gaps beyond max_dp split the chain (densest run
        # kept) and tails beyond it are soft-clipped past the cap — one
        # unmappable 300 kb tail must not allocate a 360 GB matrix
        self.max_dp = max_dp

    def map_read(self, name: str, seq: str) -> Optional[SamRecord]:
        k = self.index.k
        candidates: List[_Chain] = []
        oriented = {"+": seq, "-": reverse_complement(seq)}
        for strand, oseq in oriented.items():
            pos, hsh = _minimizers(oseq, k, self.index.w)
            if len(pos) == 0:
                continue
            qidx, rid, rpos = self.index.lookup(hsh)
            chain = _best_chain(pos[qidx], rid, rpos, strand)
            if chain is not None and chain.score >= self.min_chain_anchors:
                candidates.append(chain)
        if not candidates:
            return None
        candidates.sort(key=lambda c: -c.score)
        chain = candidates[0]
        mapq = 60
        runner_up = chain.second_score
        if len(candidates) > 1:
            runner_up = max(runner_up, candidates[1].score)
        if runner_up >= 0.9 * chain.score:
            mapq = 3

        oseq = oriented[chain.strand]
        ref_b = self.index.seqs_b[chain.rid]
        # The alignment is a sequence of PIECES: exact-match M runs between
        # same-diagonal anchors, interleaved with DP segments (anchor gaps
        # + read tails), optionally bracketed by soft clips. All segments
        # run in ONE native DP call (per-call ctypes marshalling dominates
        # at the typical ~18 gaps/read) and the piece layout is computed
        # with vectorized numpy — no per-anchor Python loop.
        aq = chain.anchors_q
        ar = chain.anchors_r
        # break the chain at gaps the DP must not bridge (> max_dp on
        # either side) and keep the densest anchor run; the severed ends
        # fall into the (capped) tail handling below
        over = (np.diff(aq) > self.max_dp) | (np.diff(ar) > self.max_dp)
        if over.any():
            runs = np.split(np.arange(len(aq)), np.flatnonzero(over) + 1)
            best_run = max(runs, key=len)
            aq = aq[best_run[0] : best_run[-1] + 1]
            ar = ar[best_run[0] : best_run[-1] + 1]
            if len(aq) < self.min_chain_anchors:
                return None
        q0 = int(aq[0])
        r0 = int(ar[0])
        dq = np.diff(aq)
        body_is_seg = dq != np.diff(ar)
        n_body = len(dq)
        n_body_segs = int(body_is_seg.sum())

        # left tail: align (at most max_dp of) the read head against the
        # same-length ref window ending at the first anchor; bases past
        # the cap — and any overhang — become a leading soft clip
        head_len = min(q0, r0, self.max_dp)
        soft_left = q0 - head_len
        head_seg = head_len > 0
        head_r_start = r0 - head_len
        map_start = head_r_start if head_seg else r0

        # right tail (the last anchor's k-mer is an exact match)
        last_q = int(aq[-1]) + k
        last_r = int(ar[-1]) + k
        n_tail = len(oseq) - last_q
        tail_len = min(n_tail, len(ref_b) - last_r, self.max_dp)
        soft_right = n_tail - tail_len
        tail_seg = tail_len > 0
        tail_r_end = last_r + tail_len

        # DP segments in piece order: head, body gaps, tail
        segs = np.empty((n_body_segs + head_seg + tail_seg, 4), np.int64)
        si = 0
        if head_seg:
            segs[0] = (q0 - head_len, q0, head_r_start, r0)
            si = 1
        segs[si : si + n_body_segs, 0] = aq[:-1][body_is_seg]
        segs[si : si + n_body_segs, 1] = aq[1:][body_is_seg]
        segs[si : si + n_body_segs, 2] = ar[:-1][body_is_seg]
        segs[si : si + n_body_segs, 3] = ar[1:][body_is_seg]
        if tail_seg:
            segs[-1] = (last_q, last_q + tail_len, last_r, tail_r_end)

        # per-column op bytes for every DP segment, as one flat buffer
        raw = None
        if len(segs) and _native_align_multi is not None:
            raw = _native_align_multi(oseq.encode(), ref_b, segs)
        if raw is not None:
            buf, seg_lens = raw
            seg_lens = np.asarray(seg_lens, np.int64)
        else:
            seg_parts: List[np.ndarray] = []
            for qs, qe, rs, re in segs:
                runs = global_align_ops(oseq[qs:qe], ref_b[rs:re].decode())
                if runs:
                    chars = np.frombuffer(
                        "".join(op for op, _ in runs).encode(), np.uint8
                    )
                    counts = np.asarray([c for _, c in runs], np.int64)
                    seg_parts.append(np.repeat(chars, counts))
                else:
                    seg_parts.append(np.empty(0, np.uint8))
            buf = (
                np.concatenate(seg_parts)
                if seg_parts
                else np.empty(0, np.uint8)
            )
            seg_lens = np.asarray([len(b) for b in seg_parts], np.int64)

        # piece table: [soft_left?] [head seg?] body(M|seg)* M(k)
        #              [tail seg?] [soft_right?]  — a capped tail emits
        # BOTH its DP segment and the soft clip past the cap
        n_pieces = (
            (1 if soft_left else 0) + (1 if head_seg else 0) + n_body + 1
            + (1 if tail_seg else 0) + (1 if soft_right else 0)
        )
        piece_len = np.zeros(n_pieces, np.int64)
        piece_byte = np.full(n_pieces, _M_BYTE, np.uint8)
        piece_is_seg = np.zeros(n_pieces, bool)
        p = 0
        if soft_left:
            piece_len[p] = soft_left
            piece_byte[p] = _S_BYTE
            p += 1
        if head_seg:
            piece_is_seg[p] = True
            p += 1
        body = slice(p, p + n_body)
        piece_is_seg[body] = body_is_seg
        piece_len[body] = np.where(body_is_seg, 0, dq)
        p += n_body
        piece_len[p] = k
        p += 1
        if tail_seg:
            piece_is_seg[p] = True
            p += 1
        if soft_right:
            piece_len[p] = soft_right
            piece_byte[p] = _S_BYTE
        piece_len[piece_is_seg] = seg_lens

        # stitch per-column ops in piece order (ragged-range fills), then
        # run-length encode ONCE; the runs double as the pre-parsed cigar
        # arrays handed downstream (expand_alignment skips its regex
        # re-parse)
        offsets = np.empty(n_pieces + 1, np.int64)
        offsets[0] = 0
        np.cumsum(piece_len, out=offsets[1:])
        n_cols = int(offsets[-1])
        op_arr = np.empty(n_cols, np.uint8)
        cmask = ~piece_is_seg
        clens = piece_len[cmask]
        cidx = (
            np.arange(int(clens.sum()))
            - np.repeat(np.cumsum(clens) - clens, clens)
            + np.repeat(offsets[:-1][cmask], clens)
        )
        op_arr[cidx] = np.repeat(piece_byte[cmask], clens)
        if len(seg_lens):
            sidx = (
                np.arange(int(seg_lens.sum()))
                - np.repeat(np.cumsum(seg_lens) - seg_lens, seg_lens)
                + np.repeat(offsets[:-1][piece_is_seg], seg_lens)
            )
            op_arr[sidx] = buf
        bounds = np.concatenate(
            [[0], np.flatnonzero(op_arr[1:] != op_arr[:-1]) + 1, [n_cols]]
        )
        nums = np.diff(bounds).astype(np.int64)
        op_run_bytes = op_arr[bounds[:-1]]
        cigar = "".join(
            f"{c}{ch}"
            for c, ch in zip(nums.tolist(), op_run_bytes.tobytes().decode())
        )

        return SamRecord(
            qname=name,
            flag=16 if chain.strand == "-" else 0,
            rname=self.index.names[chain.rid],
            pos=map_start + 1,  # SAM is 1-based
            mapq=mapq,
            cigar=cigar,
            seq=oseq,
            cigar_arrays=(nums, _OP_BYTE_TO_INDEX[op_run_bytes]),
        )
