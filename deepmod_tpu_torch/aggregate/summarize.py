"""Per-genomic-position modification summaries and BED emission.

Replicates the reference summarizer (sum_handler, myDetect.py:1028-1120):
for each (chr, strand, position) of the base of interest, coverage = reads
whose readbase != '-', modified = rows with mod_pred == 1, written as a
BED line with the reference's exact formatting (space-separated fields
with a trailing space, coverage capped at 1000 in column 5, integer
truncated percent, myDetect.py:1107-1120).

The reference accumulates into Python dicts per position; here counts are
dense int64 vectors per (chr, strand) filled with np.bincount — and, on
device, the same reduction is a segment-sum + psum across the mesh
(deepmod_tpu_torch.parallel.aggregation) so multi-host merges ride the ICI
instead of the filesystem.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from deepmod_tpu_torch.align.cigar import BaseMapResult


CHUNK_BITS = 22  # 4M-position chunks for lazily allocated chromosomes
CHUNK = 1 << CHUNK_BITS
# chromosomes below this allocate dense arrays outright; above (human-sized)
# they allocate 4M-position chunks on first touch so a whole-genome run
# holds memory proportional to covered regions, not genome length
DENSE_LIMIT = 1 << 26


class PositionCounts:
    """Per-position counters for one (chr, strand).

    Dense for small chromosomes; chunk-lazy for human-scale ones. The
    update/readout API is the same either way:
    - ``add(seen_pos, covered_pos, modded_pos)``: vectorized accumulate;
    - ``iter_seen()``: sorted (pos, coverage, mod_count) for BED emission;
    - ``merge(other)``: associative combine.
    """

    def __init__(self, length: int):
        self.length = length
        self.dense = length <= DENSE_LIMIT
        if self.dense:
            self.coverage = np.zeros(length, np.int32)
            self.mod_count = np.zeros(length, np.int32)
            self.seen = np.zeros(length, bool)
        else:
            self._chunks: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @classmethod
    def zeros(cls, length: int) -> "PositionCounts":
        return cls(length)

    def _chunk(self, cid: int):
        entry = self._chunks.get(cid)
        if entry is None:
            entry = (
                np.zeros(CHUNK, np.int32),
                np.zeros(CHUNK, np.int32),
                np.zeros(CHUNK, bool),
            )
            self._chunks[cid] = entry
        return entry

    def add(
        self,
        seen_pos: np.ndarray,
        covered_pos: np.ndarray,
        modded_pos: np.ndarray,
    ) -> None:
        if self.dense:
            # np.add.at touches only the hit positions; a bincount here
            # would allocate a full-chromosome temporary per read
            self.seen[seen_pos] = True
            np.add.at(self.coverage, covered_pos, 1)
            np.add.at(self.mod_count, modded_pos, 1)
            return
        for pos, field in ((seen_pos, 2), (covered_pos, 0), (modded_pos, 1)):
            if len(pos) == 0:
                continue
            cids = pos >> CHUNK_BITS
            for cid in np.unique(cids):
                local = pos[cids == cid] & (CHUNK - 1)
                arrays = self._chunk(int(cid))
                if field == 2:
                    arrays[2][local] = True
                else:
                    np.add.at(arrays[field], local, 1)

    def add_base_map(self, base_map: np.ndarray, target_base: str) -> None:
        """Accumulate one read's predictions (rules of myDetect.py:1089-1100)."""
        is_target = base_map["refbase"] == target_base
        seen_pos = base_map["refbasei"][is_target].astype(np.int64)
        sel = is_target & (base_map["readbase"] != "-")
        covered_pos = base_map["refbasei"][sel].astype(np.int64)
        modded_pos = covered_pos[base_map["mod_pred"][sel] == 1]
        self.add(seen_pos, covered_pos, modded_pos)

    def merge(self, other: "PositionCounts") -> None:
        if self.dense and other.dense:
            if other.length > self.length:
                self._grow(other.length)
            self.coverage[: other.length] += other.coverage
            self.mod_count[: other.length] += other.mod_count
            self.seen[: other.length] |= other.seen
            return
        if not self.dense and not other.dense:
            # chunk-wise vector adds — this is the multi-worker reduction,
            # a per-position python loop here costs minutes per chromosome
            for cid, (cov, mod, seen) in other._chunks.items():
                dcov, dmod, dseen = self._chunk(cid)
                dcov += cov
                dmod += mod
                dseen |= seen
            return
        # mixed dense/chunked (different DENSE_LIMIT classification can
        # only happen across versions); COO transfer is O(seen positions)
        self.add_coo(*other.to_coo())

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sparse view: (positions, coverage, mod_count) int64/int32/int32
        arrays over SEEN positions, in position order. The wire format for
        cross-process merges (parallel.cross_process)."""
        if self.dense:
            pos = np.flatnonzero(self.seen).astype(np.int64)
            return pos, self.coverage[pos], self.mod_count[pos]
        parts = []
        for cid in sorted(self._chunks):
            cov, mod, seen = self._chunks[cid]
            local = np.flatnonzero(seen)
            parts.append(
                ((cid << CHUNK_BITS) + local.astype(np.int64),
                 cov[local], mod[local])
            )
        if not parts:
            empty = np.empty(0, np.int64)
            return empty, np.empty(0, np.int32), np.empty(0, np.int32)
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
        )

    def add_coo(
        self, pos: np.ndarray, cov: np.ndarray, mod: np.ndarray
    ) -> None:
        """Accumulate sparse counts (positions may repeat)."""
        if len(pos) == 0:
            return
        if self.dense:
            self.seen[pos] = True
            np.add.at(self.coverage, pos, cov.astype(np.int32))
            np.add.at(self.mod_count, pos, mod.astype(np.int32))
            return
        cids = pos >> CHUNK_BITS
        for cid in np.unique(cids):
            m = cids == cid
            local = pos[m] & (CHUNK - 1)
            dcov, dmod, dseen = self._chunk(int(cid))
            dseen[local] = True
            np.add.at(dcov, local, cov[m].astype(np.int32))
            np.add.at(dmod, local, mod[m].astype(np.int32))

    def _grow(self, length: int) -> None:
        assert self.dense
        coverage = np.zeros(length, np.int32)
        mod_count = np.zeros(length, np.int32)
        seen = np.zeros(length, bool)
        coverage[: self.length] = self.coverage
        mod_count[: self.length] = self.mod_count
        seen[: self.length] = self.seen
        self.coverage, self.mod_count, self.seen = coverage, mod_count, seen
        self.length = length

    def iter_seen(self):
        """Yield (pos, coverage, mod_count) in position order."""
        if self.dense:
            for pos in np.flatnonzero(self.seen):
                yield int(pos), int(self.coverage[pos]), int(self.mod_count[pos])
            return
        for cid in sorted(self._chunks):
            cov, mod, seen = self._chunks[cid]
            base = cid << CHUNK_BITS
            for local in np.flatnonzero(seen):
                yield base + int(local), int(cov[local]), int(mod[local])

    def nbytes(self) -> int:
        if self.dense:
            return self.coverage.nbytes + self.mod_count.nbytes + self.seen.nbytes
        return sum(
            c.nbytes + m.nbytes + s.nbytes for c, m, s in self._chunks.values()
        )


CountsMap = Dict[Tuple[str, str], PositionCounts]


def accumulate_base_map(
    counts: CountsMap,
    bmr: BaseMapResult,
    target_base: str,
    chrom_length: int,
) -> None:
    """Add one read's predictions into the per-position counters.

    Rules from myDetect.py:1089-1100: only rows whose refbase equals the
    target base count; rows with refbase in '-','N','n' are skipped;
    coverage increments when readbase != '-'; mod_count when mod_pred==1
    (within covered rows).
    """
    key = (bmr.rname, bmr.strand)
    if key not in counts:
        counts[key] = PositionCounts.zeros(chrom_length)
    counts[key].add_base_map(bmr.base_map, target_base)


def merge_counts(dest: CountsMap, src: CountsMap) -> None:
    """Associative merge (the all-reduce the reference does via BED files,
    sum_chr_mod.py:47-52)."""
    for key, pc in src.items():
        if key not in dest:
            dest[key] = PositionCounts.zeros(pc.length)
        dest[key].merge(pc)


def bed_line(
    chrom: str, strand: str, pos: int, base: str, coverage: int, mod_count: int
) -> str:
    """One output line, byte-identical to myDetect.py:1113-1120.

    Fields joined by single spaces INCLUDING a trailing '\n' element, so
    every line ends with ' \n'.
    """
    percent = int(100 * mod_count / (coverage if coverage > 0 else 1))
    fields = [
        chrom,
        str(pos),
        str(pos + 1),
        base,
        str(1000 if coverage > 1000 else coverage),
        strand,
        str(pos),
        str(pos + 1),
        "0,0,0",
        str(coverage),
        str(percent),
        str(mod_count),
        "\n",
    ]
    return " ".join(fields)


def write_bed(
    path: str,
    chrom: str,
    strand: str,
    base: str,
    pc: PositionCounts,
) -> int:
    """Write mod_pos BED for one (chr, strand); returns line count.

    Emits every position that appeared in any read's base map (the
    reference creates a dict entry per target-base row even for deletion
    rows with coverage 0, myDetect.py:1092-1094). Sorted by position like
    the reference's sorted dict keys (myDetect.py:1110-1111).
    """
    written = 0
    with open(path, "w") as fh:
        for pos, coverage, mod_count in pc.iter_seen():
            fh.write(bed_line(chrom, strand, pos, base, coverage, mod_count))
            written += 1
    return written


def read_bed(path: str) -> Dict[Tuple[str, str, int], Tuple[int, int]]:
    """Parse a mod_pos BED back into {(chr, strand, pos): (cov, mod)}."""
    out: Dict[Tuple[str, str, int], Tuple[int, int]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 12:
                continue
            out[(parts[0], parts[5], int(parts[1]))] = (
                int(parts[9]), int(parts[11])
            )
    return out
