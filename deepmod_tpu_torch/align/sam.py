"""SAM records and the reference's alignment-record filter.

The reference parses aligner stdout line-by-line (myDetect.py:437-447) and
keeps, per read, the best-mapq record that passes basic sanity checks
(handle_line, myDetect.py:929-943; duplicated at
myGetFeatureBasedPos.py:541-559).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int        # 1-based as in SAM
    mapq: int
    cigar: str
    seq: str
    # optional pre-parsed (nums, op_codes) int64 arrays in cigar._OPS
    # order; producers that already hold the runs (built-in aligner, BAM
    # reader) attach them so expand_alignment can skip the string re-parse
    cigar_arrays: Optional[Tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def strand(self) -> str:
        return "-" if self.is_reverse else "+"


def parse_sam_line(line: str) -> Optional[SamRecord]:
    if not line or line.startswith("@"):
        return None
    parts = line.rstrip("\n").split("\t")
    if len(parts) < 11:
        return None
    qname, flag, rname, pos, mapq, cigar = parts[:6]
    seq = parts[9]
    return SamRecord(
        qname=qname,
        flag=int(flag),
        rname=rname,
        pos=int(pos),
        mapq=int(mapq),
        cigar=cigar,
        seq=seq,
    )


def record_filter_status(rec: SamRecord) -> str:
    """Reference rejection reasons, verbatim (myDetect.py:933-937)."""
    if rec.qname == "*":
        return "qname is *"
    if rec.mapq == 255:
        return "mapq is 255"
    if rec.pos == 0:
        return "pos is 0"
    if rec.cigar == "*":
        return "cigar is *"
    if rec.rname == "*":
        return "rname is *"
    return ""


def filter_best_alignments(
    records: Iterable[SamRecord],
) -> Dict[str, SamRecord]:
    """Best-mapq record per qname among records passing the sanity filter
    (myDetect.py:940-941: replace only when stored mapq < new mapq)."""
    best: Dict[str, SamRecord] = {}
    for rec in records:
        if record_filter_status(rec):
            continue
        prev = best.get(rec.qname)
        if prev is None or prev.mapq < rec.mapq:
            best[rec.qname] = rec
    return best
