"""Label sources for training-feature extraction.

Two ways the reference assigns modification labels
(myGetFeatureBasedPos.py:615-698):

- motif scan (``--motifORPos 1``): every occurrence of a motif (e.g. CG at
  offset 0) on either strand of the reference becomes a fully-modified
  position for the positive sample / a trustworthy negative for the
  control sample;
- position files (``--motifORPos 2``): fulmod/anymod/nomod files from e.g.
  bisulfite sequencing, whitespace columns (chr, strand, pos).

Label sets are plain ``{rname: set[(strand, pos)]}`` — the membership
tests downstream are the hot path and set hashing beats the reference's
nested defaultdicts.
"""

from __future__ import annotations

import glob as globmod
from typing import Dict, Optional, Set, Tuple

import numpy as np

from deepmod_tpu_torch.utils.common import reverse_complement

LabelSet = Dict[str, Set[Tuple[str, int]]]


def scan_motif(
    fadict: Dict[str, str],
    motif: str = "CG",
    mod_offset: int = 0,
    t_chr: Optional[str] = None,
    t_start: Optional[int] = None,
    t_end: Optional[int] = None,
) -> Tuple[LabelSet, LabelSet]:
    """Motif occurrences on both strands (readMotifMod,
    myGetFeatureBasedPos.py:615-647), vectorized.

    Returns (mod_positions, base_positions):
    - mod_positions[(strand, i)]: i is the modified base's position; a
      forward hit at motif start s yields ('+', s + mod_offset); a
      reverse-complement hit yields ('-', i) at the complementary offset.
    - base_positions: every position whose (strand-adjusted) base equals
      the modified base — the candidate-negative set.
    """
    motif = motif.upper()
    comp_motif = reverse_complement(motif)
    comp_offset = len(motif) - 1 - mod_offset
    mod_base = motif[mod_offset]
    comp_mod_base = reverse_complement(mod_base)

    mod_positions: LabelSet = {}
    base_positions: LabelSet = {}
    for rname, seq in fadict.items():
        if t_chr not in (None, rname):
            continue
        codes = np.frombuffer(seq.encode(), np.uint8)
        n = len(codes)

        def motif_hits(pat: str) -> np.ndarray:
            if len(pat) > n:
                return np.empty(0, np.int64)
            mask = np.ones(n - len(pat) + 1, bool)
            for k, ch in enumerate(pat):
                mask &= codes[k : n - len(pat) + 1 + k] == ord(ch)
            return np.flatnonzero(mask)

        fwd = motif_hits(motif) + mod_offset
        rev = motif_hits(comp_motif) + comp_offset
        lo = t_start if t_start is not None else -1
        hi = t_end if t_end is not None else n
        fwd = fwd[(fwd >= max(lo, 0)) & (fwd <= hi)]
        rev = rev[(rev >= max(lo, 0)) & (rev <= hi)]
        mods: Set[Tuple[str, int]] = set()
        mods.update(("+", int(i)) for i in fwd)
        mods.update(("-", int(i)) for i in rev)
        mod_positions[rname] = mods

        bases: Set[Tuple[str, int]] = set()
        plus = np.flatnonzero(codes == ord(mod_base))
        minus = np.flatnonzero(codes == ord(comp_mod_base))
        if t_start is not None or t_end is not None:
            plus = plus[(plus >= max(lo, 0)) & (plus <= hi)]
            minus = minus[(minus >= max(lo, 0)) & (minus <= hi)]
        bases.update(("+", int(i)) for i in plus)
        bases.update(("-", int(i)) for i in minus)
        base_positions[rname] = bases
    return mod_positions, base_positions


def read_position_files(pattern: str) -> LabelSet:
    """Read BED-ish (chr, strand, pos) files matching a glob pattern
    (myGetFeatureBasedPos.py:686-698)."""
    out: LabelSet = {}
    for path in globmod.glob(pattern):
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 3:
                    continue
                chrom, strand, pos = parts[0], parts[1], int(parts[2])
                out.setdefault(chrom, set()).add((strand, pos))
    return out
