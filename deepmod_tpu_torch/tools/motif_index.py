"""Genome motif-position index generator
(DeepMod_tools/generate_motif_pos.py equivalent, vectorized).

Per chromosome writes:
- ``na_<chr>_<base>.bed``: every position whose base equals the target
  base ('+') or whose complement does ('-'), tab-separated
  (generate_motif_pos.py:60-62);
- ``motif_<chr>_<base>.bed``: for each target-base position where the
  motif matches at the configured offset, a '+' line at the position and
  a '-' line at position+1 (the CpG-pairing convention of :66-72).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from deepmod_tpu_torch.io.fasta import read_fasta
from deepmod_tpu_torch.utils.common import COMPLEMENT


def generate_motif_positions(
    ref_fasta: str,
    out_folder: str,
    motif: str = "CG",
    base: str = "C",
    mod_offset: int = 0,
    chrs: Optional[Sequence[str]] = None,
) -> int:
    os.makedirs(out_folder, exist_ok=True)
    genome = read_fasta(ref_fasta)
    written = 0
    for chrom, seq in genome.items():
        if chrs is not None and chrom not in chrs:
            continue
        codes = np.frombuffer(seq.encode(), np.uint8)
        n = len(codes)
        plus = codes == ord(base)
        comp_base = COMPLEMENT.get(base, base)
        minus = codes == ord(comp_base)

        na_path = os.path.join(out_folder, f"na_{chrom}_{base}.bed")
        with open(na_path, "w") as fh:
            # union in genomic order, '+' wins at ambiguous positions
            # (reference checks base first, :60-62)
            hits = np.flatnonzero(plus | minus)
            strands = np.where(plus[hits], "+", "-")
            for pos, strand in zip(hits, strands):
                fh.write(f"{chrom}\t{pos}\t{strand}\n")

        # motif hits anchored at the target base (motif start = pos-offset)
        motif_mask = np.zeros(n, bool)
        if len(motif) <= n:
            window_ok = np.ones(n - len(motif) + 1, bool)
            for k, ch in enumerate(motif):
                window_ok &= codes[k : n - len(motif) + 1 + k] == ord(ch)
            starts = np.flatnonzero(window_ok)
            anchors = starts + mod_offset
            motif_mask[anchors] = True
        motif_mask &= plus
        motif_path = os.path.join(out_folder, f"motif_{chrom}_{base}.bed")
        with open(motif_path, "w") as fh:
            for pos in np.flatnonzero(motif_mask):
                fh.write(f"{chrom}\t{pos}\t+\n")
                fh.write(f"{chrom}\t{pos + 1}\t-\n")
        written += 2
    return written
