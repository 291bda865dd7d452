"""Multi-run BED merger (DeepMod_tools/sum_chr_mod.py equivalent).

Users who shard a big run across independent detect invocations (distinct
--FileID / folders) merge the per-run ``mod_pos.<chr><strand>.<base>.bed``
files per chromosome: counts are summed per (chr, pos, strand), rows with
modcount==0 are DROPPED, and the merged line uses the tool's own format —
single-space fields except TWO spaces after the strand column
(sum_chr_mod.py:61-63).
"""

from __future__ import annotations

import glob as globmod
import os
from typing import Dict, List, Optional, Tuple

BedCounts = Dict[Tuple[str, int, str], List[int]]

DEFAULT_CHRS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY", "chrM"]


def read_bed_counts(path: str) -> BedCounts:
    """(chr, pos, strand) -> [coverage, modcount] (readbed2,
    sum_chr_mod.py:36-44)."""
    out: BedCounts = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 12:
                continue
            out[(parts[0], int(parts[1]), parts[5])] = [
                int(parts[9]), int(parts[11])
            ]
    return out


def merge_bed_dicts(dest: BedCounts, src: BedCounts) -> None:
    """In-place associative merge (mergeMod, sum_chr_mod.py:46-52)."""
    for key, (cov, mod) in src.items():
        if key in dest:
            dest[key][0] += cov
            dest[key][1] += mod
        else:
            dest[key] = [cov, mod]


def save_merged(path: str, counts: BedCounts, base: str) -> int:
    """save_mod (sum_chr_mod.py:54-63): drop modcount==0 rows, sorted keys,
    '%s %d %d %s %d %s  %d %d 0,0,0 %d %d %d' with the double space."""
    keys = sorted(k for k, v in counts.items() if v[1] != 0)
    with open(path, "w") as fh:
        for key in keys:
            chrom, pos, strand = key
            cov, mod = counts[key]
            pct = int(mod * 100 / cov) if cov > 0 else 0
            fh.write(
                "%s %d %d %s %d %s  %d %d 0,0,0 %d %d %d\n"
                % (chrom, pos, pos + 1, base,
                   cov if cov < 1000 else 1000, strand, pos, pos + 1,
                   cov, pct, mod)
            )
    return len(keys)


def merge_runs(
    pred_folder: str,
    base: str,
    file_id: str,
    chrs: Optional[str] = None,
) -> int:
    """Merge all runs under pred_folder per chromosome; returns the number
    of merged BED files written (sum_amod_handler, sum_chr_mod.py:66-93)."""
    chr_list = chrs.split(",") if chrs else DEFAULT_CHRS
    written = 0
    for chrom in sorted(set(chr_list)):
        files: List[str] = []
        for strand in ("-", "+"):
            for depth in ("*/*/*/", "*/*/", "*/"):
                files.extend(
                    globmod.glob(
                        os.path.join(
                            pred_folder,
                            f"{depth}*.{chrom}{strand}.{base}.bed",
                        )
                    )
                )
        if not files:
            continue
        merged: BedCounts = {}
        for path in files:
            merge_bed_dicts(merged, read_bed_counts(path))
        out = os.path.join(pred_folder, f"{file_id}.{chrom}.{base}.bed")
        save_merged(out, merged, base)
        written += 1
    return written
