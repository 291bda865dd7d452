"""Summarize-only detection mode + inline CpG-cluster rescue.

``detect --predDet 0`` re-reads a previous run's per-read prediction
files (predetail HDF5 + per-chromosome index files) and rebuilds the
per-position BED summaries, exactly like the reference's sum_handler path
(myDetect.py:988-1120) — including the optional inline CpG-cluster rescue
(``--mod_cluster 1``): an unmethylated C whose +-12-base neighborhood has
>50% methylated CpGs flips to methylated (myDetect.py:1054-1087; the
reference marks it "should not used now" but ships it, so we do too).
"""

from __future__ import annotations

import glob as globmod
import os
from typing import Dict, List, Tuple

import numpy as np

from deepmod_tpu_torch.aggregate.summarize import CountsMap, PositionCounts, write_bed

PRE_BASE_STR = "rnn.pred.ind"


def apply_mod_cluster_rescue(m_pred: np.ndarray) -> np.ndarray:
    """In-place CpG-cluster rescue on one read's predetail array.

    ``m_pred`` needs fields refbase, mod_pred. Mirrors myDetect.py:1054-1087:
    original predictions are snapshotted (mod_pred2) so rescued positions
    don't cascade.
    """
    refbase = m_pred["refbase"]
    orig = m_pred["mod_pred"].copy()
    n = len(m_pred)
    candidates = np.flatnonzero((orig != 1) & (refbase == "C"))
    for mi in candidates:
        sides: List[List[Tuple[str, int]]] = []
        for step in (-1, 1):
            collected: List[Tuple[str, int]] = []
            mj = mi + step
            while 0 <= mj < n and len(collected) < 12:
                b = refbase[mj]
                if b in ("N", "n"):
                    break
                if b != "-":
                    collected.append((b, int(orig[mj])))
                mj += step
            if step == -1:
                collected = collected[::-1]
            sides.append(collected)
        cpgnum = 0
        meth_cpgnum = 0
        for side in sides:
            for mj in range(len(side) - 1):
                if side[mj][0] == "C" and side[mj + 1][0] == "G":
                    cpgnum += 1
                    if side[mj][1] == 1:
                        meth_cpgnum += 1
        if cpgnum > 0 and meth_cpgnum > 0 and meth_cpgnum / cpgnum > 0.5:
            m_pred["mod_pred"][mi] = 1
    return m_pred


def read_index_file(path: str) -> Tuple[Dict[str, str], List[List[str]]]:
    """Parse an index file into (headers, entries)
    (read_file_list, myDetect.py:992-1009)."""
    headers: Dict[str, str] = {}
    entries: List[List[str]] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0].startswith("#"):
                if len(parts) > 1:
                    headers[parts[0]] = parts[1]
            else:
                entries.append(parts)
    return headers, entries


def read_predetail(
    base_folder_output: str, entry: List[str]
) -> Tuple[np.ndarray, str, str]:
    """Load one read's predetail dataset (read_pred_detail,
    myDetect.py:1013-1023)."""
    import h5py

    pred_file = os.path.join(base_folder_output, entry[5])
    with h5py.File(pred_file, "r") as fh:
        group = fh[f"pred/{entry[3]}"]
        detail = group["predetail"][()]
        chrom = group.attrs["mapped_chr"]
        strand = group.attrs["mapped_strand"]
    out = np.empty(
        len(detail),
        dtype=[("refbase", "U1"), ("readbase", "U1"),
               ("refbasei", np.uint64), ("readbasei", np.uint64),
               ("mod_pred", np.int64)],
    )
    for field in out.dtype.names:
        out[field] = detail[field]
    if isinstance(chrom, bytes):
        chrom = chrom.decode()
    if isinstance(strand, bytes):
        strand = strand.decode()
    return out, chrom, strand


def _accumulate_detail(
    counts: CountsMap,
    m_pred: np.ndarray,
    chrom: str,
    strand: str,
    target_base: str,
) -> None:
    key = (chrom, strand)
    max_pos = int(m_pred["refbasei"].max()) + 1 if len(m_pred) else 1
    if key not in counts:
        counts[key] = PositionCounts.zeros(max_pos)
    elif counts[key].dense and counts[key].length < max_pos:
        counts[key]._grow(max_pos)
    counts[key].add_base_map(m_pred, target_base)


def summarize_run(
    pred_path: str,
    out_folder: str,
    target_base: str = "C",
    mod_cluster: bool = False,
) -> List[str]:
    """Rebuild BED summaries from a previous run's prediction files.

    Returns the list of BED files written. File naming follows
    myDetect.py:1043-1046 (cluster_mod_pos.* with mod_cluster).
    """
    index_files = sorted(
        globmod.glob(os.path.join(pred_path, PRE_BASE_STR + ".*"))
    )
    counts: CountsMap = {}
    for index_path in index_files:
        headers, entries = read_index_file(index_path)
        base_out = headers.get("#base_folder_output", pred_path)
        if not os.path.isdir(base_out):
            base_out = pred_path
        for entry in entries:
            m_pred, chrom, strand = read_predetail(base_out, entry)
            if mod_cluster:
                apply_mod_cluster_rescue(m_pred)
            _accumulate_detail(counts, m_pred, chrom, strand, target_base)

    prefix = "cluster_mod_pos" if mod_cluster else "mod_pos"
    os.makedirs(out_folder, exist_ok=True)
    bed_files: List[str] = []
    for (chrom, strand), pc in sorted(counts.items()):
        path = os.path.join(
            out_folder, f"{prefix}.{chrom}{strand}.{target_base}.bed"
        )
        if write_bed(path, chrom, strand, target_base, pc) > 0:
            bed_files.append(path)
    return bed_files
