"""Per-read output stage: prediction scatter, predetail HDF5, counts.

A copy of ``deepmod_tpu/engine/outputs.py`` for the PyTorch port. The
reference writes each batch's predetail HDF5 as one per-batch file
(myDetect.py:714-760, 968); this module holds that whole output stage as
device-free functions, the inline CpG-cluster rescue of ``--mod_cluster``
included (``engine.summarize.apply_mod_cluster_rescue``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepmod_tpu_torch.aggregate.summarize import CountsMap, PositionCounts
from deepmod_tpu_torch.features.builder import FeatureBuildError

# feature blocks carry +-100 context rows on each side (myDetect.py:794,
# 855): event i of a block is its row pad + i. A T-row window reads T//2 of
# them on each side at most, so ``batch_blocks`` hands each block on
# trimmed to the rows its windows read
FEATURE_PAD = 100


@dataclasses.dataclass
class OutputOptions:
    """Picklable subset of DetectConfig needed by the output stage."""

    wrk_base: str
    out_base: str                # <out_folder>/<file_id>
    base: str
    write_per_read: bool = True
    mod_cluster: bool = False
    # predetail dataset gzip level. The SCHEMA is pinned to the reference
    # (attrs + compound dtype, myDetect.py:716-760); the compression level
    # is not observable in any downstream read path (--predDet 0 rebuilds,
    # the reference's own sum_handler, tools). Level 1 writes ~20% faster
    # than h5py's default 4 for ~10% larger files — the right trade for
    # the measured-critical write stage.
    gzip_level: int = 1


def center_runs(centers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(firsts, counts)``: ``centers`` as runs of consecutive rows, run q
    the ``counts[q]`` rows from ``firsts[q]`` (``run_centers`` undoes it)."""
    centers = np.asarray(centers, np.int64)
    head = np.ones(len(centers), bool)
    head[1:] = np.diff(centers) != 1
    heads = np.flatnonzero(head)
    return centers[heads], np.diff(np.append(heads, len(centers)))


def run_centers(firsts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The centers of the runs ``(firsts, counts)``, one by one."""
    counts = np.asarray(counts, np.int64)
    shift = np.asarray(firsts, np.int64) - (np.cumsum(counts) - counts)
    return (np.repeat(shift, counts)
            + np.arange(int(counts.sum()), dtype=np.int64))


def batch_blocks(
    results,  # List[HostReadResult]
    target_base: Optional[str] = None,
    window: int = 21,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray,
           Optional[List[np.ndarray]], int]:
    """A batch's classification request, with no copy of its rows.

    Returns ``(blocks, firsts, counts, selections, n_total)``: the reads'
    compact (rows, F) feature blocks, to be read as laid end to end; the
    windows to classify as runs of consecutive center rows of that layout
    (``center_runs``: a read's aligned events are one run); the per-read
    selected event indices (None when every event is selected); and the
    total aligned-event count across the batch.

    Each block is a view of the read's features trimmed to the rows its
    ``window``-row windows read: a window centred on row c reads rows
    c - window//2 .. c - window//2 + window - 1 (odd and even windows
    alike), so of the +-``FEATURE_PAD`` pad only the window//2 rows before
    the first event and the window - 1 - window//2 after the last remain,
    and event i is row window//2 + i of the view.

    With ``target_base`` set (detect --targetOnly) only windows whose
    reference base IS the target are selected — the BED summaries count
    exclusively refbase==Base positions (sum_handler, myDetect.py:
    1095-1100), so this is BED-identical; non-target rows get mod_pred 0
    in the per-read files (where the reference stores model outputs).
    """
    half = window // 2
    lo = FEATURE_PAD - half
    n_aligned = np.array([r.n_aligned for r in results], np.int64)
    lengths = n_aligned + (window - 1)
    blocks = [r.features[lo : lo + n]
              for r, n in zip(results, lengths.tolist())]
    starts = np.cumsum(lengths) - lengths
    n_total = int(n_aligned.sum())
    if target_base is None:
        return blocks, starts + half, n_aligned, None, n_total
    selections = []
    for r in results:
        nongap = r.base_map["readbase"] != "-"
        selections.append(
            np.flatnonzero((r.base_map["refbase"] == target_base)[nongap]))
    centers = np.concatenate([s + half + idx
                              for s, idx in zip(starts, selections)])
    return (blocks, *center_runs(centers), selections, n_total)


def build_batch_request(
    results,  # List[HostReadResult]
    target_base: Optional[str] = None,
    window: int = 21,
) -> Tuple[np.ndarray, np.ndarray, Optional[List[np.ndarray]], int]:
    """``batch_blocks`` as one array, for callers that ship the batch
    whole (the HostPool worker, tools): ``(features, centers, selections,
    n_total)``, the trimmed blocks concatenated into a (rows, F) array and
    the absolute center row of every window to classify. Detect's device
    stage reads the blocks as they are (``predict_batch_windows``)."""
    blocks, firsts, counts, selections, n_total = batch_blocks(
        results, target_base, window)
    return (np.concatenate(blocks, axis=0), run_centers(firsts, counts),
            selections, n_total)


def scatter_selected_preds(
    results,
    selections: Optional[List[np.ndarray]],
    preds_sel: np.ndarray,
    n_total: int,
) -> np.ndarray:
    """Expand selected-window predictions to the all-events layout the
    output stage expects (zeros on unselected events)."""
    if selections is None:
        return preds_sel
    preds = np.zeros(n_total, np.int8)
    out_off = sel_off = 0
    for r, idx in zip(results, selections):
        preds[out_off + idx] = preds_sel[sel_off : sel_off + len(idx)]
        out_off += r.n_aligned
        sel_off += len(idx)
    return preds


def save_predetail(
    fh,  # open h5py.File (one per batch — opening per read costs ~1ms each)
    pred_key: str,
    item,  # HostReadResult
    pred_mod_num: int,
    gzip_level: int = 1,
) -> None:
    """Per-read prediction HDF5, format-identical to myDetect.py:716-760."""
    bm = item.base_map
    base_group = fh["pred"] if "pred" in fh else fh.create_group("pred")
    if pred_key in base_group:
        del base_group[pred_key]
    group = base_group.create_group(pred_key)
    group.attrs["mapped_chr"] = item.rname
    group.attrs["mapped_strand"] = item.strand
    group.attrs["mapped_start"] = (
        bm["refbasei"][0] if item.strand == "+" else bm["refbasei"][-1]
    )
    group.attrs["mapped_end"] = (
        bm["refbasei"][-1] if item.strand == "+" else bm["refbasei"][0]
    )
    group.attrs["clipped_bases_start"] = (
        item.left_clip if item.strand == "+" else item.right_clip
    )
    group.attrs["clipped_bases_end"] = (
        item.right_clip if item.strand == "+" else item.left_clip
    )
    group.attrs["num_insertions"] = item.num_insert
    group.attrs["num_deletions"] = item.num_del
    group.attrs["num_matches"] = item.num_match
    group.attrs["num_mismatches"] = item.num_mismatch
    group.attrs["pred_mod_num"] = pred_mod_num
    group.attrs["f5file"] = item.path
    group.attrs["readk"] = item.read_id
    as_s1 = np.empty(
        len(bm),
        dtype=[("refbase", "S1"), ("readbase", "S1"),
               ("refbasei", np.uint64), ("readbasei", np.uint64),
               ("mod_pred", np.int64)],
    )
    for field in ("refbase", "readbase"):
        col = bm[field]
        if col.dtype.kind == "U" and sys.byteorder == "little":
            # U1 is UCS4; for the ASCII alphabet these fields hold, byte 0
            # IS the char — numpy's elementwise U->S conversion is ~120x
            # slower and was the largest single cost of the output stage
            as_s1[field] = np.ascontiguousarray(col).view(
                np.uint32).astype(np.uint8).view("S1")
        else:
            as_s1[field] = col
    for field in ("refbasei", "readbasei", "mod_pred"):
        as_s1[field] = bm[field]
    group.create_dataset(
        "predetail", data=as_s1, compression="gzip",
        compression_opts=gzip_level,
    )


def write_batch_outputs(
    results,  # List[HostReadResult]
    preds: np.ndarray,
    opts: OutputOptions,
    counts: CountsMap,
    batch_id: int,
    ct_folder: str,
    collect=None,
) -> Tuple[int, int, List[List[str]]]:
    """Scatter predictions onto base maps, write the batch's predetail
    HDF5 + index entries, accumulate per-position counts into ``counts``.

    ``collect(key, item) -> bool`` optionally replaces the host count
    accumulation for a read (the engine's device-aggregation path);
    a False/None return falls back to ``add_base_map``.
    Returns ``(n_reads, n_windows, index_entries)``.
    """
    if not results:
        return 0, 0, []
    index_entries: List[List[str]] = []
    pred_file = os.path.join(ct_folder, f"rnn.pred.detail.fast5.{batch_id}")
    offset = 0
    # one HDF5 open per batch (a per-read open/close costs ~1 ms each)
    pred_fh = None
    if opts.write_per_read:
        import h5py

        try:
            pred_fh = h5py.File(pred_file, "a")
        except OSError:
            # a crashed previous run can leave a truncated predetail file
            # ("truncated file: eof = ..."); this run owns the batch-id
            # namespace, so recreate rather than fail the whole batch
            try:
                os.unlink(pred_file)
            except OSError:
                pass
            pred_fh = h5py.File(pred_file, "w")
    try:
        for readk_ind, item in enumerate(results):
            n_aligned = item.n_aligned
            p = preds[offset : offset + n_aligned]
            offset += n_aligned
            # scatter onto non-gap base-map rows (mPredict1,
            # myDetect.py:823-833)
            nongap = np.flatnonzero(item.base_map["readbase"] != "-")
            if len(nongap) != n_aligned:
                raise FeatureBuildError("Error Does not match")
            hits = nongap[p == 1]
            item.base_map["mod_pred"][hits] = 1
            pred_mod_num = int(len(hits))
            if opts.mod_cluster:
                from .summarize import apply_mod_cluster_rescue

                apply_mod_cluster_rescue(item.base_map)
            # accumulate counts (sum_handler rules)
            key = (item.rname, item.strand)
            if key not in counts:
                counts[key] = PositionCounts.zeros(item.chrom_length)
            if not (collect is not None and collect(key, item)):
                counts[key].add_base_map(item.base_map, opts.base)

            if opts.write_per_read:
                pred_key = f"pred_{readk_ind}"
                save_predetail(
                    pred_fh, pred_key, item, pred_mod_num, opts.gzip_level
                )
                rel_f5 = os.path.relpath(item.path, opts.wrk_base)
                rel_pred = os.path.relpath(pred_file, opts.out_base)
                index_entries.append(
                    [item.rname, item.strand, str(item.pos0), pred_key,
                     rel_f5, rel_pred]
                )
    finally:
        if pred_fh is not None:
            pred_fh.close()
    return len(results), int(offset), index_entries


def counts_to_coo(
    counts: CountsMap,
) -> List[Tuple[str, str, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Wire format for shipping a worker's per-batch counts to the engine:
    one (chrom, strand, length, pos, cov, mod) tuple per (chr, strand) —
    O(seen positions), tiny next to the feature blocks."""
    return [
        (chrom, strand, pc.length) + pc.to_coo()
        for (chrom, strand), pc in counts.items()
    ]
