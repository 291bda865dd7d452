"""Cross-process merge of per-position counts and of index-file parts.

Counterpart of ``deepmod_tpu/parallel/cross_process.py``. The
reference's multi-node story is independent runs and a filesystem merge
tool (sum_chr_mod.py; docs/Usage.md:22-27). Under a ``torch.distributed``
group the detect engine instead merges its per-(chr, strand) counts
through collectives and writes ONE BED set from process 0, in place of
the filesystem barrier of myDetect.py:1196-1221.

Collectives must run in the same order with the same shapes on every
process, while each process holds counts for any subset of (chr, strand)
keys with ragged sizes. The order comes from walking the full sorted
(chromosome x strand) grid of the reference FASTA (the same on every
process); the ragged sizes are settled by ONE fixed-shape gather of every
key's local COO length (plus process 0's chunk size, so a per-host
environment cannot desynchronize the collective sequence), after which
every process pads its COO blocks to the gathered maxima. A process with
no counts runs every collective all the same.

int64 values (positions pass 2^31 on > 2.1 Gbp contigs) travel as int32
hi/lo halves: the gathers move int32 blocks only, as the JAX package's
do (there ``jax.device_put`` would truncate int64 silently).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepmod_tpu_torch.aggregate.summarize import CountsMap, PositionCounts

from .mesh import comm_device, default_group


def _split_i64(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nonnegative int64 -> (hi, lo) int32 halves."""
    a = np.asarray(a, np.int64)
    return (a >> 32).astype(np.int32), (a & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)


def _join_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.int64) << 32) | (
        lo.astype(np.int64) & 0xFFFFFFFF
    )


def _chunk_shape(rows: int, chunk_rows: int) -> int:
    """Pad a chunk's row count to a power-of-two bucket (capped at the
    chunk size): O(log chunk_rows) distinct gather shapes over a whole
    genome instead of one per contig."""
    bucket = 1
    while bucket < rows:
        bucket <<= 1
    return min(bucket, chunk_rows)


def _allgather(block: np.ndarray, group) -> np.ndarray:
    """(nproc,) + block.shape int32: every process's equal-shape block,
    in rank order."""
    where = comm_device(group)
    mine = torch.from_numpy(np.ascontiguousarray(block, np.int32)).to(where)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return torch.stack(parts).cpu().numpy()


def merge_counts_across_processes(
    counts: CountsMap,
    chrom_lengths: Dict[str, int],
    group=None,
) -> CountsMap:
    """All-reduce ``counts`` over every process of ``group`` (default: the
    default group; without one, ``counts`` comes back as it is).

    ``chrom_lengths`` (from the replicated reference FASTA) defines the
    deterministic key grid; it MUST be identical on all processes.
    Returns the merged map (identical on every process; the caller writes
    the BEDs on process 0 only)."""
    if group is None:
        group = default_group()
    if group is None or dist.get_world_size(group) <= 1:
        return counts

    keys = [
        (chrom, strand)
        for chrom in sorted(chrom_lengths)
        for strand in ("+", "-")
    ]
    coo: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    # one fixed-shape gather carries every key's local length AND this
    # process's chunk-size setting; (n, 2) int32 rows (hi, lo) keep >2^31
    # lengths exact. Process 0's chunk size governs all (a per-host env
    # difference must not desynchronize the collective chunk sequence;
    # the override exists for tests to force multi-chunk gathers).
    meta = np.zeros((len(keys) + 1, 2), np.int32)
    for i, key in enumerate(keys):
        pc = counts.get(key)
        if pc is not None:
            coo[key] = pc.to_coo()
            hi, lo = _split_i64(np.asarray([len(coo[key][0])], np.int64))
            meta[i, 0], meta[i, 1] = int(hi[0]), int(lo[0])
    # clamp: 0 would raise inside range(); a negative chunk would make the
    # per-key range() empty and silently drop every gathered count
    chunk_local = max(1, int(os.environ.get("DMT_MERGE_CHUNK_ROWS", 1 << 22)))
    hi, lo = _split_i64(np.asarray([chunk_local], np.int64))
    meta[-1, 0], meta[-1, 1] = int(hi[0]), int(lo[0])
    all_meta = _allgather(meta, group)
    all_n = _join_i64(all_meta[:, :-1, 0], all_meta[:, :-1, 1])  # (nproc, nkeys)
    chunk_rows = int(_join_i64(all_meta[0, -1, 0], all_meta[0, -1, 1]))

    merged: CountsMap = {}
    for i, key in enumerate(keys):
        n_max = int(all_n[:, i].max())
        if n_max == 0:
            continue
        if key in coo:
            pos, cov, mod = coo[key]
        else:
            pos = np.empty(0, np.int64)
            cov = np.empty(0, np.int32)
            mod = np.empty(0, np.int32)
        out = PositionCounts.zeros(int(chrom_lengths[key[0]]))
        # chunk the gather: human-scale chromosomes can carry tens of
        # millions of seen positions per process, and an unchunked
        # (nproc, n_max, 4) block would be GBs of host memory. The chunk
        # count derives from gathered values only, so every process
        # executes the same collective sequence.
        for lo_row in range(0, n_max, chunk_rows):
            hi_row = min(lo_row + chunk_rows, n_max)
            rows = _chunk_shape(hi_row - lo_row, chunk_rows)
            # columns: pos_hi, pos_lo, coverage, mod_count (all int32)
            block = np.zeros((rows, 4), np.int32)
            take = max(0, min(len(pos), hi_row) - lo_row)
            if take:
                p_hi, p_lo = _split_i64(pos[lo_row : lo_row + take])
                block[:take, 0] = p_hi
                block[:take, 1] = p_lo
                block[:take, 2] = cov[lo_row : lo_row + take]
                block[:take, 3] = mod[lo_row : lo_row + take]
            gathered = _allgather(block, group)
            for p in range(gathered.shape[0]):
                n_p = max(0, min(int(all_n[p, i]), hi_row) - lo_row)
                if n_p == 0:
                    continue
                out.add_coo(
                    _join_i64(gathered[p, :n_p, 0], gathered[p, :n_p, 1]),
                    gathered[p, :n_p, 2],
                    gathered[p, :n_p, 3],
                )
        merged[key] = out
    return merged


def merge_index_parts(
    out_base: str, pre_base_str: str, num_parts: int
) -> None:
    """Combine per-process ``p<pid>/rnn.pred.ind.<chr>`` parts into the
    reference-named merged per-chromosome index files in ``out_base``.

    Parts live INSIDE each process's private ``p<pid>/`` output tree (not
    as suffixed names in ``out_base``), so chromosome names containing
    ``.p`` cannot be mis-parsed and a merged output file can never match
    the part pattern on a later run. Only ``p0..p<num_parts-1>`` are
    read: stale trees from a previous larger run are ignored, never
    merged. Runs on process 0 AFTER the cross-process merge; a part
    directory on another host's private filesystem simply isn't there
    (per-read outputs then stay per-host, like the reference's per-shard
    runs)."""
    import glob
    from collections import defaultdict
    from typing import List

    by_chr: Dict[str, List[str]] = defaultdict(list)
    headers: Dict[str, List[str]] = {}
    part_files = []
    for pid in range(num_parts):
        part_files.extend(
            glob.glob(
                os.path.join(out_base, f"p{pid}", f"{pre_base_str}.*")
            )
        )
    for part in part_files:
        chrom = os.path.basename(part)[len(pre_base_str) + 1 :]
        with open(part) as fh:
            head = []
            for line in fh:
                if line.startswith("#"):
                    head.append(line)  # identical across parts (same
                    #                    wrk_base/out_base on every process)
                elif line.strip():
                    by_chr[chrom].append(line)
            headers.setdefault(chrom, head)

    def row_key(line: str):
        # the same ordering _write_index_files uses (numeric position)
        f = line.split()
        return (f[0], f[1], int(f[2]), f[3], f[4], f[5]) if len(f) >= 6 else (line,)

    for chrom, lines in by_chr.items():
        path = os.path.join(out_base, f"{pre_base_str}.{chrom}")
        with open(path, "w") as fh:
            fh.writelines(headers.get(chrom, []))
            fh.writelines(sorted(lines, key=row_key))
    for part in part_files:
        os.remove(part)
