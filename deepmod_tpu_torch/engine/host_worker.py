"""Host-side ingestion for detect: fast5/pod5 ingestion -> alignment ->
per-read feature blocks, ready for device classification.

A copy of ``deepmod_tpu/engine/host_worker.py`` for the PyTorch port; it
touches no device. ``init_worker`` builds the aligner index once
(mirroring the reference's one-time session build, myDetect.py:948-984).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

_STATE: Dict[str, object] = {}


@dataclasses.dataclass
class HostOptions:
    """Picklable subset of DetectConfig needed by the host stages."""

    ref: str
    align_str: str
    fnum: int
    window_size: int
    base: str
    con_unk: bool
    regions: Tuple
    basecall_1d: str
    basecall_2strand: str
    signal_group: str
    move: bool
    min_events: int = 50
    cpg_canonicalize: bool = True
    strict_ref_clips: bool = True
    # dorado-style basecall BAM/SAM for .pod5 inputs (mv/ts tags)
    basecalls: str = ""



@dataclasses.dataclass
class HostReadResult:
    """One read, fully prepared for device inference.

    Carries the compact (rows, fnum) feature block instead of
    materialized windows; detect's device stage
    (WindowPredictor.predict_from_blocks) gathers each chunk's rows from
    the batch's blocks as they are, without concatenating them, ships
    them, and the kernel reads each 21-row window in place.
    """

    read_id: str
    path: str
    rname: str
    strand: str
    pos0: int
    base_map: np.ndarray
    left_clip: int
    right_clip: int
    first_match_pos: int
    num_match: int
    num_mismatch: int
    num_insert: int
    num_del: int
    features: np.ndarray         # (n_aligned + 2*pad, fnum) float32
    n_aligned: int
    chrom_length: int


def init_worker(opts: HostOptions) -> None:
    from deepmod_tpu_torch.align.aligner import get_aligner
    from deepmod_tpu_torch.io.fasta import FastaReference

    _STATE["opts"] = opts
    _STATE["reference"] = FastaReference(opts.ref)
    _STATE["aligner"] = get_aligner(opts.ref, opts.align_str)


def _chrom_ok(rname: str, opts: HostOptions) -> bool:
    if not opts.con_unk and any(c in rname for c in "_-/:"):
        return False
    return any(r[0] in ("", None, rname) for r in opts.regions)


def _region_ok(rname: str, pos: int, n_events: int, opts: HostOptions) -> bool:
    for chrom, start, end in opts.regions:
        if (
            chrom in ("", None, rname)
            and (start in ("", None) or pos > start)
            and (end in ("", None) or pos + n_events < end)
        ):
            return True
    return False


def host_process_files(
    paths: List[str],
) -> Tuple[List[HostReadResult], Dict[str, List[str]]]:
    """Ingest+align+featurize one batch of fast5 paths (runs in worker)."""
    from deepmod_tpu_torch.align.cigar import AlignmentRejected, expand_alignment
    from deepmod_tpu_torch.align.sam import filter_best_alignments
    from deepmod_tpu_torch.features.builder import (
        FeatureBuildError,
        build_feature_matrix,
    )
    from deepmod_tpu_torch.io.fast5 import Fast5ReadOptions, read_fast5_batch
    from deepmod_tpu_torch.utils import ErrorCensus

    opts: HostOptions = _STATE["opts"]  # type: ignore[assignment]
    reference = _STATE["reference"]
    aligner = _STATE["aligner"]

    errors = ErrorCensus()
    read_opts = Fast5ReadOptions(
        basecall_1d=opts.basecall_1d,
        basecall_2strand=opts.basecall_2strand,
        signal_group=opts.signal_group,
        move=opts.move,
        basecalls=opts.basecalls or None,
    )
    f5data = read_fast5_batch(paths, read_opts, errors)
    if not f5data:
        return [], errors.errors
    records = aligner.align({rid: r.basecall for rid, r in f5data.items()})
    best = filter_best_alignments(records)
    for rid, read in f5data.items():
        if rid not in best:
            errors.add("Not in alignment sam", read.path)

    out: List[HostReadResult] = []
    for rid in sorted(best):
        rec = best[rid]
        read = f5data[rid]
        if not _chrom_ok(rec.rname, opts):
            continue
        pos0 = rec.pos - 1
        if not _region_ok(rec.rname, pos0, len(read.m_event), opts):
            continue
        if rec.rname not in reference:
            errors.add("Not in alignment sam", read.path)
            continue
        refseq = reference.fetch(rec.rname)
        try:
            bmr = expand_alignment(
                refseq, rec.seq, pos0, rec.cigar, rec.strand, rec.rname,
                len(read.m_event), min_events=opts.min_events,
                cpg_canonicalize=opts.cpg_canonicalize,
                cigar_arrays=rec.cigar_arrays,
                strict_ref_clips=opts.strict_ref_clips,
            )
            mfeat, start_clip, end_clip = build_feature_matrix(
                read.m_event, read.raw_signals, read.basecall, bmr,
                fnum=opts.fnum,
            )
        except (AlignmentRejected, FeatureBuildError) as exc:
            errors.add(str(exc), read.path)
            continue
        n_aligned = len(read.m_event) - start_clip - end_clip
        features = np.ascontiguousarray(mfeat[:, 3:], np.float32)
        out.append(
            HostReadResult(
                read_id=read.read_id,
                path=read.path,
                rname=bmr.rname,
                strand=bmr.strand,
                pos0=pos0,
                base_map=bmr.base_map,
                left_clip=bmr.left_clip,
                right_clip=bmr.right_clip,
                first_match_pos=bmr.first_match_pos,
                num_match=bmr.num_match,
                num_mismatch=bmr.num_mismatch,
                num_insert=bmr.num_insert,
                num_del=bmr.num_del,
                features=features,
                n_aligned=n_aligned,
                chrom_length=reference.length(bmr.rname),
            )
        )
    return out, errors.errors
