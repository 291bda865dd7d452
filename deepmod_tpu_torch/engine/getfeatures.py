"""Training-feature extraction pipeline (the reference's `getfeatures`).

Mirrors getFeature_manager/getFeature_handler/mGetFeature1
(myGetFeatureBasedPos.py:653-757, 564-583, 28-103): fast5 batches are
ingested and aligned like detect, but reads are labeled against motif or
position files and flushed into feature files once the in-memory matrix
exceeds size_per_batch bytes (:120-131, 331-350).

Output formats:
- ``<n>.xy.gz``  text matrix, np.savetxt fmt='%.3f' (reference format);
- ``<n>.xy.ind`` sidecar mapping starting row -> fast5 path;
- optionally ``<n>.xy.npz`` (float32 binary, ~20x faster to load) when
  save_format includes 'npz'.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepmod_tpu_torch.align.aligner import get_aligner
from deepmod_tpu_torch.align.cigar import AlignmentRejected, expand_alignment
from deepmod_tpu_torch.align.sam import filter_best_alignments
from deepmod_tpu_torch.features.builder import FeatureBuildError
from deepmod_tpu_torch.features.labeled import LabelOptions, build_labeled_features
from deepmod_tpu_torch.features.labels import read_position_files, scan_motif
from deepmod_tpu_torch.io.fast5 import Fast5ReadOptions, read_fast5_batch
from deepmod_tpu_torch.io.fasta import read_fasta
from deepmod_tpu_torch.utils import ErrorCensus

from .detect import discover_fast5


@dataclasses.dataclass
class GetFeaturesConfig:
    wrk_base: str
    ref: str
    out_folder: str
    posneg: int = 0
    fnum: int = 7
    size_per_batch: float = 1.0        # x 1e7 bytes (DeepMod.py:359, :664)
    motif_or_pos: int = 1
    motif: str = "CG"
    mod_offset: int = 0
    fulmod_pattern: Optional[str] = None
    anymod_pattern: Optional[str] = None
    nomod_pattern: Optional[str] = None
    region: Tuple[Optional[str], Optional[int], Optional[int]] = (None, None, None)
    basecall_1d: str = "Basecall_1D_000"
    basecall_2strand: str = "BaseCalled_template"
    signal_group: str = "simple"
    move: bool = False
    align_str: str = "auto"
    # dorado-style basecall BAM/SAM (mv/ts tags) enabling .pod5 inputs
    # under wrk_base (beyond the reference; same path as detect)
    basecalls: str = ""
    recursive: bool = True
    files_per_batch: int = 1000
    save_format: str = "xy.gz"         # 'xy.gz' | 'npz' | 'both'
    wipe_out_folder: bool = True       # reference wipes it (:659-662)
    threads: int = 1                   # worker processes over batches


@dataclasses.dataclass
class GetFeaturesResult:
    out_folder: str
    feature_files: List[str]
    num_reads: int
    num_rows: int
    errors: Dict[str, List[str]]
    elapsed_s: float


class _FeatureFlusher:
    """Accumulate per-read matrices; flush at the size threshold
    (myGetFeatureBasedPos.py:120-131)."""

    def __init__(self, folder: str, size_per_batch_bytes: float, save_format: str):
        self.folder = folder
        self.limit = size_per_batch_bytes
        self.save_format = save_format
        self.buffers: List[np.ndarray] = []
        self.index: List[Tuple[str, int]] = []
        self.rows = 0
        self.nbytes = 0
        self.file_ind = 0
        self.written: List[str] = []

    @staticmethod
    def _write_xy_gz(path: str, feat: np.ndarray) -> None:
        """np.savetxt(fmt='%.3f') equivalent: native formatter + one gzip
        write. savetxt formats row-by-row through a level-9 gzip stream —
        ~80% of getfeatures wall time; the text content here is byte-
        identical (pinned by test) and gzip level only changes the
        intermediate file's size, not what any reader decodes."""
        from deepmod_tpu_torch.native.lib import format_matrix_f3_native

        buf = format_matrix_f3_native(feat) if len(feat) else None
        if buf is None:
            np.savetxt(path, feat, fmt="%.3f")
            return
        import gzip

        with gzip.open(path, "wb", compresslevel=4) as fh:
            fh.write(buf)

    def add(self, mfeat: np.ndarray, f5path: str) -> None:
        if self.nbytes > self.limit:
            self.flush()
        self.index.append((f5path, self.rows))
        self.buffers.append(mfeat)
        self.rows += len(mfeat)
        self.nbytes += mfeat.nbytes

    def flush(self) -> None:
        if not self.buffers:
            return
        feat = np.concatenate(self.buffers, axis=0)
        base = os.path.join(self.folder, str(self.file_ind))
        if self.save_format in ("xy.gz", "both"):
            self._write_xy_gz(base + ".xy.gz", feat)
            self.written.append(base + ".xy.gz")
        if self.save_format in ("npz", "both"):
            # `pos` carries column 0 exactly: float32 cannot represent
            # genomic positions past 2^24 (~16.7 Mb) and the E-mode
            # train/test split filters on it
            np.savez_compressed(
                base + ".xy.npz",
                xy=feat.astype(np.float32),
                pos=feat[:, 0].astype(np.int64),
            )
            if self.save_format == "npz":
                self.written.append(base + ".xy.npz")
        with open(base + ".xy.ind", "w") as fh:
            for path, row in self.index:
                fh.write(f"{row} {path}\n")
        self.buffers = []
        self.index = []
        self.rows = 0
        self.nbytes = 0
        self.file_ind += 1


def build_label_options(config: GetFeaturesConfig, fadict: Dict[str, str]) -> LabelOptions:
    """Resolve label sources (getFeature_manager, :666-698)."""
    if config.motif_or_pos == 1:
        fulmod, _candidates = scan_motif(
            fadict, config.motif, config.mod_offset,
            config.region[0], config.region[1], config.region[2],
        )
        return LabelOptions(
            posneg=config.posneg, fulmod=fulmod, anymod=None, nomod=None,
            motif=config.motif, mod_offset=config.mod_offset,
        )
    fulmod = read_position_files(config.fulmod_pattern or "")
    anymod = (
        read_position_files(config.anymod_pattern)
        if config.anymod_pattern else None
    )
    nomod = (
        read_position_files(config.nomod_pattern)
        if config.nomod_pattern else None
    )
    return LabelOptions(
        posneg=config.posneg, fulmod=fulmod, anymod=anymod, nomod=nomod,
        motif=config.motif if config.motif else None,
        mod_offset=config.mod_offset,
    )



_GF_STATE: Dict[str, object] = {}


def _init_gf_worker(config: GetFeaturesConfig, fadict=None, label_opts=None,
                    aligner=None) -> None:
    """Per-worker one-time setup: reference + labels + aligner index."""
    if fadict is None:
        fadict = read_fasta(config.ref, config.region[0])
    if label_opts is None:
        label_opts = build_label_options(config, fadict)
    if aligner is None:
        aligner = get_aligner(config.ref, config.align_str, ref_seqs=fadict)
    _GF_STATE["config"] = config
    _GF_STATE["fadict"] = fadict
    _GF_STATE["label_opts"] = label_opts
    _GF_STATE["aligner"] = aligner


def _gf_process_batch(batch_id: int, batch: List[str]):
    """One fast5 batch -> flushed feature files (runs in worker or inline)."""
    config: GetFeaturesConfig = _GF_STATE["config"]  # type: ignore[assignment]
    fadict = _GF_STATE["fadict"]
    label_opts = _GF_STATE["label_opts"]
    aligner = _GF_STATE["aligner"]

    errors = ErrorCensus()
    read_opts = Fast5ReadOptions(
        basecall_1d=config.basecall_1d,
        basecall_2strand=config.basecall_2strand,
        signal_group=config.signal_group,
        move=config.move,
        basecalls=config.basecalls or None,
    )
    folder = os.path.join(config.out_folder, str(batch_id))
    os.makedirs(folder, exist_ok=True)
    flusher = _FeatureFlusher(
        folder, config.size_per_batch * 1e7, config.save_format
    )
    num_reads = 0
    num_rows = 0

    f5data = read_fast5_batch(batch, read_opts, errors)
    records = aligner.align({rid: r.basecall for rid, r in f5data.items()})
    best = filter_best_alignments(records)
    for rid, read in f5data.items():
        if rid not in best:
            errors.add("Not in alignment sam", read.path)
    for rid in sorted(best):
        rec = best[rid]
        read = f5data[rid]
        # skip chromosomes without any labels (:135-138)
        has_labels = (
            (label_opts.fulmod and label_opts.fulmod.get(rec.rname))
            or (label_opts.anymod and label_opts.anymod.get(rec.rname))
            or (label_opts.nomod and label_opts.nomod.get(rec.rname))
        )
        if not has_labels:
            continue
        pos0 = rec.pos - 1
        chrom, rstart, rend = config.region
        if not (
            chrom in ("", None, rec.rname)
            and (rstart in ("", None) or pos0 > rstart)
            and (rend in ("", None) or pos0 + len(read.m_event) < rend)
        ):
            continue
        refseq = fadict.get(rec.rname)
        if refseq is None:
            continue
        try:
            bmr = expand_alignment(
                refseq, rec.seq, pos0, rec.cigar, rec.strand, rec.rname,
                len(read.m_event), min_events=500,
                cpg_canonicalize=(label_opts.motif == "CG"),
                cigar_arrays=rec.cigar_arrays,
                # the getfeatures reference variant attributes unmatched
                # trims CONSISTENTLY (myGetFeatureBasedPos.py:253-254 —
                # no strand branch), unlike detect's swapped accounting,
                # so minus-strand firstmatch!=tail reads are kept here
                strict_ref_clips=False,
            )
            mfeat = build_labeled_features(
                read.m_event, read.raw_signals, read.basecall, bmr,
                label_opts, fnum=config.fnum,
            )
        except (AlignmentRejected, FeatureBuildError) as exc:
            errors.add(str(exc), read.path)
            continue
        if mfeat is None or len(mfeat) == 0:
            continue
        flusher.add(mfeat, read.path)
        num_reads += 1
        num_rows += len(mfeat)
    flusher.flush()
    return flusher.written, num_reads, num_rows, errors.errors


def getfeatures_run(config: GetFeaturesConfig) -> GetFeaturesResult:
    start_time = time.time()
    if config.wipe_out_folder and os.path.isdir(config.out_folder):
        # the reference recreates the folder from scratch (:659-662)
        shutil.rmtree(config.out_folder)
    os.makedirs(config.out_folder, exist_ok=True)

    fadict = read_fasta(config.ref, config.region[0])
    label_opts = build_label_options(config, fadict)

    errors = ErrorCensus()
    read_opts = Fast5ReadOptions(
        basecall_1d=config.basecall_1d,
        basecall_2strand=config.basecall_2strand,
        signal_group=config.signal_group,
        move=config.move,
        basecalls=config.basecalls or None,
    )
    files = sorted(discover_fast5(config.wrk_base, config.recursive))
    aligner = get_aligner(config.ref, config.align_str, ref_seqs=fadict)

    num_reads = 0
    num_rows = 0
    all_written: List[str] = []
    n_batches = max(
        1, (len(files) + config.files_per_batch - 1) // config.files_per_batch
    )
    batches = [
        (
            batch_id,
            files[
                batch_id * config.files_per_batch : (batch_id + 1)
                * config.files_per_batch
            ],
        )
        for batch_id in range(n_batches)
    ]
    batches = [(bid, b) for bid, b in batches if b]

    if config.threads > 1 and len(batches) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        existing = os.environ.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            os.environ["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(
            max_workers=config.threads,
            mp_context=ctx,
            initializer=_init_gf_worker,
            initargs=(config,),
        ) as pool:
            futures = {
                pool.submit(_gf_process_batch, batch_id, batch): batch_id
                for batch_id, batch in batches
            }
            for fut in cf.as_completed(futures):
                written, reads, rows, batch_errors = fut.result()
                all_written.extend(written)
                num_reads += reads
                num_rows += rows
                for kind, paths in batch_errors.items():
                    errors.extend(kind, paths)
    else:
        _init_gf_worker(config, fadict=fadict, label_opts=label_opts,
                        aligner=aligner)
        for batch_id, batch in batches:
            written, reads, rows, batch_errors = _gf_process_batch(
                batch_id, batch
            )
            all_written.extend(written)
            num_reads += reads
            num_rows += rows
            for kind, paths in batch_errors.items():
                errors.extend(kind, paths)

    return GetFeaturesResult(
        out_folder=config.out_folder,
        feature_files=all_written,
        num_reads=num_reads,
        num_rows=num_rows,
        errors=errors.errors,
        elapsed_s=time.time() - start_time,
    )
