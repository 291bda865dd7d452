"""Synthetic nanopore dataset generation for tests and verification.

The reference ships no test fixtures at all (SURVEY.md section 4); this
module builds everything its pipeline consumes from scratch:

- a random reference genome (FASTA);
- simulated reads: subsequences with substitutions/indels, optional
  reverse-complement, and a per-base signal model (k-mer dependent level +
  gaussian noise, 4-12 samples per base, occasional stay events);
- Albacore-v2-style fast5 files (channel attrs, Fastq, Raw/Signal, Events
  with move column) laid out exactly where the reader expects them
  (myCom.py:51-56 path fragments);
- optional "modification" effect: bases matching a motif get a shifted
  signal level, giving supervised structure a model can actually learn —
  used by the training e2e test.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepmod_tpu_torch.utils.common import reverse_complement

BASES = np.array(list("ACGT"))


@dataclasses.dataclass
class SynthConfig:
    genome_sizes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"chrS": 50000}
    )
    num_reads: int = 20
    read_length: Tuple[int, int] = (1500, 3000)
    sub_rate: float = 0.01
    ins_rate: float = 0.005
    del_rate: float = 0.005
    samples_per_base: Tuple[int, int] = (4, 12)
    stay_rate: float = 0.05
    sampling_rate: float = 4000.0
    # motif modification effect (None disables)
    mod_motif: Optional[str] = None     # e.g. "CG"
    mod_offset: int = 0
    mod_level_shift: float = 0.0        # added to signal level at mod bases
    # per-site methylation probabilities keyed by the + strand C position
    # of each CpG dyad (chrom -> float array over genome positions):
    # every read draws an independent Bernoulli per covered dyad, on
    # either strand — the partial, spatially-correlated methylation
    # landscape the cluster-effect second stage exploits
    # (hm_cluster_predict.py:130-154 reads ±25 bp neighbor fractions).
    # Overrides mod_motif-based masking; still uses mod_level_shift.
    mod_site_prob: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    # fast5 flavor: 'v2' (albacore 2.x events), 'v1' (albacore 1.x,
    # second-based starts), 'move' (guppy move table)
    fast5_style: str = "v2"
    # dtype of the v2 Events start/length columns. '<u8' is the common
    # layout; '<u4' matches basecallers whose rundif resegmentation the
    # reference supports (EventTable.py mixes 'start' into argsort output
    # and slice bounds — under modern numpy uint64+int promotes to
    # float64 and breaks slicing, so rundif fixtures use '<u4')
    v2_index_dtype: str = "<u8"
    # force the last N event rows to move=0 (stays). The reference's
    # rundif resegmenter allocates one 5-mer per produced event starting
    # at fq offset 2 and crashes when sum(moves) > len(fq)-3
    # (EventTable.py:75, model_state[2] on a short tail slice) — its real
    # inputs end in stay events, so rundif fixtures must too
    tail_stays: int = 0
    # probability of un-evented gap samples before an event (v1 readers
    # must patch these, myDetect.py:204-231) and the gap length range
    gap_rate: float = 0.0
    gap_len: Tuple[int, int] = (1, 6)
    # raw_attributes['start_time'] for v1 files: event start SECONDS are
    # absolute (start_time + sample_index) / rate in real albacore data
    v1_start_time: int = 0
    reads_per_file: int = 1   # >1 writes multi-read fast5 containers


def make_genome(rng: np.random.RandomState, sizes: Dict[str, int]) -> Dict[str, str]:
    return {name: "".join(rng.choice(BASES, n)) for name, n in sizes.items()}


def simulate_read(
    rng: np.random.RandomState,
    genome: Dict[str, str],
    config: SynthConfig,
    return_ref_pos: bool = False,
):
    """Returns (chrom, strand, start, ref_segment, read_seq); with
    ``return_ref_pos`` also the genome position of each read base
    (-1 for inserted bases) — needed to apply per-REFERENCE-site
    modification probabilities through the read's errors."""
    chrom = list(genome)[rng.randint(len(genome))]
    ref = genome[chrom]
    length = rng.randint(*config.read_length)
    start = rng.randint(0, max(1, len(ref) - length))
    segment = ref[start : start + length]
    strand = "+" if rng.rand() < 0.5 else "-"
    template = segment if strand == "+" else reverse_complement(segment)
    n_tpl = len(template)
    out: List[str] = []
    ref_pos: List[int] = []

    def gpos(ti: int) -> int:
        return start + (ti if strand == "+" else n_tpl - 1 - ti)

    for ti, ch in enumerate(template):
        r = rng.rand()
        if r < config.del_rate:
            continue
        if r < config.del_rate + config.ins_rate:
            out.append(ch)
            ref_pos.append(gpos(ti))
            out.append(str(rng.choice(BASES)))
            ref_pos.append(-1)
            continue
        if r < config.del_rate + config.ins_rate + config.sub_rate:
            out.append(str(rng.choice([b for b in "ACGT" if b != ch])))
        else:
            out.append(ch)
        ref_pos.append(gpos(ti))
    seq = "".join(out)
    if return_ref_pos:
        return chrom, strand, start, segment, seq, np.asarray(ref_pos)
    return chrom, strand, start, segment, seq


def _kmer_level(kmer: str) -> float:
    """Deterministic per-kmer signal level in roughly [-2, 2]."""
    h = 2166136261
    for ch in kmer:
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF
    return ((h % 4001) / 1000.0) - 2.0


def _mod_positions(seq: str, motif: str, offset: int) -> np.ndarray:
    """Read positions whose base is the modified base of a motif hit."""
    hits = []
    start = seq.find(motif)
    while start != -1:
        hits.append(start + offset)
        start = seq.find(motif, start + 1)
    return np.asarray(hits, np.int64)


def make_clustered_site_prob(
    rng: np.random.RandomState,
    genome: Dict[str, str],
    tile: int = 250,
    p_meth_tile: float = 0.5,
    meth_range: Tuple[float, float] = (0.7, 0.95),
    unmeth_range: Tuple[float, float] = (0.02, 0.15),
) -> Dict[str, np.ndarray]:
    """Spatially-correlated CpG methylation landscape.

    The genome is tiled; each tile is methylated with ``p_meth_tile``,
    and every CpG dyad (keyed by its + strand C position) draws its
    per-read methylation probability from the tile's range. Nearby CpGs
    therefore share methylation state — exactly the neighborhood signal
    the cluster-effect second stage conditions on
    (hm_cluster_predict.py:130-154: ±25 bp neighbor fraction histogram).
    Use with SynthConfig.mod_site_prob + mod_level_shift.
    """
    out: Dict[str, np.ndarray] = {}
    for chrom, seq in genome.items():
        arr = np.frombuffer(seq.encode(), np.uint8)
        dyads = np.flatnonzero((arr[:-1] == ord("C")) & (arr[1:] == ord("G")))
        probs = np.zeros(len(seq))
        tile_meth = rng.rand((len(seq) // tile) + 1) < p_meth_tile
        site_tile = dyads // tile
        lo = np.where(tile_meth[site_tile], meth_range[0], unmeth_range[0])
        hi = np.where(tile_meth[site_tile], meth_range[1], unmeth_range[1])
        probs[dyads] = lo + rng.rand(len(dyads)) * (hi - lo)
        out[chrom] = probs
    return out


def _site_prob_mask(
    rng: np.random.RandomState,
    genome_seq: str,
    probs: np.ndarray,
    strand: str,
    ref_pos: np.ndarray,
) -> np.ndarray:
    """Per-read Bernoulli modification mask over read bases whose
    reference position is a CpG-dyad C on the read's strand."""
    n = len(ref_pos)
    mask = np.zeros(n, bool)
    if n == 0 or len(probs) < len(genome_seq):
        return mask
    arr = np.frombuffer(genome_seq.encode(), np.uint8)
    L = len(arr)
    gp = ref_pos
    valid = gp >= 0
    gpc = np.clip(gp, 0, L - 1)
    if strand == "+":
        is_site = (
            valid & (gp + 1 < L)
            & (arr[gpc] == ord("C"))
            & (arr[np.clip(gp + 1, 0, L - 1)] == ord("G"))
        )
        p = probs[gpc]
    else:
        is_site = (
            valid & (gp > 0)
            & (arr[gpc] == ord("G"))
            & (arr[np.clip(gp - 1, 0, L - 1)] == ord("C"))
        )
        p = probs[np.clip(gp - 1, 0, L - 1)]
    mask[is_site] = rng.rand(int(is_site.sum())) < p[is_site]
    return mask


def synth_signal(
    rng: np.random.RandomState, seq: str, config: SynthConfig,
    mod_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str], np.ndarray]:
    """Per-base signal; returns (signal, starts, lengths, kmers, move).

    ``mod_mask`` (bool per read base) overrides the motif scan — used by
    the per-site-probability landscape, where modification depends on
    REFERENCE position, not read sequence."""
    padded = "NN" + seq + "NN"
    n = len(seq)
    if mod_mask is None:
        mod_mask = np.zeros(n, bool)
        if config.mod_motif and config.mod_level_shift:
            pos = _mod_positions(seq, config.mod_motif, config.mod_offset)
            mod_mask[pos] = True

    lengths = rng.randint(
        config.samples_per_base[0], config.samples_per_base[1] + 1, n
    )
    kmers = [padded[i : i + 5] for i in range(n)]
    levels = np.array([_kmer_level(k) for k in kmers])
    levels = levels + np.where(mod_mask, config.mod_level_shift, 0.0)
    # raw DAC-like values around 500 with per-base level steps
    signal_chunks = [
        rng.normal(500 + 40 * levels[i], 6.0, lengths[i]) for i in range(n)
    ]
    lead = rng.normal(480, 10.0, 10)  # un-evented lead-in samples
    pieces = [lead]
    starts = np.empty(n, np.int64)
    cursor = 10
    for i in range(n):
        if config.gap_rate and i > 0 and rng.rand() < config.gap_rate:
            # un-evented samples BETWEEN events: exercises the v1
            # reader's gap-patching (myDetect.py:204-231 inserts filler
            # events / extends lengths when the time-derived start jumps
            # past the previous event's end)
            g = rng.randint(*config.gap_len)
            pieces.append(rng.normal(495, 8.0, g))
            cursor += g
        starts[i] = cursor
        pieces.append(signal_chunks[i])
        cursor += lengths[i]
    signal = np.concatenate(pieces)
    move = np.ones(n, np.int64)
    # real fast5 Raw/Signal datasets hold int16 DAC counts (the reference
    # normalizes those integers directly, myDetect.py:294/266-282);
    # quantizing keeps the fixture faithful and exercises the native
    # histogram-median fast path production data takes
    return np.round(signal).astype(np.int16), starts.astype(np.int64), lengths, kmers, move


def write_read_fast5(
    path: str,
    read_id: str,
    seq: str,
    rng: np.random.RandomState,
    config: SynthConfig,
    mod_mask: Optional[np.ndarray] = None,
) -> None:
    """Write one single-read fast5 in the configured flavor."""
    import h5py

    signal, starts, lengths, kmers, move = synth_signal(
        rng, seq, config, mod_mask
    )
    n = len(seq)

    if config.fast5_style == "move":
        _write_move_fast5(path, read_id, seq, signal, config)
        return

    # insert stay events: duplicate random rows with move=0 by splitting
    # their samples (keeps starts/lengths consistent)
    events = []
    for i in range(n):
        if lengths[i] >= 8 and rng.rand() < config.stay_rate:
            half = int(lengths[i] // 2)
            events.append((0.0, 0.0, starts[i], half, kmers[i], 1 if i > 0 else 1))
            events.append((0.0, 0.0, starts[i] + half, lengths[i] - half, kmers[i], 0))
        else:
            events.append((0.0, 0.0, starts[i], lengths[i], kmers[i], 1))
    idt = config.v2_index_dtype
    ev = np.array(
        events,
        dtype=[("mean", "<f8"), ("stdv", "<f8"), ("start", idt),
               ("length", idt), ("model_state", "S5"), ("move", "<i8")],
    )
    if config.tail_stays > 0:
        ev["move"][-config.tail_stays:] = 0
        ev["move"][0] = 1
    # fill event means from the signal (basecaller-ish)
    for row in ev:
        seg = signal[row["start"] : row["start"] + row["length"]]
        row["mean"] = seg.mean() if len(seg) else 0.0
        row["stdv"] = seg.std() if len(seg) else 0.0

    if config.fast5_style == "v1":
        # albacore 1.x: starts/lengths in SECONDS relative to raw start
        rate = config.sampling_rate
        ev_v1 = np.zeros(
            len(ev),
            dtype=[("mean", "<f8"), ("stdv", "<f8"), ("start", "<f8"),
                   ("length", "<f8"), ("model_state", "S5"), ("move", "<i8")],
        )
        for field in ("mean", "stdv", "model_state", "move"):
            ev_v1[field] = ev[field]
        ev_v1["start"] = (
            ev["start"].astype(np.float64) + config.v1_start_time
        ) / rate
        ev_v1["length"] = ev["length"].astype(np.float64) / rate
        ev = ev_v1
        version = b"1.2.6"
    else:
        version = b"2.3.4"

    with h5py.File(path, "w") as fh:
        ch = fh.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 0.0
        ch.attrs["range"] = 1400.0
        ch.attrs["sampling_rate"] = config.sampling_rate
        ch.attrs["channel_number"] = b"101"
        base = fh.create_group("Analyses/Basecall_1D_000")
        base.attrs["version"] = version
        tmpl = base.create_group("BaseCalled_template")
        fastq = f"@{read_id}\n{seq}\n+\n{'#' * len(seq)}\n"
        tmpl.create_dataset("Fastq", data=np.bytes_(fastq))
        tmpl.create_dataset("Events", data=ev)
        raw = fh.create_group("Raw/Reads/Read_77")
        raw.attrs["start_time"] = (
            config.v1_start_time if config.fast5_style == "v1" else 0
        )
        raw.attrs["read_id"] = read_id.encode()
        raw.create_dataset("Signal", data=signal)


def _move_layout(seq, signal):
    """Guppy-style move table at stride 2 for ``seq`` over ``signal``:
    returns (move uint8, signal padded to cover it, first sample).

    The reader reconstructs base boundaries at 2*i + first for move==1
    (MoveTable.py:31-43), so the move array is built from per-base sample
    budgets rounded to the stride.
    """
    n = len(seq)
    first = 10
    # give each base an even number of samples >= 4 within the signal
    budget = (len(signal) - first) // n
    budget = max(budget - (budget % 2), 4)
    move_len = (n * budget) // 2 + 2
    move = np.zeros(move_len, np.uint8)
    # n-1 boundaries: the reader's final base takes the trailing samples
    # (MoveTable.py:44-49 allocates one row per fastq base)
    for i in range(1, n):
        idx = (i * budget) // 2
        if idx < move_len:
            move[idx] = 1
    needed = first + (move_len - 1) * 2 + 4
    if needed > len(signal):
        signal = np.concatenate(
            [signal, np.zeros(needed - len(signal), signal.dtype)]
        )
    return move, signal, first


def _write_move_fast5(path, read_id, seq, signal, config):
    """Guppy-style fast5: Move table at stride 2 + Segmentation attrs."""
    import h5py

    move, signal, first = _move_layout(seq, signal)
    with h5py.File(path, "w") as fh:
        ch = fh.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 0.0
        ch.attrs["range"] = 1400.0
        ch.attrs["sampling_rate"] = config.sampling_rate
        ch.attrs["channel_number"] = b"101"
        base = fh.create_group("Analyses/Basecall_1D_000")
        base.attrs["version"] = b"6.0.1"
        tmpl = base.create_group("BaseCalled_template")
        fastq = f"@{read_id}\n{seq}\n+\n{'#' * len(seq)}\n"
        tmpl.create_dataset("Fastq", data=np.bytes_(fastq))
        tmpl.create_dataset("Move", data=move)
        seg = fh.create_group("Analyses/Segmentation_000/Summary/segmentation")
        seg.attrs["first_sample_template"] = first
        seg.attrs["duration_template"] = len(signal) - first
        raw = fh.create_group("Raw/Reads/Read_77")
        raw.attrs["start_time"] = 0
        raw.attrs["read_id"] = read_id.encode()
        raw.create_dataset("Signal", data=signal)


def repack_to_multi(single_paths: List[Tuple[str, str]], out_path: str) -> None:
    """Repack existing single-read fast5 files into one multi-read
    container (modern ONT layout: per-read read_<id> groups each holding
    channel_id / Raw / Analyses). ``single_paths`` is (read_id, path)."""
    import h5py

    with h5py.File(out_path, "w") as out:
        out.attrs["file_type"] = b"multi-read"
        for read_id, path in single_paths:
            with h5py.File(path, "r") as single:
                grp = out.create_group(f"read_{read_id}")
                ch = grp.create_group("channel_id")
                for k, v in single["UniqueGlobalKey/channel_id"].attrs.items():
                    ch.attrs[k] = v
                raw_src = single["Raw/Reads/Read_77"]
                raw = grp.create_group("Raw")
                for k, v in raw_src.attrs.items():
                    raw.attrs[k] = v
                raw.create_dataset("Signal", data=raw_src["Signal"][()])
                single.copy("Analyses", grp)


def write_multi_fast5(
    path: str,
    reads: List[Tuple[str, str]],
    rng: np.random.RandomState,
    config: SynthConfig,
) -> None:
    """Write a multi-read fast5 from (read_id, seq) pairs. The reference
    does not support this format; see io.fast5.read_multi_fast5_file."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmpdir:
        pairs = []
        for i, (read_id, seq) in enumerate(reads):
            p = os.path.join(tmpdir, f"{i}.fast5")
            write_read_fast5(p, read_id, seq, rng, config)
            pairs.append((read_id, p))
        repack_to_multi(pairs, path)


@dataclasses.dataclass
class SimulatedRead:
    read_id: str
    chrom: str
    strand: str
    start: int
    ref_segment: str
    seq: str
    path: str


def generate_dataset(
    out_dir: str, config: SynthConfig,
    genome: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, str], List[SimulatedRead]]:
    """Genome FASTA + fast5 directory; returns (genome, reads).

    Pass ``genome`` to reuse one genome across datasets (e.g. a
    methylated sample, a control sample, and held-out test sets that
    must share the reference)."""
    from deepmod_tpu_torch.io.fasta import write_fasta

    rng = np.random.RandomState(config.seed)
    if genome is None:
        genome = make_genome(rng, config.genome_sizes)
    os.makedirs(os.path.join(out_dir, "fast5"), exist_ok=True)
    write_fasta(os.path.join(out_dir, "ref.fa"), genome)
    reads: List[SimulatedRead] = []
    if config.reads_per_file > 1:
        pending: List[Tuple[SimulatedRead, str]] = []
        batch_no = 0
        for i in range(config.num_reads):
            chrom, strand, start, segment, seq = simulate_read(
                rng, genome, config
            )
            read_id = f"synthread_{i:04d}"
            pending.append(
                (SimulatedRead(read_id, chrom, strand, start, segment, seq, ""),
                 seq)
            )
            if (len(pending) == config.reads_per_file
                    or i == config.num_reads - 1):
                path = os.path.join(
                    out_dir, "fast5", f"batch_{batch_no:03d}.fast5"
                )
                write_multi_fast5(
                    path, [(r.read_id, s_) for r, s_ in pending], rng, config
                )
                for r, _ in pending:
                    r.path = path
                    reads.append(r)
                pending = []
                batch_no += 1
        return genome, reads
    for i in range(config.num_reads):
        chrom, strand, start, segment, seq, ref_pos = simulate_read(
            rng, genome, config, return_ref_pos=True
        )
        mod_mask = None
        if config.mod_site_prob is not None and config.mod_level_shift:
            mod_mask = _site_prob_mask(
                rng, genome[chrom],
                config.mod_site_prob.get(chrom, np.zeros(0)),
                strand, ref_pos,
            )
        read_id = f"synthread_{i:04d}"
        path = os.path.join(out_dir, "fast5", f"{read_id}.fast5")
        write_read_fast5(path, read_id, seq, rng, config, mod_mask)
        reads.append(
            SimulatedRead(read_id, chrom, strand, start, segment, seq, path)
        )
    return genome, reads


def convert_move_dataset_to_pod5(
    fast5_dir: str, out_pod5: str, out_bam: str
) -> Dict[str, str]:
    """Repackage a move-style fast5 dataset as the modern ONT stack:
    one .pod5 (raw signal, io.pod5) + a dorado-style basecall BAM
    (seq + mv:B:c stride/moves + ts:i trim, align.alignfile).

    The signal/move/trim/sequence are copied bit-for-bit, so a detect
    run over the pod5+BAM pair must produce BEDs identical to the
    fast5 run (pinned by tests/test_pod5.py). Returns
    {original_read_id: pod5_uuid} (pod5 read ids are 16-byte UUIDs;
    originals are arbitrary strings, mapped via uuid5).
    """
    import glob as globmod
    import uuid as uuid_mod

    import h5py

    from deepmod_tpu_torch.align.alignfile import write_basecall_bam
    from deepmod_tpu_torch.io.pod5 import write_pod5

    pod_reads = []
    bam_reads = []
    id_map: Dict[str, str] = {}
    for path in sorted(
        globmod.glob(os.path.join(fast5_dir, "**", "*.fast5"),
                     recursive=True)
    ):
        with h5py.File(path, "r") as fh:
            tmpl = fh["Analyses/Basecall_1D_000/BaseCalled_template"]
            fastq = tmpl["Fastq"][()].decode().split("\n")
            read_id, seq = fastq[0][1:], fastq[1]
            move = np.asarray(tmpl["Move"][()], np.int64)
            seg = fh["Analyses/Segmentation_000/Summary/segmentation"]
            first = int(seg.attrs["first_sample_template"])
            raw = next(iter(fh["Raw/Reads"].values()))
            signal = np.asarray(raw["Signal"][()], np.int16)
        rid = uuid_mod.uuid5(uuid_mod.NAMESPACE_URL, read_id)
        id_map[read_id] = str(rid)
        pod_reads.append((rid.bytes, signal))
        bam_reads.append((str(rid), seq, 2, move, first))
    write_pod5(out_pod5, pod_reads)
    write_basecall_bam(out_bam, bam_reads)
    return id_map


def write_move_dataset_pod5(
    out_dir: str, config: SynthConfig, n_files: int = 1,
    genome: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, str], List[SimulatedRead], Dict[str, str]]:
    """Move-style dataset as the modern ONT stack, without h5py.

    Simulates the reads exactly as ``generate_dataset`` does for
    ``fast5_style='move'`` (same RNG stream: the genome unless ``genome``
    is given, then per read the read, its ``mod_site_prob`` mask where the
    config has a landscape, and its signal) and writes ``ref.fa``, ``pod5/reads.pod5`` (raw
    signal, uncompressed, so no zstandard is needed; with ``n_files`` > 1
    the reads in order over ``pod5/reads_<k>.pod5``, k = 0..n_files-1,
    as even as they divide) and one ``calls.bam`` for all of them
    (sequence + mv:B:c stride/moves + ts:i trim) under ``out_dir``. The
    signal, moves and trim are those ``convert_move_dataset_to_pod5``
    would copy out of the fast5 files, so a detect run over this pair
    (``--wrkBase out_dir/pod5 --basecalls out_dir/calls.bam``) matches a
    run over the fast5 dataset. Returns (genome, reads,
    {read_id: pod5 uuid}); each read's ``path`` is the pod5 file.
    """
    import uuid as uuid_mod

    from deepmod_tpu_torch.align.alignfile import write_basecall_bam
    from deepmod_tpu_torch.io.fasta import write_fasta
    from deepmod_tpu_torch.io.pod5 import write_pod5

    if config.reads_per_file != 1:
        raise ValueError(
            "write_move_dataset_pod5 simulates single-read datasets "
            "(reads_per_file=1)"
        )
    rng = np.random.RandomState(config.seed)
    if genome is None:
        genome = make_genome(rng, config.genome_sizes)
    pod_dir = os.path.join(out_dir, "pod5")
    os.makedirs(pod_dir, exist_ok=True)
    write_fasta(os.path.join(out_dir, "ref.fa"), genome)
    if n_files == 1:
        paths = [os.path.join(pod_dir, "reads.pod5")]
    else:
        paths = [os.path.join(pod_dir, f"reads_{k:03d}.pod5")
                 for k in range(n_files)]
    reads: List[SimulatedRead] = []
    pod_reads: List[list] = [[] for _ in paths]
    bam_reads = []
    id_map: Dict[str, str] = {}
    for i in range(config.num_reads):
        k = i * len(paths) // config.num_reads
        chrom, strand, start, segment, seq, ref_pos = simulate_read(
            rng, genome, config, return_ref_pos=True
        )
        mod_mask = None
        if config.mod_site_prob is not None and config.mod_level_shift:
            mod_mask = _site_prob_mask(
                rng, genome[chrom],
                config.mod_site_prob.get(chrom, np.zeros(0)),
                strand, ref_pos,
            )
        read_id = f"synthread_{i:04d}"
        signal = synth_signal(rng, seq, config, mod_mask)[0]
        move, signal, first = _move_layout(seq, signal)
        rid = uuid_mod.uuid5(uuid_mod.NAMESPACE_URL, read_id)
        id_map[read_id] = str(rid)
        pod_reads[k].append((rid.bytes, signal))
        bam_reads.append((str(rid), seq, 2, move.astype(np.int64), first))
        reads.append(
            SimulatedRead(read_id, chrom, strand, start, segment, seq,
                          paths[k])
        )
    for path, file_reads in zip(paths, pod_reads):
        write_pod5(path, file_reads, compress=False)
    write_basecall_bam(os.path.join(out_dir, "calls.bam"), bam_reads)
    return genome, reads, id_map
