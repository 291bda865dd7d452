"""Command-line interface of the PyTorch port.

``detect``, ``train``, ``getfeatures`` and ``predfeatures`` take the JAX
package's flags (bin/DeepMod.py:304-383 names and defaults), and the
post-hoc commands ``merge``, ``motif``, ``clusterpred``, ``clustertrain``,
``evaluate`` and ``align`` take the JAX CLI's, and ``serve`` those of
the JAX ``serve.main``. ``detect``, ``train``, ``predfeatures``,
``clusterpred``, ``clustertrain`` and ``serve`` add ``--device``
(``cuda`` by default; ``cpu`` only when asked for); ``detect`` adds
``--perRead 0`` (BEDs only, no per-read HDF5). ``getfeatures`` and the
other post-hoc commands are host-only. ``synth`` generates a synthetic
dataset (fast5, or with ``--pod5`` a pod5 + basecall BAM pair that needs
no h5py).
"""

from __future__ import annotations

import argparse
import os
import sys


def _align_str(value: str) -> str:
    """Validate --alignStr at parse time."""
    if value in ("bwa", "minimap2", "builtin", "auto"):
        return value
    if value.endswith((".sam", ".sam.gz", ".bam")):
        if not os.path.isfile(value):
            raise argparse.ArgumentTypeError(
                f"alignment file not found: {value}"
            )
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r}: expected bwa|minimap2|builtin|auto or a "
        ".sam/.sam.gz/.bam path"
    )


def _common_flags(parser: argparse.ArgumentParser) -> None:
    # names/defaults from DeepMod.py:305-319
    parser.add_argument("--outLevel", type=int, default=2, choices=[0, 1, 2, 3])
    parser.add_argument("--wrkBase", help="The base folder for FAST5 files.")
    parser.add_argument("--FileID", default="mod")
    parser.add_argument("--outFolder", default="./mod_output")
    parser.add_argument("--recursive", type=int, default=1, choices=[0, 1])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--files_per_thread", type=int, default=1000)
    parser.add_argument("--windowsize", type=int, default=21)
    parser.add_argument(
        "--alignStr", type=_align_str, default="auto",
        help="bwa | minimap2 | builtin | auto, or a path to a pre-aligned "
        ".sam/.sam.gz/.bam to skip alignment",
    )
    parser.add_argument(
        "--SignalGroup", type=str, default="simple", choices=["simple", "rundif"]
    )
    parser.add_argument("--move", default=False, action="store_true")
    parser.add_argument("--basecall_1d", default="Basecall_1D_000")
    parser.add_argument("--basecall_2strand", default="BaseCalled_template")


def _parse_host_shard(spec):
    """'i:n' -> (i, n) stripe of the fast5 list, or None."""
    if not spec:
        return None
    try:
        i_s, n_s = spec.split(":")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise SystemExit(f"--hostShard {spec!r}: expected i:n (e.g. 0:4)")
    if not 0 <= i < n:
        raise SystemExit(f"--hostShard {spec!r}: need 0 <= i < n")
    return (i, n)


def _parse_regions(spec):
    """'chr:1:100000;chr2:10000' -> [(chr, 1, 100000), ...] (DeepMod.py:152-160)."""
    if not spec:
        return [(None, None, None)]
    out = []
    for part in spec.split(";"):
        bits = part.split(":")
        out.append(
            (
                bits[0] if bits[0] else None,
                int(bits[1]) if len(bits) > 1 and bits[1] else None,
                int(bits[2]) if len(bits) > 2 and bits[2] else None,
            )
        )
    return out


def cmd_detect(args) -> int:
    from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run

    config = DetectConfig(
        wrk_base=args.wrkBase,
        ref=args.Ref,
        model_path=args.modfile,
        out_folder=args.outFolder,
        file_id=args.FileID,
        base=args.Base,
        fnum=args.fnum,
        window_size=args.windowsize,
        align_str=args.alignStr,
        basecall_1d=args.basecall_1d,
        basecall_2strand=args.basecall_2strand,
        signal_group=args.SignalGroup,
        move=args.move,
        con_unk=args.ConUnk,
        output_layer=args.outputlayer,
        hidden=args.hidden,
        regions=_parse_regions(args.region),
        recursive=bool(args.recursive),
        files_per_batch=args.files_per_thread,
        pred_det=bool(args.predDet),
        pred_path=args.predpath,
        mod_cluster=bool(args.mod_cluster),
        threads=args.threads,
        precision=args.precision,
        trace_dir=args.trace,
        device_aggregation=bool(args.device_aggregation),
        target_only=bool(args.targetOnly),
        strict_ref_clips=bool(args.strictRefClips),
        host_shard=_parse_host_shard(args.hostShard),
        basecalls=args.basecalls or "",
        device=args.device,
        write_per_read=bool(args.perRead),
    )
    result = detect_run(config)
    print(
        f"detect done: {result.num_reads} reads, {result.num_windows} windows, "
        f"{len(result.bed_files)} BED files in {result.elapsed_s:.1f}s"
    )
    for kind, files in result.errors.items():
        print(f"  {kind}: {len(files)}")
    if args.outLevel <= 0 and result.stage_seconds:
        for name, secs in sorted(
            result.stage_seconds.items(), key=lambda kv: -kv[1]
        ):
            print(f"  stage {name}: {secs:.2f}s")
    if result.num_reads == 0 and result.errors:
        print("detect FAILED: zero reads processed", file=sys.stderr)
        return 1
    return 0


def cmd_train(args) -> int:
    from deepmod_tpu_torch.models.tf_import import load_model
    from deepmod_tpu_torch.train.loader import TestSplit, find_feature_files
    from deepmod_tpu_torch.train.trainer import TrainConfig, train_run

    # 'g1dir1,g1dir2;g2dir1' grouping (myMultiBiRNN.py:427-438)
    groups = []
    specs = args.wrkBase.split(";") if args.wrkBase else []
    if args.wrkBase2:
        specs.append(args.wrkBase2)
    split = TestSplit.parse(args.test) if args.test else None
    for spec in specs:
        files = []
        for folder in spec.split(","):
            if folder:
                files.extend(
                    find_feature_files(folder, bool(args.recursive), split)
                )
        if files:
            groups.append(files)
    if not groups:
        print("no feature files found", file=sys.stderr)
        return 1
    groups.sort(key=len, reverse=True)  # largest group drives (:457-458)
    init_params = None
    resume_opt_from = None
    if args.modfile:
        init_params, _ = load_model(args.modfile)
        if args.modfile.endswith(".npz"):
            # native checkpoints carry the Adam slots: --modfile continues
            # the run (the reference's resume never worked,
            # myMultiBiRNN.py:117); a TF checkpoint gives the params only
            resume_opt_from = args.modfile
    config = TrainConfig(
        out_folder=args.outFolder,
        file_id=args.FileID,
        fnum=args.fnum,
        hidden=args.hidden,
        window_size=args.windowsize,
        unbalanced=bool(args.unbalanced),
        output_layer=args.outputlayer,
        test=args.test,
        batch_size=args.batchsize,
        epochs=args.epochs,
        precision=args.trainPrecision,
        device=args.device,
    )
    train_run(
        groups, config, init_params=init_params,
        resume_opt_from=resume_opt_from,
    )
    print("Training Finished!")
    return 0


def cmd_getfeatures(args) -> int:
    from deepmod_tpu_torch.engine.getfeatures import (
        GetFeaturesConfig,
        getfeatures_run,
    )

    region = (None, None, None)
    if args.region:
        bits = [b.strip() for b in args.region.split(":")]
        region = (
            bits[0] if bits and bits[0] else None,
            int(bits[1]) if len(bits) > 1 and bits[1] else None,
            int(bits[2]) if len(bits) > 2 and bits[2] else None,
        )
    config = GetFeaturesConfig(
        wrk_base=args.wrkBase,
        ref=args.Ref,
        out_folder=args.outFolder,
        posneg=args.posneg,
        fnum=args.fnum,
        size_per_batch=args.size_per_batch,
        motif_or_pos=args.motifORPos,
        motif=args.motif,
        mod_offset=args.ModinMotif,
        fulmod_pattern=args.fulmod,
        anymod_pattern=args.anymod,
        nomod_pattern=args.nomod,
        region=region,
        basecall_1d=args.basecall_1d,
        basecall_2strand=args.basecall_2strand,
        signal_group=args.SignalGroup,
        move=args.move,
        align_str=args.alignStr,
        basecalls=args.basecalls or "",
        recursive=bool(args.recursive),
        files_per_batch=args.files_per_thread,
        save_format=args.save_format,
        threads=args.threads,
    )
    result = getfeatures_run(config)
    print(
        f"getfeatures done: {result.num_reads} reads, {result.num_rows} rows, "
        f"{len(result.feature_files)} files in {result.elapsed_s:.1f}s"
    )
    for kind, files in result.errors.items():
        print(f"  {kind}: {len(files)}")
    return 0


def cmd_predfeatures(args) -> int:
    """Standalone prediction over feature files with per-file tp/fp/fn/tn
    (the reference's mPred path, which its CLI never wired up —
    myMultiBiRNN.py:382-420, 465-477)."""
    from deepmod_tpu_torch.models.tf_import import load_model
    from deepmod_tpu_torch.train.loader import TestSplit, find_feature_files
    from deepmod_tpu_torch.train.trainer import predict_feature_files

    params, model_config = load_model(args.modfile)
    split = TestSplit.parse(args.test) if args.test else None
    files = []
    for folder in args.wrkBase.split(","):
        # P-mode: evaluate the HELD-OUT file complement; E-mode filtering
        # happens per-row inside load_feature_file(for_test=True)
        files.extend(
            find_feature_files(folder, bool(args.recursive), split,
                               for_test=True)
        )
    if not files:
        if split is not None and any(
            find_feature_files(folder, bool(args.recursive))
            for folder in args.wrkBase.split(",")
        ):
            print(
                "feature files exist but the --test split leaves an "
                "empty held-out set (P-mode file counts truncate like "
                "the reference: int(n_files * fraction))",
                file=sys.stderr,
            )
        else:
            print("no feature files found", file=sys.stderr)
        return 1
    out = os.path.join(args.outFolder, f"{args.FileID}_mpred.txt")
    os.makedirs(args.outFolder, exist_ok=True)
    results = predict_feature_files(
        params, model_config, files, out,
        window_size=args.windowsize, split=split, device=args.device,
    )
    tp = sum(r[0] for r in results.values())
    fp = sum(r[1] for r in results.values())
    fn = sum(r[2] for r in results.values())
    tn = sum(r[3] for r in results.values())
    print(f"total: tp={tp} fp={fp} fn={fn} tn={tn} -> {out}")
    return 0


def _device_flag(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help=f"where {what} runs; cuda raises without a GPU",
    )


def cmd_synth(args) -> int:
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        generate_dataset,
        write_move_dataset_pod5,
    )

    config = SynthConfig(
        genome_sizes={args.chrom: args.genome_size},
        num_reads=args.num_reads,
        seed=args.seed,
        mod_motif=args.motif if args.mod_shift else None,
        mod_level_shift=args.mod_shift,
        fast5_style="move" if args.pod5 else "v2",
    )
    if args.pod5:
        genome, reads, _ = write_move_dataset_pod5(args.out, config)
    else:
        genome, reads = generate_dataset(args.out, config)
    print(
        f"synth dataset at {args.out}: {len(genome)} chromosome(s), "
        f"{len(reads)} reads"
    )
    return 0


def cmd_align(args) -> int:
    """Standalone aligner: FASTA reads -> SAM on stdout (the in-process
    replacement for the reference's minimap2/bwa subprocess calls)."""
    from deepmod_tpu_torch.align.aligner import get_aligner
    from deepmod_tpu_torch.io.fasta import read_fasta

    aligner = get_aligner(args.Ref, args.alignStr)
    reads = read_fasta(args.fasta)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        out.write("@HD\tVN:1.6\tSO:unknown\n")
        ref = read_fasta(args.Ref)
        for name, seq in ref.items():
            out.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        n = 0
        for rec in aligner.align(reads):
            out.write(
                "\t".join(
                    [rec.qname, str(rec.flag), rec.rname, str(rec.pos),
                     str(rec.mapq), rec.cigar, "*", "0", "0", rec.seq, "*"]
                ) + "\n"
            )
            n += 1
        print(f"aligned {n}/{len(reads)} reads", file=sys.stderr)
    finally:
        if args.out:
            out.close()
    return 0


def cmd_merge(args) -> int:
    from deepmod_tpu_torch.tools.sum_chr_mod import merge_runs

    n = merge_runs(args.pred_folder, args.base, args.file_id, args.chrs)
    print(f"merged {n} BED files")
    return 0


def cmd_motif(args) -> int:
    from deepmod_tpu_torch.tools.motif_index import generate_motif_positions

    n = generate_motif_positions(args.ref, args.out, args.motif, args.base)
    print(f"wrote {n} index files")
    return 0


def cmd_clusterpred(args) -> int:
    from deepmod_tpu_torch.tools.cluster_predict import cluster_predict_run

    n = cluster_predict_run(
        args.pred_prefix, args.motif_folder, args.model, args.chrs,
        device=args.device,
    )
    print(f"rewrote {n} sites")
    return 0


def cmd_clustertrain(args) -> int:
    """Train the cluster-effect MLP from a merged BED + per-site truth
    fractions (chr strand pos fraction whitespace files)."""
    import numpy as np

    from deepmod_tpu_torch.tools.cluster_predict import (
        _read_motif_positions,
        _read_pred_bed,
        build_cluster_features,
    )
    from deepmod_tpu_torch.train.cluster_trainer import (
        ClusterTrainConfig,
        save_cluster_npz,
        train_cluster_model,
    )

    truth = {}
    with open(args.truth) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 4:
                truth[(parts[1], int(parts[2]))] = float(parts[3])
    feats = []
    targets = []
    for chrom in args.chrs:
        motif_path = os.path.join(args.motif_folder, f"motif_{chrom}_C.bed")
        pred_path = f"{args.pred_prefix}.{chrom}.C.bed"
        if not (os.path.isfile(motif_path) and os.path.isfile(pred_path)):
            continue
        cg = _read_motif_positions(motif_path)
        keys, frac, _lines = _read_pred_bed(pred_path, cg)
        if not keys:
            continue
        x = build_cluster_features(keys, frac)
        for row, key in zip(x, keys):
            if key in truth:
                feats.append(row)
                targets.append(truth[key])
    if not feats:
        print("no (site, truth) pairs found", file=sys.stderr)
        return 1
    params, history = train_cluster_model(
        np.asarray(feats, np.float32),
        np.asarray(targets, np.float32),
        ClusterTrainConfig(epochs=args.epochs),
        device=args.device,
    )
    save_cluster_npz(args.out, params)
    print(
        f"trained on {len(feats)} sites; loss {history[0]:.4f} -> "
        f"{history[-1]:.4f}; saved {args.out}"
    )
    return 0


def cmd_serve(args) -> int:
    from deepmod_tpu_torch.serve import serve

    server = serve(args.Ref, args.modfile, args.port, args.host, args.Base,
                   args.alignStr, precision=args.precision,
                   threads=args.threads, basecalls=args.basecalls,
                   device=args.device)
    print(f"deepmod_tpu_torch serving on {args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.dmt_service.close()
    return 0


def cmd_evaluate(args) -> int:
    from deepmod_tpu_torch.tools.evaluate import ecoli_performance

    metrics = ecoli_performance(
        args.mod_bed, args.ctrl_bed, args.ref, args.motif, args.out_prefix
    )
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepmod_tpu_torch",
        description=(
            "Detection of nucleotide modifications from nanopore signal "
            "data on PyTorch/CUDA."
        ),
    )
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("detect", help="Detect modifications at genomic scale")
    _common_flags(p)
    p.add_argument("--Ref")
    p.add_argument("--predDet", type=int, default=1, choices=[0, 1])
    p.add_argument("--predpath", default=None)
    p.add_argument("--modfile", type=str, default=None)
    p.add_argument("--fnum", type=int, default=7)
    p.add_argument("--hidden", type=int, default=100)
    p.add_argument("--region", default=None)
    p.add_argument("--ConUnk", default=True, type=lambda s: s not in ("False", "0"))
    p.add_argument("--outputlayer", default="", choices=["", "sigmoid"])
    p.add_argument("--Base", type=str, default="C", choices=["A", "C", "G", "T"])
    p.add_argument("--mod_cluster", default=0, type=int, choices=[0, 1])
    p.add_argument(
        "--precision", default="bf16", choices=["fp32", "bf16"],
        help="bf16 keeps weights, inputs and sequences in bfloat16 with "
        "fp32 accumulation and cell state",
    )
    p.add_argument(
        "--trace", default=None,
        help="write a torch.profiler chrome trace (detect.json) here",
    )
    p.add_argument(
        "--device_aggregation", type=int, default=0, choices=[0, 1],
        help="aggregate position counts on the device (index_add_ over "
        "the predictor's shards; with one device the host path runs)",
    )
    p.add_argument(
        "--targetOnly", type=int, default=0, choices=[0, 1],
        help="classify only windows whose reference base is --Base "
        "(BED-identical, per-read files carry mod_pred 0 on non-target "
        "rows)",
    )
    p.add_argument(
        "--strictRefClips", type=int, default=1, choices=[0, 1],
        help="1 (default): replicate the reference detect path's swapped "
        "minus-strand trim accounting (required for BED parity with the "
        "reference); 0: keep those reads with self-consistent windows",
    )
    p.add_argument(
        "--basecalls", default=None, metavar="calls.bam",
        help="dorado-style basecall BAM/SAM (mv:B:c + ts:i tags) "
        "enabling .pod5 inputs under --wrkBase",
    )
    p.add_argument(
        "--hostShard", default=None, metavar="I:N",
        help="process stripe i:n of the input file list for the MANUAL "
        "multi-run workflow (independent hosts, no torch.distributed; "
        "combine with disjoint --FileIDs and 'merge'). Under an "
        "initialized torch.distributed runtime sharding + the collective "
        "BED merge are automatic and this flag is unnecessary",
    )
    p.add_argument(
        "--perRead", type=int, default=1, choices=[0, 1],
        help="1 (default): write the per-read predetail HDF5 and index "
        "files; 0: BEDs only (needs no h5py)",
    )
    _device_flag(p, "the classifier")
    p.set_defaults(func=cmd_detect)

    p = sub.add_parser("train", help="Train a modification classifier")
    _common_flags(p)
    p.add_argument("--wrkBase2")
    p.add_argument("--fnum", type=int, default=7)
    p.add_argument("--hidden", type=int, default=100)
    p.add_argument(
        "--modfile", type=str, default=None,
        help="start from a model: an .npz checkpoint (params and Adam "
        "slots) or a TF1 checkpoint prefix (params)",
    )
    p.add_argument("--test", default=None)
    p.add_argument("--outputlayer", default="", choices=["", "sigmoid"])
    p.add_argument("--unbalanced", type=int, default=0, choices=[0, 1])
    p.add_argument(
        "--batchsize", type=int, default=2048,
        help="train minibatch (the reference's 2048)",
    )
    p.add_argument(
        "--epochs", type=int, default=4,
        help="passes over the feature files (the reference's 4)",
    )
    p.add_argument(
        "--trainPrecision", default="fp32", choices=["fp32", "bf16"],
        help="bf16 stores the training kernels' residual and gradient "
        "sequences in bfloat16 (fp32 weights, compute and weight "
        "gradients); fp32 matches the reference's arithmetic",
    )
    _device_flag(p, "training")
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("getfeatures", help="Extract training features")
    _common_flags(p)
    p.add_argument("--posneg", type=int, default=0, choices=[0, 1])
    p.add_argument("--size_per_batch", type=float, default=1)
    p.add_argument("--fnum", type=int, default=7)
    p.add_argument("--region", type=str, default=None)
    p.add_argument("--motifORPos", type=int, default=1)
    p.add_argument("--motif", default="CG", type=str)
    p.add_argument("--ModinMotif", default=0, type=int)
    p.add_argument("--Ref")
    p.add_argument("--fulmod", type=str)
    p.add_argument("--anymod", type=str)
    p.add_argument("--nomod", type=str)
    p.add_argument(
        "--basecalls", default=None, metavar="calls.bam",
        help="dorado-style basecall BAM/SAM (mv:B:c + ts:i) enabling "
        ".pod5 inputs under --wrkBase (same path as detect)",
    )
    p.add_argument(
        "--save_format", default="xy.gz", choices=["xy.gz", "npz", "both"]
    )
    p.set_defaults(func=cmd_getfeatures)

    p = sub.add_parser(
        "predfeatures", help="Predict over feature files (tp/fp/fn/tn per file)"
    )
    _common_flags(p)
    p.add_argument("--modfile", type=str, required=True)
    p.add_argument("--test", default=None)
    _device_flag(p, "the classifier")
    p.set_defaults(func=cmd_predfeatures)

    p = sub.add_parser("synth", help="Generate a synthetic test dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--chrom", default="chrS")
    p.add_argument("--genome-size", type=int, default=50000)
    p.add_argument("--num-reads", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--motif", default="CG")
    p.add_argument("--mod-shift", type=float, default=0.0)
    p.add_argument(
        "--pod5", action="store_true",
        help="write move-style reads as pod5/reads.pod5 + calls.bam "
        "(no h5py) instead of fast5",
    )
    p.set_defaults(func=cmd_synth)

    p = sub.add_parser("align", help="Align FASTA reads -> SAM (built-in aligner)")
    p.add_argument("--Ref", required=True)
    p.add_argument("--fasta", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--alignStr", type=_align_str, default="builtin")
    p.set_defaults(func=cmd_align)

    p = sub.add_parser("merge", help="Merge mod_pos BEDs across runs")
    p.add_argument("pred_folder")
    p.add_argument("base")
    p.add_argument("file_id")
    p.add_argument("chrs", nargs="?", default=None)
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("motif", help="Generate genome motif position index")
    p.add_argument("--ref", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--motif", default="CG")
    p.add_argument("--base", default="C")
    p.set_defaults(func=cmd_motif)

    p = sub.add_parser(
        "clusterpred", help="Cluster-effect second-stage 5mC refinement"
    )
    p.add_argument("pred_prefix")
    p.add_argument("motif_folder")
    p.add_argument(
        "--model", default=None,
        help="an .npz cluster model or a TF1 checkpoint prefix (default: "
        "the reference's TF1 checkpoint)",
    )
    p.add_argument("--chrs", nargs="*", default=None)
    _device_flag(p, "the cluster MLP")
    p.set_defaults(func=cmd_clusterpred)

    p = sub.add_parser(
        "clustertrain", help="Train the cluster-effect second-stage model"
    )
    p.add_argument("pred_prefix")
    p.add_argument("motif_folder")
    p.add_argument("--truth", required=True,
                   help="whitespace file: chr strand pos fraction")
    p.add_argument("--out", required=True)
    p.add_argument("--chrs", nargs="+", required=True)
    p.add_argument("--epochs", type=int, default=10)
    _device_flag(p, "training")
    p.set_defaults(func=cmd_clustertrain)

    p = sub.add_parser("serve", help="Long-lived detection HTTP service")
    p.add_argument("--Ref", required=True)
    p.add_argument(
        "--modfile", required=True,
        help="an .npz model or a TF1 checkpoint prefix",
    )
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--Base", default="C")
    p.add_argument("--alignStr", type=_align_str, default="builtin")
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--threads", type=int, default=1,
                   help="host-stage workers (persistent HostPool)")
    p.add_argument(
        "--basecalls", default="", metavar="calls.bam",
        help="dorado-style basecall BAM/SAM (mv/ts tags) enabling .pod5 "
        "request paths",
    )
    _device_flag(p, "the classifier")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("evaluate", help="Motif-ground-truth AUC/AP evaluation")
    p.add_argument("--mod-bed", required=True, nargs="+")
    p.add_argument("--ctrl-bed", required=True, nargs="+")
    p.add_argument("--ref", required=True)
    p.add_argument("--motif", default="CG")
    p.add_argument("--out-prefix", default="perf")
    p.set_defaults(func=cmd_evaluate)
    return parser


def _print_parameters(args) -> None:
    """Startup config dump, like the reference's printParameters
    (DeepMod.py:36-42): one right-aligned 'key: value' line per option."""
    print("%30s: %s" % ("Current directory", os.getcwd()))
    for key in sorted(vars(args)):
        if key == "func":
            continue
        print("%30s: %s" % (key, vars(args)[key]))
    sys.stdout.flush()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    if getattr(args, "outLevel", 2) <= 1:
        _print_parameters(args)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
