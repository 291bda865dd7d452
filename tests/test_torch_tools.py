"""The port's post-hoc tools against the JAX package's, on the CPU:
``merge``, ``motif``, ``evaluate`` and ``align``.

The same seeded inputs go through both packages (their functions and
their CLIs). Tolerances: merge and motif outputs and align's SAM text
byte for byte; evaluate's metrics within 1e-12 of the JAX package's
(which uses sklearn); the port's numpy ROC/PR functions within 1e-12 of
sklearn's on scores with ties (sklearn is imported here, never in the
port).
"""

import contextlib
import filecmp
import io
import os
import shutil

import numpy as np
import pytest
from sklearn import metrics as skm

from deepmod_tpu import cli as jax_cli
from deepmod_tpu.aggregate.summarize import bed_line
from deepmod_tpu.io.fasta import write_fasta
from deepmod_tpu.testing.synthetic import SynthConfig, make_genome, simulate_read
from deepmod_tpu.tools.evaluate import ecoli_performance as jax_ecoli
from deepmod_tpu.tools.motif_index import (
    generate_motif_positions as jax_motif,
)
from deepmod_tpu.tools.sum_chr_mod import merge_runs as jax_merge
from deepmod_tpu_torch import cli as torch_cli
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.tools import evaluate as ev
from deepmod_tpu_torch.tools.motif_index import generate_motif_positions
from deepmod_tpu_torch.tools.sum_chr_mod import merge_runs


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(args)) == 0
    return buf.getvalue()


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name
    return names


def _write_runs(root, rng, chroms=("chr1", "chr2", "chrX")):
    """Three detect runs' BEDs over overlapping random sites, at the
    depths merge globs (run/, run/sub/, run/sub/sub/)."""
    for k, depth in enumerate(("a", "b/x", "c/y/z")):
        for chrom in chroms:
            for strand in "+-":
                pos = np.unique(rng.randint(0, 400, 120))
                path = os.path.join(root, depth,
                                    f"mod_pos.{chrom}{strand}.C.bed")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as fh:
                    for p in pos:
                        cov = int(rng.randint(1, 1500))
                        mod = int(rng.binomial(cov, rng.rand()) * (rng.rand() > 0.2))
                        fh.write(bed_line(chrom, strand, int(p), "C", cov, mod))


@pytest.mark.parametrize("chrs", ["chr1,chrX", None])
def test_merge_matches_jax(tmp_path, chrs):
    rng = np.random.RandomState(3)
    src = str(tmp_path / "src")
    _write_runs(src, rng)
    shutil.copytree(src, str(tmp_path / "jax"))
    shutil.copytree(src, str(tmp_path / "torch"))
    shutil.copytree(src, str(tmp_path / "torch_cli"))
    want = jax_merge(str(tmp_path / "jax"), "C", "sum", chrs)
    assert want == (2 if chrs else 3)
    assert merge_runs(str(tmp_path / "torch"), "C", "sum", chrs) == want
    args = [str(tmp_path / "torch_cli"), "C", "sum"] + ([chrs] if chrs else [])
    assert _run(torch_cli.main, "merge", *args) == f"merged {want} BED files\n"
    names = _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch_cli"))
    merged = [n for n in names if n.startswith("sum.")]
    assert len(merged) == want
    text = open(os.path.join(str(tmp_path / "torch"), merged[0])).read()
    assert "  " in text and all(int(line.split()[11]) > 0
                                for line in text.splitlines())


@pytest.mark.parametrize("motif,base,offset", [("CG", "C", 0), ("GATC", "A", 1)])
def test_motif_matches_jax(tmp_path, motif, base, offset):
    genome = make_genome(np.random.RandomState(4),
                         {"chrA": 3000, "chrB": 1700, "chrC": 5})
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, genome)
    n = jax_motif(ref, str(tmp_path / "jax"), motif, base, offset)
    assert n == 6
    assert generate_motif_positions(ref, str(tmp_path / "torch"), motif, base,
                                    offset) == n
    assert len(_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))) == 6
    if offset == 0:
        out = _run(torch_cli.main, "motif", "--ref", ref, "--out",
                   str(tmp_path / "cli"), "--motif", motif, "--base", base)
        assert out == "wrote 6 index files\n"
        _same_tree(str(tmp_path / "jax"), str(tmp_path / "cli"))


def _scores(rng, n, kind):
    if kind == "int_ties":
        return rng.randint(0, 11, n)
    if kind == "float":
        return rng.rand(n)
    return np.round(rng.rand(n), 1)  # float ties


@pytest.mark.parametrize("kind", ["int_ties", "float", "float_ties"])
@pytest.mark.parametrize("seed", range(3))
def test_numpy_curves_match_sklearn(kind, seed):
    rng = np.random.RandomState(seed)
    for n in (2, 3, 17, 500):
        y = rng.randint(0, 2, n)
        y[0], y[1] = 0, 1
        s = _scores(rng, n, kind)
        for mine, theirs in zip(ev.roc_curve(y, s), skm.roc_curve(y, s)):
            np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-12)
        for mine, theirs in zip(ev.precision_recall_curve(y, s),
                                skm.precision_recall_curve(y, s)):
            np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-12)
        assert ev.roc_auc_score(y, s) == pytest.approx(
            skm.roc_auc_score(y, s), rel=1e-12, abs=1e-12)
        assert ev.average_precision_score(y, s) == pytest.approx(
            skm.average_precision_score(y, s), rel=1e-12, abs=1e-12)
    assert np.isnan(ev.roc_auc_score([1, 1, 1], [0.1, 0.2, 0.3]))


def _eval_inputs(root, seed):
    rng = np.random.RandomState(seed)
    seq = "".join(rng.choice(list("ACGT"), 4000))
    ref = os.path.join(root, "ref.fa")
    write_fasta(ref, {"ecoli": seq})
    codes = np.frombuffer(seq.encode(), np.uint8)
    cg = np.flatnonzero((codes[:-1] == ord("C")) & (codes[1:] == ord("G")))
    other_c = np.setdiff1d(np.flatnonzero(codes == ord("C")), cg)[:120]

    def rows(positions, p_meth):
        out = []
        for p in positions:
            cov = int(rng.randint(1, 12))
            out.append(("ecoli", "+", int(p), cov,
                        int(rng.binomial(cov, p_meth))))
        return out

    for name, data in (
            ("mod/a", rows(cg, 0.8) + rows(other_c, 0.1)),
            ("mod/b", rows(cg[::2], 0.7)),  # overlapping sites re-merge
            ("ctl", rows(cg, 0.15) + rows(other_c, 0.1))):
        path = os.path.join(root, name, "mod_pos.ecoli+.C.bed")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            for r in sorted(data, key=lambda r: r[2]):
                fh.write(bed_line(*r[:2], r[2], "C", r[3], r[4]))
    return ref


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matches_jax(tmp_path, seed):
    root = str(tmp_path)
    ref = _eval_inputs(root, seed)
    args = ([os.path.join(root, "mod")], [os.path.join(root, "ctl")], ref)
    want = jax_ecoli(*args, make_plots=False)
    got = ev.ecoli_performance(*args, make_plots=False)
    assert sorted(got) == sorted(want)
    assert want["auc_cov1"] > 0.8 and want["num_positive_sites"] > 50
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12, abs=1e-12), key
    # and with the plots, through the CLI (matplotlib, lazily)
    prefix = os.path.join(root, "perf")
    out = _run(torch_cli.main, "evaluate", "--mod-bed", args[0][0],
               "--ctrl-bed", args[1][0], "--ref", ref, "--out-prefix", prefix)
    printed = dict(line.split(": ") for line in out.splitlines())
    assert float(printed["auc_cov5"]) == pytest.approx(
        want["auc_cov5"], rel=1e-12, nan_ok=True)
    assert os.path.isfile(prefix + "_roc.png")
    assert os.path.isfile(prefix + "_pr.png")


def test_align_sam_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    config = SynthConfig(read_length=(300, 600))
    genome = make_genome(rng, {"chrA": 6000, "chrB": 4000})
    reads = {}
    for i in range(12):
        seq = simulate_read(rng, genome, config)[4]
        reads[f"r{i}"] = seq
    reads["junk"] = "".join(rng.choice(list("ACGT"), 200))
    ref, fasta = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fa")
    write_fasta(ref, genome)
    write_fasta(fasta, reads)
    args = ["align", "--Ref", ref, "--fasta", fasta, "--alignStr", "builtin"]
    jax_cli.main(args + ["--out", str(tmp_path / "jax.sam")])
    torch_cli.main(args + ["--out", str(tmp_path / "torch.sam")])
    text = open(str(tmp_path / "jax.sam")).read()
    assert text.count("\n") >= 14 and "\tchrA\t" in text
    assert open(str(tmp_path / "torch.sam")).read() == text


# -- the JAX package's remaining scripts as port tools ---------------------
# each tool at a tiny size on the CPU (the kernels' plain versions), its
# JSON lines and its own checks; where the JAX script's deterministic part
# runs here, held against the JAX package


def _json_lines(text):
    import json

    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("fnum", [7, 57])
def test_probe_compact_pack_tool(fnum):
    from deepmod_tpu_torch.tools import probe_compact_pack

    lines = _json_lines(_run(probe_compact_pack.main, "--rows", "400",
                             "--passes", "1", "--fnum", str(fnum),
                             "--device", "cpu"))
    assert [r["mode"] for r in lines[:-1]] == ["plain", "packed"]
    summary = lines[-1]
    assert summary["metric"] == "compact_pack_speedup"
    assert summary["identical"] is True and summary["fnum"] == fnum
    for key in ("value", "unit", "best_plain_s", "best_packed_s", "rows"):
        assert key in summary
    per_row = summary["transfer_bytes_per_row"]
    assert per_row["packed"] < per_row["plain"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("fnum", [7, 57])
def test_probe_pack_rebuilds_the_plain_rows(fnum, precision):
    """The probe's packed columns (the JAX package's pack, cast on the
    host), rebuilt through its LUT on the CPU, are the plain rows cast to
    the kernel's dtype bit for bit; its packed transfer gives the
    predictions of ``WindowPredictor``'s compact path with fewer bytes a
    row; rows the pack cannot carry exactly raise."""
    import torch

    from deepmod_tpu_torch.engine.detect import WindowPredictor
    from deepmod_tpu_torch.models.bilstm import bilstm_logits
    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops.bilstm_fused import seq_dtype
    from deepmod_tpu_torch.tools import _probe
    from deepmod_tpu_torch.tools import probe_compact_pack as pcp

    dtype = seq_dtype(precision)
    rows = 300
    feats = _probe.engine_rows(np.random.RandomState(fnum), rows, fnum)
    feats[:, -3:-1] = np.random.RandomState(2).randn(rows, 2)  # bf16 rounds
    cols = pcp.pack_columns(feats, fnum, dtype)
    assert [c.dtype for c in cols[:-2]] == [torch.uint8] * (fnum == 57)
    assert cols[-2].dtype == torch.uint8 and cols[-1].dtype == dtype
    rebuilt = pcp.rebuild(cols, pcp.lut(dtype))
    plain_rows = torch.from_numpy(feats).to(dtype)
    assert rebuilt.shape == (rows, fnum) and rebuilt.dtype == dtype
    assert torch.equal(rebuilt.view(torch.uint8), plain_rows.view(torch.uint8))

    params, config = _probe.seeded_model(fnum)
    # the last class's bias shifted so that the classes tie at the median
    # window: a random model otherwise gives one class nearly everywhere
    windows = np.lib.stride_tricks.sliding_window_view(feats, 21, axis=0)
    logits = bilstm_logits(params_from_numpy(params, "cpu"), torch.from_numpy(
        windows.transpose(0, 2, 1).copy()), config)
    params["out_b"][1] -= float((logits[:, 1] - logits[:, 0]).median())
    pred = WindowPredictor(params, config, buckets=(64, 256), device="cpu",
                           precision=precision, compact_transfer=True)
    centers = np.arange(10, rows - 10, dtype=np.int64)
    want = pred.predict_from_features(feats, centers)
    got, moved = pcp.predict_packed(pred, feats, centers)
    assert 0 < int(want.sum()) < len(want)
    np.testing.assert_array_equal(got, want)
    # packed: every row once (two 256-row chunks, 20 rows of halo again);
    # plain: the 280 rows the windows read, fp32
    assert moved / (rows + 20) < pred.transfer_bytes / rows
    for cols_set, value in ((slice(fnum - 7, fnum - 6), 0.5),  # not 0/1
                            (slice(fnum - 7, fnum - 5), 1.0)):  # two hot
        odd = feats.copy()
        odd[7, cols_set] = value
        with pytest.raises(ValueError, match="one-hot"):
            pcp.pack_columns(odd, fnum, dtype)
    if fnum == 57:
        for value in (1.5, -1.0, 256.0):
            odd = feats.copy()
            odd[5, 3] = value
            with pytest.raises(ValueError, match="histogram"):
                pcp.pack_columns(odd, fnum, dtype)


def test_probe_device_agg_tool_matches_jax():
    from deepmod_tpu.parallel import mesh as jmesh
    from deepmod_tpu.parallel.aggregation import (
        sharded_position_counts as jax_counts,
    )
    from deepmod_tpu_torch.parallel.aggregation import sharded_position_counts
    from deepmod_tpu_torch.parallel.mesh import make_mesh
    from deepmod_tpu_torch.tools import probe_device_agg

    lines = _json_lines(_run(probe_device_agg.main, "--cpu-mesh", "4",
                             "--reps", "1", "--cases", "1000:5000,4000:3000"))
    summary = lines[-1]
    assert summary["metric"] == "device_aggregation_ab"
    assert summary["devices"] == 4 and len(summary["rows"]) == 2
    for row in summary["rows"]:
        assert row["counts_equal"] is True
        for key in ("n_obs", "chrom_len", "host_ms", "device_ms",
                    "device_over_host"):
            assert key in row
    # the tool's observations through both packages' reductions
    pos, cov, mod = probe_device_agg.observations(
        np.random.default_rng(0), 1001, 5000, 4)
    want = jax_counts(jmesh.make_mesh(4), pos, cov, mod, 5000)
    got = sharded_position_counts(make_mesh(devices=["cpu"] * 4), pos, cov,
                                  mod, 5000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bench_scale_multiproc_tool():
    from deepmod_tpu_torch.tools import bench_scale_multiproc

    lines = _json_lines(_run(bench_scale_multiproc.main, "--reads", "6",
                             "--genome-bp", "20000", "--nprocs", "1,2",
                             "--device", "cpu"))
    summary = lines[-1]
    assert summary["metric"] == "detect_multiproc_merge_overhead"
    assert summary["beds_identical"] is True
    rows = summary["rows"]
    assert [r["nproc"] for r in rows] == [1, 2]
    assert len({r["reads_total"] for r in rows}) == 1
    assert rows[0]["merge_s_max"] == 0.0 and rows[1]["merge_s_max"] > 0.0
    for key in ("cluster_wall_s", "engine_wall_s_max", "windows_total",
                "reads_per_s", "windows_per_s", "merge_s_min",
                "merge_frac_of_wall"):
        assert key in rows[1]
    assert len(summary["throughput_vs_1proc"]) == 2


def test_validate_full_loop_tool(tmp_path):
    """The loop through the CLI; its metrics are what the JAX package's
    evaluator computes on the loop's BEDs (within 1e-12)."""
    from deepmod_tpu_torch.tools import validate_full_loop

    out = str(tmp_path / "loop")
    lines = _json_lines(_run(
        validate_full_loop.main, "--out", out, "--small", "--device", "cpu",
        "--epochs", "1", "--hidden", "8", "--threads", "1",
        "--train-reads", "12", "--test-reads", "16"))
    report = lines[-1]
    for key in ("fnum", "labels", "train_precision", "total_s"):
        assert key in report
    got = report["full_loop_metrics"]
    beds = {name: [os.path.join(out, f"det_{name}", f"mod_pos.chrV{s}.C.bed")
                   for s in "+-"] for name in ("test_mod", "test_ctl")}
    want = jax_ecoli(beds["test_mod"], beds["test_ctl"],
                     os.path.join(out, "train_mod", "ref.fa"), "CG",
                     str(tmp_path / "jax_perf"), make_plots=False)
    assert got["num_sites"] > 0 and set(got) == set(want)
    for key, value in want.items():
        if np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            assert abs(got[key] - value) <= 1e-12, key


def test_coverage_scaling_tool(tmp_path):
    """The study's full-coverage BEDs (every read of the held-out cohorts
    re-aggregated) are the bytes detect writes for them."""
    from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run
    from deepmod_tpu_torch.tools import coverage_scaling

    out = str(tmp_path / "cov")
    lines = _json_lines(_run(
        coverage_scaling.main, "--out", out, "--small", "--device", "cpu",
        "--epochs", "1", "--hidden", "8", "--threads", "1",
        "--train-reads", "12", "--test-reads", "16"))
    result = lines[-1]["coverage_scaling"]
    assert sorted(result) == ["2x", "4x"]
    for metrics in result.values():
        for key in ("auc_cov1", "ap_cov1", "num_sites", "read_tp"):
            assert key in metrics
    assert result["2x"]["num_sites"] <= result["4x"]["num_sites"]
    cohort = os.path.join(out, "test_mod")
    detect_run(DetectConfig(
        wrk_base=os.path.join(cohort, "pod5"),
        ref=os.path.join(cohort, "ref.fa"),
        model_path=os.path.join(out, "train2", "1", "mod.npz"),
        out_folder=str(tmp_path / "det"), align_str="builtin", hidden=8,
        basecalls=os.path.join(cohort, "calls.bam"), write_per_read=False,
        device="cpu"))
    sub = os.path.join(out, "sub_test_mod_4x")
    names = sorted(n for n in os.listdir(sub) if n.endswith(".bed"))
    assert names
    for name in names:
        with open(os.path.join(sub, name)) as a, \
                open(str(tmp_path / "det" / name)) as b:
            assert a.read() == b.read(), name


def test_bench_scale_tool(tmp_path):
    from deepmod_tpu_torch.tools import bench_scale

    lines = _json_lines(_run(
        bench_scale.main, "--dataset", str(tmp_path / "ds"), "--reads", "2",
        "--genome-mbp", "0.02", "--threads", "1", "--hidden", "8",
        "--device", "cpu"))
    (row,) = lines
    assert row["metric"] == "detect_scale_windows_per_s"
    assert row["reads"] == 2 and row["windows"] > 0 and row["beds"] > 0
    for key in ("value", "unit", "run", "wall_s", "threads", "target_only",
                "stages", "errors"):
        assert key in row
    assert os.path.isdir(str(tmp_path / "ds" / "out_0"))


def test_probe_bf16_flips_tool_matches_jax():
    """The tool's flip count of the seeded windows, and its largest logit
    difference, against the JAX package's fp32 scan and bf16 mono kernel
    (interpret mode) on the same windows and numpy-seeded params."""
    import jax.numpy as jnp

    from deepmod_tpu.models import bilstm as jb
    from deepmod_tpu_torch.tools import _probe, probe_bf16_flips

    lines = _json_lines(_run(probe_bf16_flips.main, "--windows", "512",
                             "--reads", "2", "--device", "cpu"))
    assert [r["set"] for r in lines] == ["real", "random"]
    for row in lines:
        assert row["windows"] == 512
        for key in ("flips", "max_abs_dlogit", "min_margin", "p1_margin"):
            assert key in row
    params, config = _probe.seeded_model(7, hidden=16)
    x = np.random.default_rng(5).standard_normal((512, 21, 7)).astype(
        np.float32)
    got = probe_bf16_flips.flip_stats(params, config, x, "cpu")
    jcfg = jb.BiLSTMConfig(num_input=7, num_hidden=16)
    jp = {k: v for k, v in params.items()}
    lf = np.asarray(jb.bilstm_logits(jp, jnp.asarray(x), jcfg))
    lb = np.asarray(jb.bilstm_logits(jp, jnp.asarray(x), jcfg,
                                     use_pallas=True, precision="bf16"))
    assert got["flips"] == int((lf.argmax(1) != lb.argmax(1)).sum())
    np.testing.assert_allclose(got["max_abs_dlogit"],
                               float(np.abs(lf - lb).max()), atol=2e-3)
    margin = np.abs(lf[:, 1] - lf[:, 0])
    np.testing.assert_allclose(got["min_margin"], margin.min(), atol=2e-5)


def test_probe_train_bf16_tool():
    from deepmod_tpu_torch.tools import probe_train_bf16

    lines = _json_lines(_run(probe_train_bf16.main, "--iters", "1",
                             "--batches", "256", "--device", "cpu"))
    assert [r.get("precision") for r in lines[:2]] == ["fp32", "bf16"]
    for row in lines[:2]:
        assert np.isfinite(row["loss_after"]) and row["steps_per_s"] > 0
    summary = lines[-1]
    assert summary["metric"] == "train_bf16_speedup"
    # bf16 storage at one bf16 rounding a step: the same loss to 1e-2
    assert summary["loss_delta"] < 1e-2


def test_probe_tile_tool():
    from deepmod_tpu_torch.tools import probe_tile

    lines = _json_lines(_run(probe_tile.main, "--batch", "64", "--tiles",
                             "8,40,44", "--train-batch", "32", "--device",
                             "cpu"))
    rows = {(r["precision"], r["tile_b"]): r for r in lines[:-1]}
    assert sorted(rows) == [("bf16", 64), ("fp32", 8), ("fp32", 40),
                            ("fp32", 44)]
    assert "multiple of 8" in rows[("fp32", 44)]["error"]
    for key in (("fp32", 8), ("fp32", 40), ("bf16", 64)):
        assert rows[key]["ms"] > 0
    assert rows[("fp32", 40)]["split"] == 2
    assert lines[-1]["train_steps_per_s"] > 0


def test_probe_lookahead_tool():
    import deepmod_tpu_torch.engine.detect as D
    from deepmod_tpu_torch.tools import probe_lookahead

    lines = _json_lines(_run(probe_lookahead.main, "--rows", "400",
                             "--passes", "1", "--depths", "1,3",
                             "--device", "cpu"))
    assert [r["depth"] for r in lines[:-1]] == [1, 3]
    assert sorted(lines[-1]["value"]) == ["1", "3"]
    assert D._LOOKAHEAD == lines[-1]["default_depth"] == 2


def test_probe_target_only_tool(tmp_path):
    from deepmod_tpu_torch.tools import probe_target_only

    lines = _json_lines(_run(
        probe_target_only.main, "--dataset", str(tmp_path / "ds"),
        "--reads", "2", "--genome-mbp", "0.02", "--threads", "1",
        "--hidden", "8", "--device", "cpu"))
    modes = [next(iter(r)) for r in lines[:-1]]
    assert modes == ["A_standard_compact", "B_targetonly_compact",
                     "C_targetonly_window"]
    # targetOnly classifies fewer windows in the window mode only
    windows = [r[m]["windows"] for r, m in zip(lines, modes)]
    assert windows[0] == windows[1] >= windows[2] > 0
    assert lines[-1]["beds_identical"] is True
    assert len(set(map(str, lines[-1]["md5"].values()))) == 1


def test_probe_sigmoid_tool_needs_a_card_and_builds_a_variant(monkeypatch,
                                                              tmp_path):
    """The tanh-sigmoid K1 is a CUDA build: the tool refuses the CPU. Its
    build is K1's source alone with -DDMT_TANH_SIGMOID in its own
    directory, the default build never sets the define, and ``variant``
    routes the wrappers' launches to it only inside its block."""
    import torch

    from deepmod_tpu_torch.ops import _build
    from deepmod_tpu_torch.tools import probe_sigmoid

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            probe_sigmoid.main(["--batches", "64"])
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build(sources=None, defines=(), build_dir=None):
        calls.append((sources, defines, build_dir))
        return str(tmp_path / "lib.so")

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_variants", {})
    monkeypatch.setattr(_build, "_lib", "default")
    with _build.variant(_build.TANH_SIGMOID) as lib:
        assert _build.library() is lib
    assert _build.library() == "default"
    ((sources, defines, build_dir),) = calls
    assert [os.path.basename(s) for s in sources] == ["bilstm_fused.cu"]
    assert defines == ("DMT_TANH_SIGMOID",)
    assert os.path.basename(build_dir) == "kernels_dmt_tanh_sigmoid"
    assert not any("TANH" in f for f in _build.NVCC_FLAGS)
    with open(os.path.join(_build.CSRC_DIR, "lstm_common.cuh")) as fh:
        src = fh.read()
    assert src.count("#ifdef DMT_TANH_SIGMOID") == 1
    # the default branch keeps the exp sigmoids
    default = src.split("#else", 1)[1].split("#endif", 1)[0]
    assert "expf(-gi)" in default and "tanhf" not in default
