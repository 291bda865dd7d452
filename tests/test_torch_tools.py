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
