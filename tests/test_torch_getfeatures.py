"""The port's getfeatures against the JAX package's, on the CPU, and the
port's train / getfeatures / predfeatures command lines.

The datasets are those of tests/test_train_e2e.py (a 15 kb genome, 6
reads, a CG signal shift on 'mod' only). Both packages extract features
from the same files; their ``.xy.npz`` arrays (``pos`` included), the
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
decompressed ``.xy.gz`` text (the gzip bytes may differ: the JAX package
formats natively, the port with np.savetxt), the ``.xy.ind`` files and
the counts must be equal. The pod5 + basecall BAM route runs the port on
``write_move_dataset_pod5`` output and the JAX package on the move-style
fast5 dataset of the same seed: arrays and ``.ind`` row offsets equal.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from deepmod_tpu.engine.getfeatures import GetFeaturesConfig as JaxConfig
from deepmod_tpu.engine.getfeatures import getfeatures_run as jax_run
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu_torch.engine.getfeatures import GetFeaturesConfig, getfeatures_run


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(genome_sizes={"chrS": 15000}, num_reads=6,
              read_length=(700, 1100), sub_rate=0.002, ins_rate=0.001,
              del_rate=0.001)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_gf"))
    mod_dir = os.path.join(base, "mod")
    ctl_dir = os.path.join(base, "ctl")
    generate_dataset(mod_dir, SynthConfig(seed=100, mod_motif="CG", mod_offset=0,
                                          mod_level_shift=1.5, **COMMON))
    generate_dataset(ctl_dir, SynthConfig(seed=100, **COMMON))
    return base, mod_dir, ctl_dir


def _run_both(base, tag, **kw):
    jax_res = jax_run(JaxConfig(out_folder=os.path.join(base, f"jax_{tag}"), **kw))
    torch_res = getfeatures_run(GetFeaturesConfig(
        out_folder=os.path.join(base, f"torch_{tag}"), **kw))
    return jax_res, torch_res


def _rel(res):
    return [os.path.relpath(p, res.out_folder) for p in res.feature_files]


def _stem(path):
    for suffix in (".xy.gz", ".xy.npz"):
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


def _assert_same_arrays(jax_res, torch_res):
    for a, b in zip(jax_res.feature_files, torch_res.feature_files):
        za, zb = np.load(_stem(a) + ".xy.npz"), np.load(_stem(b) + ".xy.npz")
        assert za.files == zb.files == ["xy", "pos"]
        for key in za.files:
            assert za[key].dtype == zb[key].dtype
            np.testing.assert_array_equal(za[key], zb[key])


def _ind_rows(path):
    with open(_stem(path) + ".xy.ind") as fh:
        return [int(line.split()[0]) for line in fh]


def _assert_same_counts(jax_res, torch_res):
    assert torch_res.num_reads == jax_res.num_reads > 0
    assert torch_res.num_rows == jax_res.num_rows > 0
    assert torch_res.errors == jax_res.errors
    assert _rel(torch_res) == _rel(jax_res)


@pytest.fixture(scope="module")
def motif_runs(datasets):
    base, mod_dir, ctl_dir = datasets
    runs = {}
    for name, d, posneg in (("mod", mod_dir, 1), ("ctl", ctl_dir, 0)):
        runs[name] = _run_both(
            base, name, wrk_base=os.path.join(d, "fast5"),
            ref=os.path.join(d, "ref.fa"), posneg=posneg, motif="CG",
            align_str="builtin", save_format="both")
    return runs


@pytest.mark.parametrize("name", ["mod", "ctl"])
def test_motif_mode_equals_jax(motif_runs, name):
    jax_res, torch_res = motif_runs[name]
    _assert_same_counts(jax_res, torch_res)
    _assert_same_arrays(jax_res, torch_res)
    for a, b in zip(jax_res.feature_files, torch_res.feature_files):
        assert a.endswith(".xy.gz") and b.endswith(".xy.gz")
        with gzip.open(a) as fa, gzip.open(b) as fb:
            text = fb.read()
            assert text == fa.read()
            assert text
        with open(_stem(a) + ".xy.ind") as fa, open(_stem(b) + ".xy.ind") as fb:
            assert fb.read() == fa.read()


def test_position_file_mode_equals_jax(datasets, tmp_path):
    """motifORPos 2: labels from fulmod / nomod position files."""
    base, mod_dir, _ = datasets
    from deepmod_tpu_torch.features.labels import scan_motif
    from deepmod_tpu_torch.io.fasta import read_fasta

    fulmod, _ = scan_motif(read_fasta(os.path.join(mod_dir, "ref.fa")), "CG", 0)
    fulmod_path = str(tmp_path / "fulmod.txt")
    nomod_path = str(tmp_path / "nomod.txt")
    with open(fulmod_path, "w") as fm, open(nomod_path, "w") as nm:
        for chrom, keys in fulmod.items():
            for strand, pos in sorted(keys):
                (fm if pos % 3 == 0 else nm).write(f"{chrom} {strand} {pos}\n")
    jax_res, torch_res = _run_both(
        str(tmp_path), "pos", wrk_base=os.path.join(mod_dir, "fast5"),
        ref=os.path.join(mod_dir, "ref.fa"), posneg=1, motif_or_pos=2,
        fulmod_pattern=fulmod_path, nomod_pattern=nomod_path, motif="CG",
        align_str="builtin", save_format="npz")
    _assert_same_counts(jax_res, torch_res)
    _assert_same_arrays(jax_res, torch_res)
    xy = np.load(torch_res.feature_files[0])["xy"]
    assert (xy[:, 1] == 1).any() and (xy[:, 2] == 1).any()


def test_pod5_route_equals_jax_fast5(tmp_path):
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig as TorchSynthConfig,
        write_move_dataset_pod5,
    )

    kw = dict(COMMON, seed=100, mod_motif="CG", mod_level_shift=1.5,
              fast5_style="move")
    f5_dir, pod_dir = str(tmp_path / "f5"), str(tmp_path / "pod")
    generate_dataset(f5_dir, SynthConfig(**kw))
    _, _, id_map = write_move_dataset_pod5(pod_dir, TorchSynthConfig(**kw))
    common = dict(posneg=1, motif="CG", align_str="builtin", move=True,
                  save_format="npz")
    jax_res = jax_run(JaxConfig(
        wrk_base=os.path.join(f5_dir, "fast5"), ref=os.path.join(f5_dir, "ref.fa"),
        out_folder=str(tmp_path / "jax_out"), **common))
    torch_res = getfeatures_run(GetFeaturesConfig(
        wrk_base=os.path.join(pod_dir, "pod5"), ref=os.path.join(pod_dir, "ref.fa"),
        basecalls=os.path.join(pod_dir, "calls.bam"),
        out_folder=str(tmp_path / "torch_out"), **common))
    assert torch_res.num_reads == jax_res.num_reads > 0
    assert torch_res.num_rows == jax_res.num_rows
    assert _rel(torch_res) == _rel(jax_res)
    # both runs write reads in the order of their read ids: the fast5
    # names (synthread_NNNN) on one side, their pod5 uuids on the other.
    # Put the JAX run's per-read row blocks into uuid order, then the
    # arrays and the .ind row offsets must be equal.
    for a, b in zip(jax_res.feature_files, torch_res.feature_files):
        with open(_stem(a) + ".xy.ind") as fh:
            entries = [line.split() for line in fh]
        za, zb = np.load(a), np.load(b)
        n = len(za["xy"])
        starts = [int(row) for row, _ in entries] + [n]
        blocks = sorted(
            (id_map[os.path.basename(path)[: -len(".fast5")]], lo, hi)
            for (_, path), lo, hi in zip(entries, starts, starts[1:]))
        order = np.concatenate([np.arange(lo, hi) for _, lo, hi in blocks])
        for key in ("xy", "pos"):
            np.testing.assert_array_equal(zb[key], za[key][order])
        offsets = np.cumsum([0] + [hi - lo for _, lo, hi in blocks[:-1]])
        assert _ind_rows(b) == offsets.tolist()


def _cli(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "deepmod_tpu_torch", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_cli_getfeatures_train_predfeatures_on_cpu(datasets, motif_runs, tmp_path):
    base, mod_dir, _ = datasets
    feats = str(tmp_path / "feats")
    out = _cli("getfeatures", "--wrkBase", os.path.join(mod_dir, "fast5"),
               "--Ref", os.path.join(mod_dir, "ref.fa"), "--outFolder", feats,
               "--posneg", "1", "--alignStr", "builtin", "--save_format", "npz")
    want = motif_runs["mod"][0]
    assert f"getfeatures done: {want.num_reads} reads, {want.num_rows} rows" in out

    train_out = str(tmp_path / "train")
    out = _cli("train", "--wrkBase", feats, "--outFolder", train_out,
               "--hidden", "16", "--batchsize", "512", "--epochs", "1",
               "--device", "cpu")
    assert "Training Finished!" in out
    ckpt = os.path.join(train_out, "1", "mod.npz")
    data = np.load(ckpt)
    assert int(data["adam/count"]) > 0

    pred_out = str(tmp_path / "pred")
    out = _cli("predfeatures", "--wrkBase", feats, "--modfile", ckpt,
               "--outFolder", pred_out, "--device", "cpu")
    assert "total: tp=" in out
    with open(os.path.join(pred_out, "mod_mpred.txt")) as fh:
        assert fh.readline().startswith("tp=")
