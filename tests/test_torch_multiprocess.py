"""Real multi-process ``torch.distributed`` runs of the port on the CPU.

Spawns ranks of ``deepmod_tpu_torch.testing.multihost_worker`` (fresh
interpreters, ``OMP_NUM_THREADS=1``, two CPU shards a rank) that form a
``gloo`` group over a localhost TCP store, as tests/test_multihost.py
spawns the JAX package's worker over ``jax.distributed``:

- the primitives: the position-count reduction over shards and ranks
  equal to the numpy sum over every rank's rows, and one data-parallel
  train step giving the same loss and params on every rank;
- detect over 2, 3 and 4 ranks (files striped by rank, device aggregation
  over each rank's shards, the end-of-run count merge in chunks of 64
  rows): rank 0's BEDs byte-equal to the port's single-process run and to
  the JAX single-process run; the merged index files hold the
  single-process run's header lines and (chr, strand, pos, file) rows
  (the other columns name each rank's own predetail file, so they differ
  by topology, as in the JAX test); and ``--predDet 0`` over the
  multi-process tree rebuilds the same BEDs;
- a starved rank (3 ranks over 2 files): no deadlock, the same BEDs;
- ``train_run`` over a 2-shard mesh against JAX ``train_run`` over its
  2-device mesh, and under a group of 2 ranks against that mesh run
  (rank 0 alone writes the checkpoints);
- ``--hostShard`` under an initialized group: every rank raises, and the
  launcher reports the failed ranks.
"""

import glob
import os
import shutil

import jax
import numpy as np
import pytest

from deepmod_tpu.engine.detect import DetectConfig as JaxDetectConfig
from deepmod_tpu.engine.detect import detect_run as jax_detect_run
from deepmod_tpu.parallel import mesh as jmesh
from deepmod_tpu.testing.multihost_worker import _RulePredictor as JaxRule
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu.train import trainer as jtrain
from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run
from deepmod_tpu_torch.engine.getfeatures import (
    GetFeaturesConfig,
    getfeatures_run,
)
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.models.tf_import import params_to_numpy
from deepmod_tpu_torch.parallel.mesh import make_mesh
from deepmod_tpu_torch.testing.multihost_worker import _RulePredictor
from deepmod_tpu_torch.testing.multihost_worker import run_ranks
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.train import trainer as ttrain
from deepmod_tpu_torch.train.loader import find_feature_files

CPU = ("--device", "cpu")


def _config(cls, data_dir, out, **kw):
    return cls(
        wrk_base=os.path.join(data_dir, "fast5"),
        ref=os.path.join(data_dir, "ref.fa"), model_path="unused",
        out_folder=out, file_id="mod", base="C", align_str="builtin",
        threads=1, **kw,
    )


def _solo_runs(root, data_dir):
    """The port's and the JAX package's single-process runs with the rule
    predictor and device aggregation (the port over 8 CPU shards, JAX over
    its 8 virtual devices), each moved from <root>/run to its own name."""
    res = {}
    for name, fn, cfg, pred in (
            ("jax", jax_detect_run,
             _config(JaxDetectConfig, data_dir, os.path.join(root, "run"),
                     use_pallas=False, device_aggregation=True),
             JaxRule()),
            ("solo", detect_run,
             _config(DetectConfig, data_dir, os.path.join(root, "run"),
                     device="cpu", device_aggregation=True),
             _RulePredictor(make_mesh(devices=["cpu"] * 8)))):
        res[name] = fn(cfg, predictor=pred)
        _move_run(root, name)
    assert res["solo"].num_reads == res["jax"].num_reads
    return res


def _move_run(root, name):
    shutil.move(os.path.join(root, "run"), os.path.join(root, name))
    os.rename(os.path.join(root, "run.done"),
              os.path.join(root, name + ".done"))


def _beds(folder):
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "mod_pos.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def _index(folder):
    """{file name: (header lines, sorted (chr, strand, pos, fast5) rows)}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "mod",
                                              "rnn.pred.ind.*"))):
        with open(path) as fh:
            lines = fh.readlines()
        head = [line for line in lines if line.startswith("#")]
        rows = sorted(tuple(line.split()[:3] + line.split()[4:5])
                      for line in lines if not line.startswith("#"))
        out[os.path.basename(path)] = (head, rows)
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_multiproc"))
    data_dir = os.path.join(root, "data")
    generate_dataset(data_dir, SynthConfig(
        num_reads=8, seed=63, fast5_style="v2",
        genome_sizes={"chrA": 20000, "chrB": 12000},
        read_length=(600, 1200),
    ))
    res = _solo_runs(root, data_dir)
    assert res["solo"].num_reads >= 6
    assert _beds(os.path.join(root, "solo")) == _beds(os.path.join(root, "jax"))
    return root, data_dir, res


def test_two_process_primitives(tmp_path):
    results = run_ranks(2, str(tmp_path), CPU)
    for r in results:
        assert "backend gloo" in r["log"]
        assert r["devices"] == 4          # 2 processes x 2 local shards
        assert r["local_devices"] == 2
        assert r["counts_ok"], "count reduction != numpy all-process sum"
    # replicated outputs must agree exactly across processes
    assert results[0]["loss"] == results[1]["loss"]
    assert results[0]["checksum"] == results[1]["checksum"]


@pytest.mark.parametrize("nproc", [2, 3, 4])
def test_multi_process_detect_merged_bed(dataset, tmp_path, nproc):
    root, data_dir, res = dataset
    name = f"multi{nproc}"
    results = run_ranks(
        nproc, str(tmp_path),
        ("detect", data_dir, os.path.join(root, "run"), *CPU),
        # tiny gather chunk: the cross-process COO merge must survive
        # multi-chunk gathers (the human-scale path)
        env=dict(os.environ, DMT_MERGE_CHUNK_ROWS="64"),
    )
    _move_run(root, name)
    assert sum(r["num_reads"] for r in results) == res["solo"].num_reads
    # every process saw work (files stripe rank::nproc)
    assert all(r["num_reads"] > 0 for r in results)
    assert all(r["devices"] == 2 * nproc for r in results)
    assert results[0]["beds"], "rank 0 wrote no BEDs"
    assert all(r["beds"] == [] for r in results[1:]), "only rank 0 writes"
    assert all(r["stage_seconds"]["cross_process_merge"] > 0
               for r in results)
    assert all(r["stage_seconds"]["device_aggregation"] > 0
               for r in results)

    beds = _beds(os.path.join(root, name))
    assert beds and beds == _beds(os.path.join(root, "solo")) \
        == _beds(os.path.join(root, "jax"))
    index = _index(os.path.join(root, name))
    assert index and index == _index(os.path.join(root, "solo")) \
        == _index(os.path.join(root, "jax"))
    assert not glob.glob(os.path.join(root, name, "mod", "p*",
                                      "rnn.pred.ind.*"))

    # the --predDet 0 rebuild over the MULTI-process tree: merged index
    # entries point into p<rank>/ subtrees
    rebuilt = os.path.join(root, f"rebuild{nproc}")
    detect_run(DetectConfig(
        wrk_base=os.path.join(data_dir, "fast5"),
        ref=os.path.join(data_dir, "ref.fa"), model_path="unused",
        out_folder=rebuilt, file_id="mod", base="C", pred_det=False,
        pred_path=os.path.join(root, name, "mod"), device="cpu",
    ))
    assert _beds(rebuilt) == beds


def test_starved_process_still_merges(tmp_path):
    """More ranks than files: the starved rank holds no counts but runs
    the same end-of-run collective sequence (deterministic key grid): no
    deadlock, and rank 0's BEDs byte-equal the single-process runs'."""
    root = str(tmp_path)
    data_dir = os.path.join(root, "data")
    generate_dataset(data_dir, SynthConfig(
        num_reads=2, seed=71, fast5_style="v2",
        genome_sizes={"chrA": 9000}, read_length=(600, 900),
    ))
    assert len(glob.glob(os.path.join(data_dir, "fast5", "**", "*.fast5"),
                         recursive=True)) == 2
    res = _solo_runs(root, data_dir)
    assert res["solo"].num_reads >= 1
    out = os.path.join(root, "multi")
    results = run_ranks(3, root, ("detect", data_dir, out, *CPU))
    assert sum(r["num_reads"] for r in results) == res["solo"].num_reads
    assert min(r["num_reads"] for r in results) == 0  # someone starved
    beds = _beds(out)
    assert beds and beds == _beds(os.path.join(root, "solo")) \
        == _beds(os.path.join(root, "jax"))


TRAIN = dict(fnum=7, hidden=16, epochs=1, batch_size=512,
             learning_rate=3e-3, log_every=100, seed=3)


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Port-extracted features of tests/test_torch_train.py's datasets."""
    base = str(tmp_path_factory.mktemp("torch_multiproc_train"))
    common = dict(genome_sizes={"chrS": 15000}, num_reads=6,
                  read_length=(700, 1100), sub_rate=0.002, ins_rate=0.001,
                  del_rate=0.001)
    out = {}
    for name, posneg, shift in (("mod", 1, dict(mod_motif="CG", mod_offset=0,
                                                mod_level_shift=1.5)),
                                ("ctl", 0, {})):
        d = os.path.join(base, name)
        generate_dataset(d, SynthConfig(seed=100, **shift, **common))
        res = getfeatures_run(GetFeaturesConfig(
            wrk_base=os.path.join(d, "fast5"), ref=os.path.join(d, "ref.fa"),
            out_folder=os.path.join(base, f"feat_{name}"), posneg=posneg,
            motif="CG", align_str="builtin", save_format="npz"))
        out[name] = res.out_folder
    return base, out


def _flat(tree):
    return np.concatenate([np.asarray(t, np.float32).ravel()
                           for t in ttrain.param_leaves(params_to_numpy(tree))])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_train_run_on_a_mesh_matches_jax(features, tmp_path):
    """train_run over a 2-shard CPU mesh against JAX train_run over its
    2-device mesh and against the port's one-device run, from the same
    weights: params within relative L2 1e-4 after an epoch
    (tests/test_torch_train.py's bound)."""
    _, dirs = features
    groups = [find_feature_files(dirs["mod"]), find_feature_files(dirs["ctl"])]
    tree = params_to_numpy(tb.init_bilstm_params(
        3, tb.BiLSTMConfig(num_input=7, num_hidden=16), device="cpu"))
    mesh_run, _, _ = ttrain.train_run(
        groups, ttrain.TrainConfig(out_folder=str(tmp_path / "mesh"),
                                   device="cpu", **TRAIN),
        init_params=tree, mesh=make_mesh(devices=["cpu"] * 2))
    solo, _, _ = ttrain.train_run(
        groups, ttrain.TrainConfig(out_folder=str(tmp_path / "solo"),
                                   device="cpu", **TRAIN), init_params=tree)
    jax_run, _, _ = jtrain.train_run(
        groups, jtrain.TrainConfig(out_folder=str(tmp_path / "jax"), **TRAIN),
        mesh=jmesh.make_mesh(2), init_params=tree)
    got = _flat(mesh_run)
    assert _rel_l2(got, _flat(jax.tree_util.tree_map(np.asarray, jax_run))) \
        <= 1e-4
    assert _rel_l2(got, _flat(solo)) <= 1e-4
    assert _rel_l2(got, _flat(tree)) > 1e-3  # it trained


@pytest.mark.parametrize("nproc", [2, 4])
def test_train_run_over_two_ranks(features, tmp_path, nproc):
    """train_run under a gloo group of 2 (and 4) ranks: every rank ends
    with the same params, rank 0 alone writes the checkpoint, and it holds
    the params of one process training over a mesh of as many shards
    (relative L2 1e-4)."""
    _, dirs = features
    out = str(tmp_path / "ranks")
    results = run_ranks(nproc, str(tmp_path / "json"),
                        ("train", dirs["mod"], dirs["ctl"], out, *CPU))
    assert len({r["checksum"] for r in results}) == 1, results
    assert all(r["train_s"] > 0 for r in results)
    ckpt = os.path.join(out, "1", "mod.npz")
    ranks_params, _ = tt.load_bilstm_npz(ckpt)
    groups = [find_feature_files(dirs["mod"]), find_feature_files(dirs["ctl"])]
    mesh_run, _, _ = ttrain.train_run(
        groups, ttrain.TrainConfig(out_folder=str(tmp_path / "mesh"),
                                   device="cpu", **TRAIN),
        mesh=make_mesh(devices=["cpu"] * nproc))
    assert _rel_l2(_flat(ranks_params), _flat(mesh_run)) <= 1e-4


def test_host_shard_under_group_raises(dataset, tmp_path):
    _, data_dir, _ = dataset
    with pytest.raises(RuntimeError) as err:
        run_ranks(2, str(tmp_path), ("detect", data_dir,
                                     str(tmp_path / "out"), *CPU,
                                     "--host_shard", "0:2"))
    msg = str(err.value)
    assert "ranks [0, 1] of 2 failed" in msg
    assert "drop --hostShard" in msg
