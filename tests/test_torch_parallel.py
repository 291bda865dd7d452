"""The port's data-parallel layer (``deepmod_tpu_torch/parallel``) on the
CPU against the JAX package's, whose side runs the real 8-way mesh of
tests/conftest.py's 8 virtual CPU devices; the port's side runs 8 CPU
shards (``devices=["cpu"] * 8``).

- meshes: sizes, the error text for too many devices, a 2-D mesh's
  shape (tensor parallelism: tests/test_torch_tensor_parallel.py), no
  GPU -> the default mesh raises;
- ``sharded_position_counts``: exact against JAX's;
- the cross-process helpers ``_split_i64`` / ``_join_i64`` /
  ``_chunk_shape`` (as tests/test_parallel.py holds JAX's);
- the data-parallel ``WindowPredictor``: predictions of 8 shards the bits
  of one shard (fp32 and bf16, window and compact transfer), and equal
  to JAX's data-parallel predictor (fp32 scan; logits within 2e-5);
- the data-parallel train step on 8 shards against JAX
  ``make_train_step(mesh=...)``: losses rtol 1e-4, params within relative
  L2 1e-4 (tests/test_torch_train.py's bounds);
- ``detect_run(device_aggregation=True)`` over 8 shards: BEDs byte-equal
  to the host path's and to the JAX run of tests/test_detect_e2e.py's
  config with device aggregation, also with HostPool workers.
"""

import dataclasses
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmod_tpu.engine.detect import DetectConfig as JaxDetectConfig
from deepmod_tpu.engine.detect import WindowPredictor as JaxPredictor
from deepmod_tpu.engine.detect import detect_run as jax_detect_run
from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.models.tf_import import save_bilstm_npz
from deepmod_tpu.parallel import aggregation as jagg
from deepmod_tpu.parallel import cross_process as jcp
from deepmod_tpu.parallel import mesh as jmesh
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu.train import trainer as jtrain
from deepmod_tpu_torch.engine.detect import DetectConfig, WindowPredictor
from deepmod_tpu_torch.engine.detect import detect_run
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.models.tf_import import load_model, params_to_numpy
from deepmod_tpu_torch.parallel import cross_process as tcp
from deepmod_tpu_torch.parallel.aggregation import sharded_position_counts
from deepmod_tpu_torch.parallel.mesh import (
    make_2d_mesh,
    make_mesh,
    process_count,
    process_index,
)
from deepmod_tpu_torch.parallel.shardings import make_sharded_train_step
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.train import trainer as ttrain

CPU8 = ["cpu"] * 8


def _engine_features(rng, rows):
    """Engine-shaped feature rows: a 0/1 one-hot (or none) + 3 numbers."""
    feats = np.zeros((rows, 7), np.float32)
    hot = rng.integers(0, 5, rows)  # 4 = no base ('-'/'N'/pad rows)
    for b in range(4):
        feats[hot == b, b] = 1.0
    feats[:, 4] = (rng.standard_normal(rows) * 2).round(3)
    feats[:, 5] = np.abs(rng.standard_normal(rows) * 2).round(3)
    feats[:, 6] = rng.integers(1, 40, rows)
    return feats


def test_mesh_sizes_and_errors():
    assert jax.device_count() == 8
    mesh = make_mesh(devices=CPU8)
    assert mesh.size == mesh.local_size == jmesh.make_mesh().devices.size
    assert make_mesh(4, devices=CPU8).size == jmesh.make_mesh(4).devices.size
    assert mesh.group is None
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert (process_index(), process_count()) == (
        jax.process_index(), jax.process_count())
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(9)
    with pytest.raises(ValueError) as got:
        make_mesh(9, devices=CPU8)
    assert str(got.value) == str(want.value)
    two_d = make_2d_mesh(4, 2, devices=CPU8)
    assert two_d.shape == jmesh.make_2d_mesh(4, 2).devices.shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh(devices=["cuda"] * 2)


def test_sharded_position_counts_match_jax():
    rng = np.random.RandomState(11)
    length = 97
    pos = rng.randint(0, length, 64).astype(np.int64)
    cov = rng.randint(0, 3, 64).astype(np.int64)
    mod = (rng.rand(64) < 0.4).astype(np.int64)
    want = jagg.sharded_position_counts(jmesh.make_mesh(8), pos, cov, mod,
                                        length)
    got = sharded_position_counts(make_mesh(devices=CPU8), pos, cov, mod,
                                  length)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="pad"):
        sharded_position_counts(make_mesh(devices=CPU8), pos[:63], cov[:63],
                                mod[:63], length)


def test_cross_process_i64_split_roundtrip():
    vals = np.asarray(
        [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**40 + 12345, 2**62],
        np.int64,
    )
    hi, lo = tcp._split_i64(vals)
    assert hi.dtype == np.int32 and lo.dtype == np.int32
    want_hi, want_lo = jcp._split_i64(vals)
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    # the halves survive an int32 tensor round trip un-truncated
    hi_rt = torch.from_numpy(hi).numpy()
    lo_rt = torch.from_numpy(lo).numpy()
    np.testing.assert_array_equal(tcp._join_i64(hi_rt, lo_rt), vals)


def test_cross_process_chunk_shape_buckets():
    chunk = 1 << 22
    assert tcp._chunk_shape(1, chunk) == 1
    assert tcp._chunk_shape(3, chunk) == 4
    assert tcp._chunk_shape(chunk, chunk) == chunk
    # never exceeds the agreed chunk size (collective shape contract)
    assert tcp._chunk_shape(chunk - 1, chunk) == chunk
    for rows in (1, 2, 3, 7, 100, 4097, chunk - 1, chunk, chunk + 5):
        assert tcp._chunk_shape(rows, chunk) == jcp._chunk_shape(rows, chunk)
        assert tcp._chunk_shape(rows, chunk) >= min(rows, chunk)


def test_merge_without_group_returns_counts():
    counts = {("chrA", "+"): object()}
    assert tcp.merge_counts_across_processes(counts, {"chrA": 10}) is counts


PCFG = tb.BiLSTMConfig(num_input=7)   # the predictor's: full width
CFG = tb.BiLSTMConfig(num_input=7, num_hidden=32)  # the train step's


@pytest.fixture(scope="module")
def params():
    return params_to_numpy(tb.init_bilstm_params(5, PCFG, device="cpu"))


@pytest.fixture(scope="module")
def train_params():
    return params_to_numpy(tb.init_bilstm_params(5, CFG, device="cpu"))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("compact", [False, True])
def test_data_parallel_predictor_same_bits_as_one_shard(params, precision,
                                                         compact):
    rng = np.random.default_rng(31)
    feats = _engine_features(rng, 2600)
    kw = dict(buckets=(512, 2048), device="cpu", precision=precision,
              compact_transfer=compact)
    one = WindowPredictor(params, PCFG, **kw)
    eight = WindowPredictor(params, PCFG, devices=CPU8, **kw)
    assert one.n_shards == 1 and eight.n_shards == 8
    for centers in (np.arange(10, 2590, dtype=np.int64),
                    np.arange(10, 700, 3, dtype=np.int64),
                    np.asarray([10, 11, 500, 2000, 2001], np.int64)):
        want = one.predict_from_features(feats, centers)
        got = eight.predict_from_features(feats, centers)
        np.testing.assert_array_equal(got, want)
        mixed = 0 < int(want.sum()) < len(want) or len(want) < 10
        assert mixed


@pytest.mark.parametrize("compact", [False, True])
def test_data_parallel_predictor_matches_jax(params, compact):
    """JAX's data-parallel predictor on its 8-device mesh (scan path, fp32)
    and the port's on 8 CPU shards give the same predictions; the logits
    of the two packages agree within 2e-5."""
    rng = np.random.default_rng(21)
    feats = _engine_features(rng, 3000)
    centers = np.arange(100, 2900, dtype=np.int64)
    jcfg = jb.BiLSTMConfig(num_input=7)
    jp = JaxPredictor(params, jcfg, buckets=(512, 4096), use_pallas=False,
                      data_parallel=True, precision="fp32",
                      compact_transfer=compact)
    assert jp._data_parallel
    tp = WindowPredictor(params, PCFG, buckets=(512, 4096), device="cpu",
                         devices=CPU8, precision="fp32",
                         compact_transfer=compact)
    want = jp.predict_from_features(feats, centers, assume_packable=True)
    got = tp.predict_from_features(feats, centers)
    assert 0 < int(want.sum()) < len(want)
    np.testing.assert_array_equal(got, want)

    view = np.lib.stride_tricks.sliding_window_view(feats, 21, axis=0)
    win = np.ascontiguousarray(np.moveaxis(view[centers[:512] - 10], 2, 1))
    jl = np.asarray(jb.bilstm_logits(params, jnp.asarray(win), jcfg))
    tl = tb.bilstm_logits(tt.params_from_numpy(params, "cpu"),
                          torch.from_numpy(win), PCFG).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)


def _flat(tree):
    return np.concatenate([
        np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                   np.float32).ravel()
        for t in ttrain.param_leaves(tree)])


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("unbalanced", [False, True])
def test_data_parallel_train_step_matches_jax_mesh(train_params, unbalanced):
    params = train_params
    rng = np.random.default_rng(7 + unbalanced)
    n = 200  # padded to one 256-row bucket: 32 rows a shard
    x = rng.standard_normal((n, 21, 7)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 10, 4] > 0).astype(np.int64)]
    xp, yp, mask = ttrain._pad_to(x, y, 8)
    assert len(mask) == 256

    jcfg = jb.BiLSTMConfig(num_input=7, num_hidden=32)
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstep = jtrain.make_train_step(jcfg, opt, unbalanced,
                                   mesh=jmesh.make_mesh(8), use_pallas=False)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    mesh = make_mesh(devices=CPU8)
    tparams = tt.params_from_numpy(params, "cpu")
    tstate = ttrain.adam_init(tparams)
    tstep = ttrain.make_train_step(CFG, unbalanced, mesh=mesh)
    solo = tt.params_from_numpy(params, "cpu")
    solo_state = ttrain.adam_init(solo)
    solo_step = ttrain.make_train_step(CFG, unbalanced)
    args = [torch.from_numpy(a) for a in (xp, yp, mask)]
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(xp),
                                  jnp.asarray(yp), jnp.asarray(mask))
        tloss = tstep(tparams, tstate, *args)
        sloss = solo_step(solo, solo_state, *args)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(float(tloss), float(sloss), rtol=1e-4)
    assert tstate["count"] == int(jstate[0].count) == 3
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jp))
    assert _rel_l2(_flat(tparams), jflat) <= 1e-4
    assert _rel_l2(_flat(tparams), _flat(solo)) <= 1e-4
    # a model axis the 1-D mesh does not name is no model axis (JAX)
    assert isinstance(make_sharded_train_step(CFG, 1e-3, mesh,
                                              model_axis="model"),
                      type(tstep))
    with pytest.raises(ValueError, match="shard"):
        tstep(tparams, tstate, *(a[:250] for a in args))


# -- device aggregation in detect ------------------------------------------


def _run_into(root, name, fn, cfg, **kw):
    """Run detect into <root>/run, then move it to <root>/<name> (the
    index files name their output folder)."""
    res = fn(cfg, **kw)
    shutil.move(os.path.join(root, "run"), os.path.join(root, name))
    os.rename(os.path.join(root, "run.done"),
              os.path.join(root, name + ".done"))
    return res


def _beds(root, name):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, name, "mod_pos.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/test_detect_e2e.py's dataset and weights; the JAX run with
    device aggregation on its 8-device mesh and the port's host path."""
    root = str(tmp_path_factory.mktemp("torch_devagg"))
    generate_dataset(root, SynthConfig(
        genome_sizes={"chrS": 20000}, num_reads=6, read_length=(700, 1200),
        seed=9,
    ))
    model_config = jb.BiLSTMConfig(num_input=7)
    model = os.path.join(root, "model.npz")
    save_bilstm_npz(
        model, jb.init_bilstm_params(jax.random.PRNGKey(0), model_config),
        model_config,
    )
    common = dict(
        wrk_base=os.path.join(root, "fast5"), ref=os.path.join(root, "ref.fa"),
        model_path=model, out_folder=os.path.join(root, "run"),
        file_id="mod", base="C", align_str="builtin", files_per_batch=3,
    )
    cfg = DetectConfig(**common, device="cpu", precision="fp32")
    res = {
        "jax": _run_into(root, "jax", jax_detect_run, JaxDetectConfig(
            **common, device_aggregation=True)),
        "host": _run_into(root, "host", detect_run, cfg),
    }
    assert res["host"].num_reads == res["jax"].num_reads == 6
    return root, cfg, res


@pytest.mark.parametrize("threads", [1, 2])
def test_device_aggregation_matches_host_and_jax(e2e, threads):
    root, cfg, res = e2e
    params, mcfg = load_model(cfg.model_path)
    pred = WindowPredictor(params, mcfg, device="cpu", devices=CPU8,
                           precision="fp32")
    name = f"devagg{threads}"
    got = _run_into(root, name, detect_run, dataclasses.replace(
        cfg, device_aggregation=True, threads=threads), predictor=pred)
    assert got.num_reads == res["host"].num_reads
    assert got.stage_seconds.get("device_aggregation", 0) > 0
    beds = _beds(root, name)
    assert beds and beds == _beds(root, "host") == _beds(root, "jax")


def test_device_aggregation_with_one_shard_stays_on_host(e2e):
    root, cfg, res = e2e
    got = _run_into(root, "devagg_one", detect_run,
                    dataclasses.replace(cfg, device_aggregation=True))
    assert "device_aggregation" not in got.stage_seconds
    assert _beds(root, "devagg_one") == _beds(root, "host")
