"""The port's trainer against the JAX package's, on the CPU.

- Adam: the same gradients through optax.adam and the port's update for
  3 steps: params within 1e-6, equal step counts.
- The train step (H=32, one 256-row bucket, 3 steps) against JAX
  make_train_step(use_pallas=False): losses rtol 1e-4; params within
  relative L2 1e-4 of the whole tree (an elementwise bound would be
  flaky: Adam turns a near-zero gradient element into a step of up to lr
  whichever sign rounding gives it).
- .npz checkpoints with Adam slots in both directions; a resume from the
  epoch checkpoint equal bitwise to an uninterrupted run; the numpy AUC
  equal to sklearn's; training over port-extracted features learns (AUC
  > 0.8); predict_feature_files gives the JAX package's tp/fp/fn/tn.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.models import tf_import as jt
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu.train import trainer as jtrain
from deepmod_tpu_torch.engine.getfeatures import GetFeaturesConfig, getfeatures_run
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.train import trainer as ttrain
from deepmod_tpu_torch.train.loader import find_feature_files, load_feature_file
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree):
    """Every leaf of a params tree (numpy, JAX or torch) as one fp32 vector,
    in the port's leaf order."""
    return np.concatenate([
        np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                   np.float32).ravel()
        for t in ttrain.param_leaves(tree)])


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jb.BiLSTMConfig(num_input=7, num_hidden=32)
    return cfg, _np_tree(jb.init_bilstm_params(jax.random.PRNGKey(2), cfg))


def test_adam_matches_optax(jax_params):
    _, tree = jax_params
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2, tree)
        for _ in range(3)]
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp, state = tree, opt.init(tree)
    params = tt.params_from_numpy(tree, "cpu")
    tstate = ttrain.adam_init(params)
    for g in grads:
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        ttrain.adam_update(params, [torch.from_numpy(a) for a in
                                    [*map(np.asarray, ttrain.param_leaves(g))]],
                           tstate, 1e-3)
    assert tstate["count"] == int(state[0].count) == 3
    np.testing.assert_allclose(_flat(params), _flat(_np_tree(jp)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_flat(tstate["nu"]), _flat(_np_tree(state[0].nu)),
                               rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("unbalanced", [False, True])
def test_train_step_matches_jax(jax_params, unbalanced):
    jcfg, tree = jax_params
    tcfg = tb.BiLSTMConfig(num_input=7, num_hidden=32)
    rng = np.random.default_rng(1 + unbalanced)
    n = 200  # padded to one 256-row bucket
    x = rng.standard_normal((n, 21, 7)).astype(np.float32)
    labels = (x[:, 10, 4] > 0).astype(np.int64)
    y = np.eye(2, dtype=np.float32)[labels]
    xp, yp, mask = ttrain._pad_to(x, y, 1)
    assert len(mask) == 256 and mask.sum() == n

    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstep = jtrain.make_train_step(jcfg, opt, unbalanced, use_pallas=False)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, tree), None
    jstate = opt.init(jp)
    params = tt.params_from_numpy(tree, "cpu")
    tstate = ttrain.adam_init(params)
    tstep = ttrain.make_train_step(tcfg, unbalanced)
    args = [torch.from_numpy(a) for a in (xp, yp, mask)]
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(xp), jnp.asarray(yp),
                                  jnp.asarray(mask))
        tloss = tstep(params, tstate, *args)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstate["count"] == int(jstate[0].count) == 3
    assert _rel_l2(_flat(params), _flat(_np_tree(jp))) <= 1e-4


@pytest.mark.parametrize("unbalanced", [False, True])
def test_loss_and_param_count_match_jax(jax_params, unbalanced):
    jcfg, tree = jax_params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 21, 7)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    want = jb.bilstm_loss(tree, jnp.asarray(x), jnp.asarray(y), jcfg, unbalanced)
    params = tt.params_from_numpy(tree, "cpu")
    got = tb.bilstm_loss(params, torch.from_numpy(x), torch.from_numpy(y),
                         tb.BiLSTMConfig(num_input=7, num_hidden=32), unbalanced)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert tb.count_params(params) == jb.count_params(tree)


def test_train_step_mesh_raises():
    """A mesh takes the data-parallel step (tests/test_torch_parallel.py)
    or, with a model axis, the tensor-parallel one
    (tests/test_torch_tensor_parallel.py); what is not a
    ``parallel.mesh.Mesh`` is refused."""
    from deepmod_tpu_torch.parallel.mesh import make_2d_mesh
    from deepmod_tpu_torch.parallel.shardings import (
        TensorParallelTrainStep,
        make_sharded_train_step,
    )

    with pytest.raises(TypeError, match="Mesh"):
        ttrain.make_train_step(tb.BiLSTMConfig(), False, mesh=object())
    step = make_sharded_train_step(
        tb.BiLSTMConfig(), 1e-3, make_2d_mesh(2, 4, devices=["cpu"] * 8),
        model_axis="model")
    assert isinstance(step, TensorParallelTrainStep)
    with pytest.raises(TypeError, match="Mesh"):
        make_sharded_train_step(tb.BiLSTMConfig(), 1e-3, mesh=None,
                                model_axis="model")


def test_adam_slots_interchange_with_jax(jax_params, tmp_path):
    jcfg, tree = jax_params
    rng = np.random.default_rng(3)
    opt = optax.adam(1e-3)
    state = opt.init(tree)
    mu = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    nu = jax.tree_util.tree_map(
        lambda a: rng.random(a.shape).astype(np.float32), tree)
    state = (state[0]._replace(count=jnp.asarray(7, jnp.int32), mu=mu, nu=nu),
             ) + tuple(state[1:])
    a = str(tmp_path / "from_jax.npz")
    jt.save_bilstm_npz(a, tree, jcfg, opt_state=state)
    params = tt.params_from_numpy(tree, "cpu")
    got = tt.load_adam_state(a, params)
    assert got["count"] == 7
    np.testing.assert_array_equal(_flat(got["mu"]), _flat(mu))
    np.testing.assert_array_equal(_flat(got["nu"]), _flat(nu))

    b = str(tmp_path / "from_torch.npz")
    tcfg = tb.BiLSTMConfig(num_input=7, num_hidden=32)
    tt.save_bilstm_npz(b, params, tcfg, opt_state=got)
    back = jt.load_adam_state(b, opt, tree)
    assert int(back[0].count) == 7
    np.testing.assert_array_equal(_flat(_np_tree(back[0].mu)), _flat(mu))
    np.testing.assert_array_equal(_flat(_np_tree(back[0].nu)), _flat(nu))

    legacy = str(tmp_path / "legacy.npz")
    tt.save_bilstm_npz(legacy, params, tcfg)
    assert tt.load_adam_state(legacy, params) is None


def test_auc_equals_sklearn():
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(4)
    for n in (10, 257, 2000):
        truth = rng.integers(0, 2, n)
        truth[:2] = (0, 1)
        scores = np.round(rng.random(n), 1)  # many ties
        assert ttrain.roc_auc(truth, scores) == pytest.approx(
            roc_auc_score(truth, scores), abs=1e-12)


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Port-extracted features of tests/test_train_e2e.py's datasets."""
    base = str(tmp_path_factory.mktemp("torch_train"))
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
        out[name] = find_feature_files(res.out_folder)
        assert out[name]
    return base, out


def test_resume_continues_adam_state_bitwise(features, tmp_path):
    _, files = features
    groups = [files["mod"], files["ctl"]]
    common = dict(fnum=7, hidden=16, batch_size=512, learning_rate=3e-3,
                  log_every=100, seed=3, device="cpu")
    full, _, _ = ttrain.train_run(groups, ttrain.TrainConfig(
        out_folder=str(tmp_path / "full"), epochs=2, **common))
    ttrain.train_run(groups, ttrain.TrainConfig(
        out_folder=str(tmp_path / "part"), epochs=1, **common))
    ckpt = str(tmp_path / "part" / "1" / "mod.npz")
    ck_params, _ = tt.load_bilstm_npz(ckpt)
    assert int(np.load(ckpt)["adam/count"]) > 0
    resumed, _, _ = ttrain.train_run(
        groups, ttrain.TrainConfig(out_folder=str(tmp_path / "resume"),
                                   epochs=1, **common),
        init_params=ck_params, resume_opt_from=ckpt)
    for a, b in zip(ttrain.param_leaves(full), ttrain.param_leaves(resumed)):
        assert torch.equal(a, b)


def test_training_learns_and_predicts_like_jax(features, tmp_path):
    _, files = features
    config = ttrain.TrainConfig(
        out_folder=str(tmp_path / "train_out"), fnum=7, hidden=32, epochs=3,
        batch_size=128, learning_rate=1e-2, log_every=10, seed=1,
        device="cpu")
    params, model_config, history = ttrain.train_run(
        [files["mod"], files["ctl"]], config)
    assert history, "no training steps ran"
    assert os.path.isfile(str(tmp_path / "train_out" / "3" / "mod.npz"))
    xs, ys = zip(*(load_feature_file(f, 21) for f in files["mod"] + files["ctl"]))
    m = ttrain.batch_metrics(params, model_config, np.concatenate(xs),
                             np.concatenate(ys))
    assert m["auc"] > 0.8, m

    tree = tt.params_to_numpy(params)
    jcfg = jb.BiLSTMConfig(num_input=7, num_hidden=32)
    want = jtrain.predict_feature_files(
        tree, jcfg, files["mod"] + files["ctl"], str(tmp_path / "jax.txt"),
        batch_size=256)
    got = ttrain.predict_feature_files(
        tree, model_config, files["mod"] + files["ctl"],
        str(tmp_path / "torch.txt"), batch_size=256, device="cpu")
    assert got == want and sum(sum(v) for v in got.values()) > 0
