"""The port's tensor parallelism (a 'model' mesh axis) on the CPU against
the JAX package's, whose side runs tests/conftest.py's 8 virtual CPU
devices; the port's side names the CPU once a device.

- ``make_2d_mesh``: shapes and axis names as JAX's, the too-many-devices
  error text, the model axis kept inside a process;
- ``bilstm_param_spec``: leaf by leaf JAX's ``PartitionSpec`` tuples;
- ``make_sharded_predict(model_axis="model")`` on (2, 4) and (4, 2)
  meshes against JAX's on the same meshes: predictions equal, logits
  within 2e-5; without a model axis, K1's plain version per data shard:
  the bits of one device's logits;
- one ``make_sharded_train_step(model_axis="model")`` step against JAX's
  ``dp_tp`` step (tests/test_parallel.py): loss within rel 1e-5, Adam's
  first moment (0.1 x the gradient) within rtol 1e-3 + 1e-5 of its leaf's
  largest, and every parameter within atol 2e-6 where |g| >= 1e-7. Adam's
  first step moves a parameter by lr * g / (|g| + 1e-8): for |g| near
  1e-8 it turns float32 noise of the gradient into up to ~1e-5 of the
  parameter (the JAX package's own data-parallel and dp_tp steps differ
  by 2.1e-6 on these inputs), while from |g| = 1e-7 up a relative
  gradient error d moves it by at most lr * d / 10. Parameters with
  smaller gradients are held within lr of JAX's (each step moves one by
  less than lr);
- 2 gloo ranks, the data axis over the ranks and model 2 inside each,
  equal to the one-process step; a model axis across the ranks raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.parallel import mesh as jmesh
from deepmod_tpu.parallel import shardings as jsh
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.parallel import (
    bilstm_param_spec,
    make_2d_mesh,
    make_mesh,
    make_sharded_predict,
    make_sharded_train_step,
)
from deepmod_tpu_torch.parallel.tensor_parallel import shard_params
from deepmod_tpu_torch.testing.multihost_worker import run_ranks, tp_step_inputs
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.train.trainer import adam_init, param_leaves

CFG = tb.BiLSTMConfig(num_input=7, num_hidden=100, timesteps=21)
JCFG = jb.BiLSTMConfig(num_input=7, num_hidden=100, timesteps=21)


def cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def model():
    params = tt.params_to_numpy(tb.init_bilstm_params(0, CFG, device="cpu"))
    x = np.random.default_rng(1).standard_normal((64, 21, 7)).astype(
        np.float32)
    return params, x


@pytest.mark.parametrize("data,model_size", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_make_2d_mesh_shapes(data, model_size):
    want = jmesh.make_2d_mesh(data, model_size)
    got = make_2d_mesh(data, model_size, devices=cpus(8))
    assert got.shape == want.devices.shape
    assert got.axis_names == want.axis_names
    assert got.size == want.devices.size and got.model == model_size
    groups = got.data_groups()
    assert len(groups) == data and all(len(g) == model_size for g in groups)
    named = make_2d_mesh(data, model_size, ("d", "m"), devices=cpus(8))
    assert named.axis_names == jmesh.make_2d_mesh(
        data, model_size, ("d", "m")).axis_names


def test_make_2d_mesh_errors():
    with pytest.raises(ValueError) as want:
        jmesh.make_2d_mesh(4, 4)
    with pytest.raises(ValueError) as got:
        make_2d_mesh(4, 4, devices=cpus(8))
    assert str(got.value) == str(want.value)
    # a 1-D mesh keeps its one axis and model size 1
    one = make_mesh(devices=cpus(4))
    assert one.shape == (4,) and one.model == 1
    assert one.data_groups() == [(torch.device("cpu"),)] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_2d_mesh(1, 1)


@pytest.mark.parametrize("model_axis", ["model", None])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_param_spec_matches_jax(model_axis, num_layers):
    want = jsh.bilstm_param_spec(model_axis, num_layers)
    got = bilstm_param_spec(model_axis, num_layers)
    is_spec = lambda a: isinstance(a, jax.sharding.PartitionSpec)  # noqa: E731
    w_paths = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_spec)[0]
    g_paths = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda a: isinstance(a, tuple))[0]
    assert [p for p, _ in w_paths] == [p for p, _ in g_paths]
    for (path, w), (_, g) in zip(w_paths, g_paths):
        assert tuple(w) == g, path


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_tensor_parallel_predict_matches_jax(model, shape):
    params, x = model
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jfn = jsh.make_sharded_predict(JCFG, jmesh.make_2d_mesh(*shape),
                                   model_axis="model")
    want = np.asarray(jfn(jp, x))
    want_logits = np.asarray(jb.bilstm_logits(jp, jnp.asarray(x), JCFG))
    fn = make_sharded_predict(CFG, make_2d_mesh(*shape, devices=cpus(8)),
                              model_axis="model", precision="bf16")
    assert fn.model_axis == "model"
    tparams = tt.params_from_numpy(params, "cpu")
    np.testing.assert_array_equal(fn(tparams, x).numpy(), want)
    np.testing.assert_allclose(fn.logits(tparams, x).numpy(), want_logits,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_data_parallel_predict_same_bits_as_one_device(model, precision):
    """Without a model axis (also on a 2-D mesh, where the batch splits
    over 'data' only), K1's plain version per data shard: one device's
    logits, and in fp32 JAX's sharded predict's predictions."""
    params, x = model
    tparams = tt.params_from_numpy(params, "cpu")
    want = tb.bilstm_logits(tparams, torch.from_numpy(x), CFG, precision)
    for mesh in (make_mesh(devices=cpus(8)),
                 make_2d_mesh(4, 2, devices=cpus(8))):
        fn = make_sharded_predict(CFG, mesh, precision=precision)
        assert fn.model_axis is None
        assert torch.equal(fn.logits(tparams, x), want)
    if precision == "fp32":
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jfn = jsh.make_sharded_predict(JCFG, jmesh.make_mesh(8))
        np.testing.assert_array_equal(fn(tparams, x).numpy(),
                                      np.asarray(jfn(jp, x)))
    with pytest.raises(ValueError, match="shard"):
        fn(tparams, x[:63])


def _jax_tp_step(params, x, y, mask, unbalanced):
    opt = optax.adam(1e-3)
    step = jsh.make_sharded_train_step(JCFG, opt, jmesh.make_2d_mesh(2, 4),
                                       model_axis="model",
                                       unbalanced=unbalanced)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    p, state, loss = step(p, opt.init(p), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(mask))
    return p, state[0].mu, float(loss)


def _leaves(tree):
    return [np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
            for t in param_leaves(tree)]


@pytest.mark.parametrize("unbalanced", [False, True])
def test_tensor_parallel_train_step_matches_jax(model, unbalanced):
    params, x = model
    y = np.zeros((64, 2), np.float32)
    y[::2, 0] = 1
    y[1::2, 1] = 1
    mask = np.ones(64, np.float32)
    mask[-7:] = 0.0
    want_p, want_mu, want_loss = _jax_tp_step(params, x, y, mask, unbalanced)
    tparams = tt.params_from_numpy(params, "cpu")
    state = adam_init(tparams)
    step = make_sharded_train_step(CFG, 1e-3,
                                   make_2d_mesh(2, 4, devices=cpus(8)),
                                   unbalanced=unbalanced, model_axis="model")
    loss = step(tparams, state, x, y, mask)
    assert state["count"] == 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for got, want in zip(_leaves(state["mu"]), _leaves(want_mu)):
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max())
    for got, want, init, mu in zip(_leaves(tparams), _leaves(want_p),
                                   _leaves(params), _leaves(want_mu)):
        steady = np.abs(mu) >= 0.1 * 1e-7  # |g| >= 1e-7
        assert steady.mean() > 0.9
        np.testing.assert_allclose(got[steady], want[steady], rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        assert not np.array_equal(got, init)  # every leaf moved


def test_tensor_parallel_step_matches_the_data_parallel_step(model):
    """The TP step (plain torch) and the 1-D step (K2/K3's plain versions)
    compute one function: two steps give the same losses and params; the
    caller's tensors are updated in place, in their layout."""
    params, x = model
    y = np.eye(2, dtype=np.float32)[(x[:, 10, 4] > 0).astype(np.int64)]
    mask = np.ones(64, np.float32)
    runs = {}
    for name, mesh, axis in (
            ("dp", make_mesh(devices=cpus(4)), None),
            ("tp", make_2d_mesh(2, 2, devices=cpus(4)), "model")):
        tparams = tt.params_from_numpy(params, "cpu")
        ids = [id(t) for t in param_leaves(tparams)]
        state = adam_init(tparams)
        step = make_sharded_train_step(CFG, 1e-3, mesh, model_axis=axis)
        losses = [float(step(tparams, state, x, y, mask)) for _ in range(2)]
        assert [id(t) for t in param_leaves(tparams)] == ids
        runs[name] = (losses, _leaves(tparams))
    np.testing.assert_allclose(runs["tp"][0], runs["dp"][0], rtol=1e-5)
    for got, want in zip(runs["tp"][1], runs["dp"][1]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_model_axis_rules():
    """A model axis the mesh does not name is no model axis (JAX's rule);
    a width the model axis cannot split raises; a non-mesh is refused."""
    mesh = make_2d_mesh(2, 4, devices=cpus(8))
    assert make_sharded_predict(CFG, mesh, model_axis="other").model_axis \
        is None
    assert make_sharded_predict(CFG, make_mesh(devices=cpus(2)),
                                model_axis="model").model_axis is None
    odd = tb.BiLSTMConfig(num_input=7, num_hidden=6, timesteps=5)
    params = tb.init_bilstm_params(0, odd, device="cpu")
    with pytest.raises(ValueError, match="split over 8 model shards"):
        shard_params(params, [torch.device("cpu")] * 8)
    with pytest.raises(TypeError, match="Mesh"):
        make_sharded_train_step(CFG, 1e-3, mesh=None, model_axis="model")


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    return run_ranks(2, str(tmp_path_factory.mktemp("tp_ranks")),
                     ("tp", "--device", "cpu"))


def test_two_ranks_tensor_parallel_step_matches_one_process(tp_ranks):
    config, tree, x, y, mask = tp_step_inputs(2)
    params = tt.params_from_numpy(tree, "cpu")
    state = adam_init(params)
    step = make_sharded_train_step(config, 1e-3,
                                   make_2d_mesh(2, 2, devices=cpus(4)),
                                   model_axis="model")
    loss = float(step(params, state, x, y, mask))
    flat = np.concatenate([t.numpy().ravel() for t in param_leaves(params)])
    for rank in tp_ranks:
        assert "backend gloo" in rank["log"]
        assert rank["mesh_shape"] == [1, 2]
        np.testing.assert_allclose(rank["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(rank["params"], np.float32),
                                   flat, rtol=0, atol=1e-7)


def test_model_axis_across_processes_raises(tp_ranks):
    for rank in tp_ranks:
        assert "the model axis stays inside a process" in rank["refused"]
        assert "over 2 processes" in rank["refused"]
