"""The port's .npz checkpoints: round trip, interchange with the JAX
package in both directions, and the weight carry-over (params_from_numpy)
giving the same logits as JAX (fp32, 2e-5 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.models import tf_import as jt
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


def _assert_same_tree(a, b):
    def arr(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        return np.asarray(v)

    for lane in ("fw", "bw"):
        assert len(a[lane]) == len(b[lane])
        for la, lb in zip(a[lane], b[lane]):
            for key in ("kernel", "bias"):
                np.testing.assert_array_equal(arr(la[key]), arr(lb[key]))
    for key in ("out_w", "out_b"):
        np.testing.assert_array_equal(arr(a[key]), arr(b[key]))


@pytest.mark.parametrize("output_layer", ["", "sigmoid"])
def test_npz_round_trip(tmp_path, output_layer):
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=16, timesteps=9,
                          num_layers=2, output_layer=output_layer)
    params = tb.init_bilstm_params(3, cfg, device="cpu")
    path = str(tmp_path / "m.npz")
    tt.save_bilstm_npz(path, params, cfg)
    meta = np.load(path)["meta/output_layer"]
    assert meta.shape == () and meta.item().decode() == output_layer
    loaded, cfg2 = tt.load_bilstm_npz(path)
    assert cfg2 == cfg
    _assert_same_tree(loaded, params)


def test_npz_interchange_with_jax_package(tmp_path):
    jcfg = jb.BiLSTMConfig(num_input=7, num_hidden=16, num_layers=3,
                           output_layer="sigmoid")
    jparams = jb.init_bilstm_params(jax.random.PRNGKey(4), jcfg)
    a = str(tmp_path / "from_jax.npz")
    jt.save_bilstm_npz(a, jparams, jcfg)
    got, cfg = tt.load_model(a)
    assert cfg.output_layer == "sigmoid" and cfg.num_hidden == 16
    _assert_same_tree(got, jparams)

    tcfg = tb.BiLSTMConfig(num_input=7, num_hidden=16, num_layers=3)
    tparams = tb.init_bilstm_params(5, tcfg, device="cpu")
    b = str(tmp_path / "from_torch.npz")
    tt.save_bilstm_npz(b, tparams, tcfg)
    back, jcfg2 = jt.load_model(b)
    assert jcfg2.num_layers == 3 and jcfg2.output_layer == ""
    _assert_same_tree(back, tparams)


def test_params_from_numpy_gives_jax_logits():
    jcfg = jb.BiLSTMConfig(num_input=7)
    tcfg = tb.BiLSTMConfig(num_input=7)
    jparams = jb.init_bilstm_params(jax.random.PRNGKey(6), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = tt.params_from_numpy(tree, "cpu")
    assert params["fw"][0]["kernel"].dtype == torch.float32
    x = np.random.default_rng(6).standard_normal((11, 21, 7)).astype(
        np.float32)
    got = tb.bilstm_logits(params, torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jb.bilstm_logits(jparams, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_tf_checkpoint_raises_naming_roadmap():
    """A path that is not an .npz is read as a TF checkpoint (the TF
    import is ported): where there is none, the reader's error names the
    missing .index."""
    with pytest.raises(FileNotFoundError, match=r"mod_train\.index"):
        tt.load_model("/nonexistent/rnn_f7_wd21_chr1to10_4/mod_train")
