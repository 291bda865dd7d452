"""The port's BiLSTM (plain version of the CUDA kernel) against the JAX
package: the scan path and the Pallas mono kernel in interpret mode.

Inputs and weights come from one numpy seed and go through both packages
as numpy arrays. Tolerances: fp32 2e-5 absolute (the two sides sum the
gate products in different orders); bf16 atol 2e-3 / rtol 2e-2, the
tolerance tests/test_bilstm.py holds between two bf16 schedules of the
JAX kernel (bf16 rounding of the stored sequences at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.bilstm_fused import bilstm_fused_center_mono
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as tf_ops
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


def _numpy_params(seed, cfg):
    """Same initializers as both packages, drawn with numpy; random
    biases so the bias path is exercised."""
    rng = np.random.default_rng(seed)
    h = cfg.num_hidden
    tree = {"fw": [], "bw": []}
    for lane in ("fw", "bw"):
        for layer in range(cfg.num_layers):
            in_dim = cfg.num_input if layer == 0 else h
            lim = np.sqrt(6.0 / (in_dim + 5 * h))
            tree[lane].append({
                "kernel": rng.uniform(-lim, lim, (in_dim + h, 4 * h))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(4 * h)).astype(np.float32),
            })
    tree["out_w"] = rng.standard_normal((2 * h, cfg.num_classes)).astype(
        np.float32)
    tree["out_b"] = rng.standard_normal(cfg.num_classes).astype(np.float32)
    return tree


def _cfgs(**kw):
    return jb.BiLSTMConfig(**kw), tb.BiLSTMConfig(**kw)


@pytest.fixture(scope="module")
def full_width():
    """H=100, 3 layers, T=21, F=7, B=17 (tests/test_bilstm.py's size)."""
    jcfg, tcfg = _cfgs(num_input=7, num_hidden=100, timesteps=21)
    tree = _numpy_params(0, jcfg)
    x = np.random.default_rng(1).standard_normal((17, 21, 7)).astype(
        np.float32)
    return jcfg, tcfg, tree, x


def test_plain_fp32_matches_jax_scan_and_mono(full_width):
    jcfg, tcfg, tree, x = full_width
    params = params_from_numpy(tree, "cpu")
    xt = torch.from_numpy(x)
    got_f = tf_ops.bilstm_center_plain(params, xt, tcfg, "fp32").numpy()
    got_l = tb.bilstm_logits(params, xt, tcfg, "fp32").numpy()

    scan_f = np.asarray(jb._bidi_fused_features(tree, jnp.asarray(x), jcfg))
    scan_l = np.asarray(jb.bilstm_logits(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got_f, scan_f, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_l, scan_l, rtol=0, atol=2e-5)

    mono_f = np.asarray(bilstm_fused_center_mono(
        tree, jnp.asarray(x), tile_b=8, interpret=True))
    np.testing.assert_allclose(got_f, mono_f, rtol=0, atol=2e-5)
    mono_l = mono_f @ tree["out_w"] + tree["out_b"]
    np.testing.assert_allclose(got_l, mono_l, rtol=0, atol=2e-5)


def test_plain_bf16_matches_jax_mono_bf16(full_width):
    jcfg, tcfg, tree, x = full_width
    params = params_from_numpy(tree, "cpu")
    got = tf_ops.bilstm_center_plain(
        params, torch.from_numpy(x), tcfg, "bf16").numpy()
    want = np.asarray(bilstm_fused_center_mono(
        tree, jnp.asarray(x), tile_b=8, interpret=True, precision="bf16"))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    # the center rows leave both kernels rounded to bf16
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
    # argmax agrees wherever the decision is not a near tie
    lg = got @ tree["out_w"] + tree["out_b"]
    lw = want @ tree["out_w"] + tree["out_b"]
    margin = np.abs(lw[:, 1] - lw[:, 0])
    sure = margin > 1e-2
    assert sure.sum() > 10
    np.testing.assert_array_equal(lg.argmax(1)[sure], lw.argmax(1)[sure])


@pytest.mark.parametrize("timesteps", [5, 9, 21])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_plain_depths_and_windows(timesteps, layers):
    jcfg, tcfg = _cfgs(num_input=7, num_hidden=16, timesteps=timesteps,
                       num_layers=layers)
    tree = _numpy_params(timesteps * 10 + layers, jcfg)
    x = np.random.default_rng(layers).standard_normal(
        (9, timesteps, 7)).astype(np.float32)
    params = params_from_numpy(tree, "cpu")
    got = tf_ops.bilstm_center_plain(params, torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jb._bidi_fused_features(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_plain_even_window_matches_scan():
    """Even T (CPU only: the CUDA kernel takes odd T) runs all T steps and
    reads fw at T//2, bw at T-1-T//2, like the scan path."""
    jcfg, tcfg = _cfgs(num_input=7, num_hidden=16, timesteps=8, num_layers=2)
    tree = _numpy_params(5, jcfg)
    x = np.random.default_rng(5).standard_normal((6, 8, 7)).astype(np.float32)
    got = tf_ops.bilstm_center_plain(
        params_from_numpy(tree, "cpu"), torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jb._bidi_fused_features(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_sigmoid_output_layer(full_width):
    _, _, tree, x = full_width
    jcfg, tcfg = _cfgs(num_input=7, output_layer="sigmoid")
    params = params_from_numpy(tree, "cpu")
    got = tb.bilstm_logits(params, torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jb.bilstm_logits(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.all((got > 0) & (got < 1))
    probs = tb.bilstm_probs(params, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(
        tb.bilstm_predict(params, torch.from_numpy(x), tcfg).numpy(),
        probs.argmax(1))


def test_wrapper_routes_cpu_to_plain_and_reads_strided_windows(full_width):
    """The public wrapper takes the plain version for CPU tensors (no
    kernel launch), packed or raw params, and reads an overlapping window
    view of a (rows, F) block exactly like materialized windows."""
    _, tcfg, tree, _ = full_width
    params = params_from_numpy(tree, "cpu")
    rows = np.random.default_rng(2).standard_normal((40, 7)).astype(
        np.float32)
    block = torch.from_numpy(rows)
    view = block.as_strided((40 - 21 + 1, 21, 7), (7, 7, 1))
    mat = torch.from_numpy(np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(rows, 21, axis=0)
        .transpose(0, 2, 1)))
    tf_ops.reset_launch_counts()
    for precision in ("fp32", "bf16"):
        packed = tf_ops.pack_bilstm_params(params, tcfg, precision)
        a = tf_ops.bilstm_center_features(packed, view, tcfg, precision)
        b = tf_ops.bilstm_center_features(params, mat, tcfg, precision)
        assert torch.equal(a, b)
    assert tf_ops.LAUNCHES == {"fp32": 0, "bf16": 0}


def test_bf16_packing_halves_ifo_columns(full_width):
    _, tcfg, tree, _ = full_width
    params = params_from_numpy(tree, "cpu")
    h = tcfg.num_hidden
    w, b = tf_ops.layer_weights(params["fw"][0], "bf16")
    k16 = params["fw"][0]["kernel"].to(torch.bfloat16)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert torch.equal(w[:, h:2 * h], k16[:, h:2 * h])
    for g in (0, 2, 3):
        cols = slice(g * h, (g + 1) * h)
        assert torch.equal(w[:, cols].float() * 2, k16[:, cols].float())
        assert torch.equal(b[cols] * 2, params["fw"][0]["bias"][cols])
    packed = tf_ops.pack_bilstm_params(params, tcfg, "bf16")
    assert packed.w.numel() == 2 * (107 * 400 + 2 * 200 * 400)
    assert packed.bias.shape == (2, 3, 400)
