"""The port's layered BiLSTM path (plain version of the K4 CUDA kernel)
against the JAX package's layered Pallas kernel in interpret mode.

Inputs and weights come from one numpy seed and go through both packages
as numpy arrays (weights carried across with ``params_from_numpy``).
Tolerances: fp32 2e-5 absolute (the two sides sum the gate products in
different orders); bf16 atol 2e-3 + rtol 2e-2, the tolerance between two
bf16 schedules of the same contract (a 1-ulp rounding flip of a stored
bf16 h propagates). The JAX kernel runs with ``tile_b=8`` on few windows:
its interpret mode costs seconds a call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops import bilstm_fused as jf
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as tf_ops
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


TOL = {"fp32": dict(rtol=0, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-3)}


def _numpy_params(seed, cfg):
    """Glorot-uniform kernels and random biases, drawn with numpy."""
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


def _case(timesteps, hidden=100, layers=3, batch=8, seed=0):
    kw = dict(num_input=7, num_hidden=hidden, timesteps=timesteps,
              num_layers=layers)
    jcfg, tcfg = jb.BiLSTMConfig(**kw), tb.BiLSTMConfig(**kw)
    tree = _numpy_params(seed + timesteps, jcfg)
    x = np.random.default_rng(seed + timesteps).standard_normal(
        (batch, timesteps, 7)).astype(np.float32)
    return jcfg, tcfg, tree, x


def _jax_layered(tree, x, cfg, precision):
    return np.asarray(jf.bilstm_fused_center(
        tree, jnp.asarray(x), num_layers=cfg.num_layers,
        num_hidden=cfg.num_hidden, timesteps=cfg.timesteps,
        forget_bias=cfg.forget_bias, tile_b=8, interpret=True,
        precision=precision, mono=False))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps", [20, 31])
def test_layered_plain_matches_jax_full_width(timesteps, precision):
    """H=100, 3 layers: T=20 runs all 20 steps and reads fw at 10, bw at
    9 of the reversed lane; T=31 runs the 16-step readout cone."""
    jcfg, tcfg, tree, x = _case(timesteps)
    params = params_from_numpy(tree, "cpu")
    got = tf_ops.bilstm_layered_plain(params, torch.from_numpy(x), tcfg,
                                      precision).numpy()
    want = _jax_layered(tree, x, jcfg, precision)
    np.testing.assert_allclose(got, want, **TOL[precision])
    # the wrapper routes these window sizes to the layered kernel, and
    # K1's plain version computes the same function
    tf_ops.reset_launch_counts()
    routed = tf_ops.bilstm_center_features(params, torch.from_numpy(x), tcfg,
                                           precision).numpy()
    np.testing.assert_array_equal(routed, got)
    mono_plain = tf_ops.bilstm_center_plain(params, torch.from_numpy(x), tcfg,
                                            precision).numpy()
    np.testing.assert_array_equal(mono_plain, got)
    assert not any(tf_ops.LAYERED_LAUNCHES.values())
    if precision == "bf16":
        # the readout rows leave both kernels rounded to bf16
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))


def test_layered_plain_runtime_loop_window():
    """T=64 (past the JAX kernel's 32-step unroll: its fori_loop path) at
    small width."""
    jcfg, tcfg, tree, x = _case(64, hidden=16, layers=2, batch=9)
    params = params_from_numpy(tree, "cpu")
    got = tf_ops.bilstm_layered_plain(params, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, _jax_layered(tree, x, jcfg, "fp32"),
                               **TOL["fp32"])
    scan = np.asarray(jb._bidi_fused_features(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, scan, **TOL["fp32"])


def _jax_layer_weights(tree, layer, in_dim, hidden, precision):
    """The JAX kernel's padded (W_x, W_h, b) for both lanes of a layer."""
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    out = []
    for lane in ("fw", "bw"):
        lp = tree[lane][layer]
        wx, wh = jf._pad_weights(jnp.asarray(lp["kernel"]).astype(dt), in_dim,
                                 hidden)
        b = jf._pad_gate_blocks(jnp.asarray(lp["bias"]), hidden)[None, :]
        if precision == "bf16":
            wx, wh, b = jf._prescale_ifo(wx, wh, b)
        out += [wx, wh, b]
    return tuple(out)


@pytest.mark.parametrize("final", [False, True])
def test_layer_plain_matches_jax_run_layer(final):
    """One layer, both lanes, against ``_run_layer``: the layer-0 read
    (bw time-reversed) with every step stored, and the final layer's
    center-row store."""
    jcfg, tcfg, tree, x = _case(9, hidden=16, layers=1, batch=8)
    params = params_from_numpy(tree, "cpu")
    steps = 5
    x_tm = np.moveaxis(x, 1, 0)  # (T, B, F)
    x_pad = np.pad(x_tm, ((0, 0), (0, 0), (0, jf.LANE - 7)))
    out_fw, out_bw = jf._run_layer(
        jnp.asarray(x_pad), jnp.asarray(x_pad),
        _jax_layer_weights(tree, 0, 7, 16, "fp32"), steps, 1.0, True, 8,
        True, jnp.float32, final)
    weights = (*tf_ops.layer_weights(params["fw"][0], "fp32"),
               *tf_ops.layer_weights(params["bw"][0], "fp32"))
    xt = torch.from_numpy(x_tm)
    got_fw, got_bw = tf_ops.layer_plain(xt, xt, weights, steps, 1.0, True,
                                        final)
    assert got_fw.shape == (1 if final else steps, 8, 16)
    np.testing.assert_allclose(got_fw.numpy(), np.asarray(out_fw)[..., :16],
                               **TOL["fp32"])
    np.testing.assert_allclose(got_bw.numpy(), np.asarray(out_bw)[..., :16],
                               **TOL["fp32"])


def test_routing_follows_the_jax_package():
    """mono=None: K1 for odd T <= 25, K4 otherwise; mono=False forces K4;
    mono=True outside K1's range raises. On the CPU both routes run their
    plain versions and launch nothing."""
    assert tf_ops.use_mono(21) and tf_ops.use_mono(5)
    assert not any(tf_ops.use_mono(t) for t in (20, 27, 31, 64))
    assert not tf_ops.use_mono(21, mono=False)
    for t in (20, 27):
        with pytest.raises(ValueError, match="mono kernel"):
            tf_ops.use_mono(t, mono=True)

    _, tcfg, tree, x = _case(21, hidden=16, layers=2, batch=5)
    params = params_from_numpy(tree, "cpu")
    xt = torch.from_numpy(x)
    tf_ops.reset_launch_counts()
    for precision in ("fp32", "bf16"):
        k4 = tf_ops.bilstm_center_features(params, xt, tcfg, precision,
                                           mono=False)
        k1 = tf_ops.bilstm_center_features(params, xt, tcfg, precision)
        assert torch.equal(k4, tf_ops.bilstm_layered_plain(params, xt, tcfg,
                                                           precision))
        torch.testing.assert_close(k4, k1, **TOL[precision])
    assert tf_ops.LAUNCHES == {"fp32": 0, "bf16": 0}
    assert tf_ops.LAYERED_LAUNCHES == {"fp32": 0, "bf16": 0}


def test_layered_reads_overlapping_window_view():
    """The detect compact path's (rows-T+1, T, F) view of a (rows, F)
    block gives the features of the materialized windows at T=20."""
    _, tcfg, tree, _ = _case(20, hidden=16, layers=2)
    params = params_from_numpy(tree, "cpu")
    rows = np.random.default_rng(4).standard_normal((40, 7)).astype(
        np.float32)
    view = torch.from_numpy(rows).as_strided((21, 20, 7), (7, 7, 1))
    mat = torch.from_numpy(np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(rows, 20, axis=0)
        .transpose(0, 2, 1)))
    for precision in ("fp32", "bf16"):
        packed = tf_ops.pack_bilstm_params(params, tcfg, precision)
        a = tf_ops.bilstm_center_features(packed, view, tcfg, precision)
        b = tf_ops.bilstm_center_features(params, mat, tcfg, precision)
        assert torch.equal(a, b)
