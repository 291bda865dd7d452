"""The port's one-direction LSTM layer (plain version of the K6 CUDA
kernel), the model's one-direction stacks, and the transcendental probe
(plain version of the P1 CUDA kernel) on the CPU.

K6 and the stacks are held against the JAX package (``lstm_layer_pallas``
in interpret mode, the scan path's ``_stack_direction``) on numpy-seeded
inputs: fp32, 1e-5 absolute for one layer, 2e-5 for a 3-layer stack
(different summation orders). The JAX probe builds its kernel inside its
``main()``, so P1's plain version is held against a numpy loop of the
same op instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.lstm_pallas import lstm_layer_pallas
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import lstm_layer as k6
from deepmod_tpu_torch.tools import probe_transcendental as p1
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


def _layers(seed, in_dim=7, hidden=100, layers=3):
    rng = np.random.default_rng(seed)
    out = []
    for layer in range(layers):
        d = in_dim if layer == 0 else hidden
        lim = np.sqrt(6.0 / (d + 5 * hidden))
        out.append({
            "kernel": rng.uniform(-lim, lim, (d + hidden, 4 * hidden))
            .astype(np.float32),
            "bias": (0.1 * rng.standard_normal(4 * hidden)).astype(np.float32),
        })
    return out


def _torch_params(fw, bw=()):
    h = fw[0]["kernel"].shape[1] // 4
    return params_from_numpy({
        "fw": fw, "bw": list(bw), "out_w": np.zeros((2 * h, 2), np.float32),
        "out_b": np.zeros(2, np.float32)}, "cpu")


def _torch_layers(layers):
    return _torch_params(layers)["fw"]


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(7).standard_normal((10, 21, 7)).astype(
        np.float32)
    return _layers(3), x


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_plain_matches_pallas(setup, reverse):
    """H=100, T=21; with reverse the steps run T-1..0 and each h stays at
    its own index."""
    layers, x = setup
    lp = layers[0]
    want = np.asarray(lstm_layer_pallas(
        jnp.asarray(lp["kernel"]), jnp.asarray(lp["bias"]), jnp.asarray(x),
        forget_bias=1.0, reverse=reverse, tile_b=8, interpret=True))
    tl = _torch_layers(layers)[0]
    k6.reset_launch_counts()
    got = k6.lstm_layer(tl["kernel"], tl["bias"], torch.from_numpy(x), 1.0,
                        reverse).numpy()
    assert got.shape == (10, 21, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert k6.LAUNCHES == {"fp32": 0}  # the CPU runs the plain version


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_stack_direction_matches_jax_scan(setup, reverse, depth):
    layers, x = setup
    layers = layers[:depth]
    want = np.asarray(jb._stack_direction(
        [{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers],
        jnp.asarray(x), 1.0, reverse, use_pallas=False))
    k6.reset_launch_counts()
    got = tb._stack_direction(_torch_layers(layers), torch.from_numpy(x), 1.0,
                              reverse).numpy()
    assert k6.LAUNCHES == {"fp32": 0}  # the CPU runs K6's plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_stacks_read_at_the_center_give_the_center_features(setup):
    """The fw stack and the reversed bw stack, read at T//2, are the
    model's center features (K1's plain version)."""
    layers, x = setup
    bw = _layers(4)
    params = _torch_params(layers, bw)
    cfg = tb.BiLSTMConfig()
    xt = torch.from_numpy(x)
    fw_seq = tb._stack_direction(params["fw"], xt, 1.0, False)
    bw_seq = tb._stack_direction(params["bw"], xt, 1.0, True)
    feats = torch.cat([fw_seq[:, 10], bw_seq[:, 10]], dim=1)
    torch.testing.assert_close(
        feats, tb.bilstm_center_features(params, xt, cfg), rtol=0, atol=2e-5)


def _numpy_probe(x, op, iters, bf16):
    v = np.asarray(x, np.float32)
    for _ in range(iters):
        if op == "tanh":
            v = np.tanh(v)
        elif op == "pade":
            v2 = v * v
            v = v * (np.float32(27) + v2) / (np.float32(27) + np.float32(9) * v2)
        else:
            v = (v.astype(np.float64) * p1.MUL_A + p1.MUL_B).astype(np.float32)
        if bf16:
            v = v.astype(jnp.bfloat16).astype(np.float32)
    return v


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("op", ["tanh", "pade", "mul"])
def test_probe_plain_matches_numpy_loop(op, precision):
    """K=256 steps on a (64, 64) buffer: fp32 rtol 1e-5 (tanh may differ
    by an ulp between libraries; pade and mul round exactly alike), bf16
    within one bf16 ulp of the value."""
    x = p1.probe_input(precision, "cpu")[:64, :64]
    p1.reset_launch_counts()
    got = p1.probe(x, op, 256)
    assert got.dtype == x.dtype and p1.LAUNCHES == {"fp32": 0, "bf16": 0}
    got = got.float().numpy()
    want = _numpy_probe(x.float().numpy(), op, 256, precision == "bf16")
    assert np.isfinite(got).all()
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        if op != "tanh":
            np.testing.assert_array_equal(got, want)
    else:
        ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_probe_entry_point_on_cpu(capsys):
    assert p1.main(["--device", "cpu", "--reps", "1", "--iters", "4",
                    "--ops", "tanh,mul"]) == 0
    out = capsys.readouterr().out
    assert "cpu (plain version)" in out
    assert out.count("Gop/s") == 4
