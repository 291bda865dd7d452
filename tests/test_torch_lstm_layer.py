"""The port's one-direction LSTM layer (plain version of the K6 CUDA
kernel, its launch shape, its weight packing and a numpy replay of its
CTAs' steps), the model's one-direction stacks, and the transcendental
probe (plain version of the P1 CUDA kernel) on the CPU.

K6 and the stacks are held against the JAX package (``lstm_layer_pallas``
in interpret mode, the scan path's ``_stack_direction``) on numpy-seeded
inputs: fp32, 1e-5 absolute for one layer, 2e-5 for a 3-layer stack
(different summation orders). The JAX probe builds its kernel inside its
``main()``, so P1's plain version is held against a numpy loop of the
same op instead.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.lstm_pallas import lstm_layer_pallas
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as tf_ops
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


# ---------------------------------------------- K6 on the fp32 core's pieces

@pytest.mark.parametrize("hidden", [16, 100, 128, 170])
def test_lstm_layer_shape_fits_the_card(hidden):
    """K6's default launch (``lstm_layer_shape``): W_h's rows of the CTA's
    units, the h ring and a spare row within 232,448 B and at most 256
    threads a CTA; 2-CTA clusters at H=100, 4-CTA ones at H=128 and 170."""
    shape = k6.lstm_layer_shape(hidden)
    assert shape.tile == k6.TILE_B and shape.tile % 8 == 0
    units = -(-hidden // shape.split)
    assert shape.threads == units * shape.tile // 8 <= tf_ops.F32_MAX_THREADS
    assert shape.smem == k6.lstm_layer_smem(hidden, shape.split, shape.tile)
    assert shape.smem == ((hidden + 1) * units * 16
                          + (2 * hidden + 1) * shape.tile * 4)
    assert shape.smem <= tf_ops.MAX_SMEM
    assert shape.split == {16: 1, 100: 2, 128: 4, 170: 4}[hidden]


def test_lstm_layer_shape_refuses_what_no_launch_takes():
    """Hidden over 170 (what the kernel K6 replaced took at its default
    tile), a tile that is not a multiple of 8, or a CTA over 256 threads
    raises ``ValueError`` naming the limit."""
    with pytest.raises(ValueError, match="hidden <= 170"):
        k6.lstm_layer_shape(171)
    with pytest.raises(ValueError, match="multiple of 8"):
        k6.lstm_layer_shape(100, tile_b=12)
    with pytest.raises(ValueError, match="256 threads"):
        k6.lstm_layer_shape(100, tile_b=48, split=1)
    assert k6.lstm_layer_shape(100, tile_b=64).split == 4


def test_pack_wh_is_the_wh_rows_of_f32_pack_layer():
    """K6's operand: the (H, 4H) W_h in the fp32 core's gate-interleaved
    layout, the W_h rows of ``f32_pack_layer``'s (in+H, Hp4, 4) packing
    of the layer's [Wx; Wh] (H=102: two padded units)."""
    in_dim, hidden = 7, 102
    rng = np.random.default_rng(102)
    w = torch.from_numpy(rng.standard_normal(
        (in_dim + hidden, 4 * hidden)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4 * hidden).astype(np.float32))
    hp4 = tf_ops.f32_units(hidden)
    want = tf_ops.f32_pack_layer(w, b, in_dim, hidden)[0].reshape(
        in_dim + hidden, hp4, 4)[in_dim:]
    got = k6.pack_wh(w[in_dim:])
    assert got.dtype == torch.float32
    assert torch.equal(got.reshape(hidden, hp4, 4), want)


def _k6_replay(xp, wp, hidden, split, forget_bias, reverse):
    """Every CTA of K6's cluster over the tile's windows, in numpy fp32:
    CTA r's shared memory holds units r*U .. r*U+U-1 of the packed W_h
    ([k][U][4]); per step its threads start at 0, add one multiply-add a
    row of h_{t-1} in ascending k (none at the first step), then xp_t's
    gates of their units, the exp-sigmoid cell; h_t from every CTA is the
    next step's operand (the ring)."""
    batch, timesteps, _ = xp.shape
    units = -(-hidden // split)
    hp4 = tf_ops.f32_units(hidden)
    smem = wp.reshape(hidden, hp4, 4)
    h = np.zeros((batch, hidden), np.float32)
    c = np.zeros((batch, hidden), np.float32)
    out = np.zeros((batch, timesteps, hidden), np.float32)
    order = range(timesteps - 1, -1, -1) if reverse else range(timesteps)
    for step, t in enumerate(order):
        h_new = np.zeros_like(h)
        for rank in range(split):
            cols = np.arange(rank * units, min((rank + 1) * units, hidden))
            acc = np.zeros((batch, len(cols), 4), np.float32)
            if step > 0:
                for k in range(hidden):
                    acc = acc + h[:, k, None, None] * smem[k, cols][None]
            gates = xp[:, t].reshape(batch, 4, hidden)[:, :, cols].transpose(
                0, 2, 1) + acc
            si = 1 / (1 + np.exp(-gates[..., 0]))
            sf = 1 / (1 + np.exp(-(gates[..., 2] + np.float32(forget_bias))))
            so = 1 / (1 + np.exp(-gates[..., 3]))
            c[:, cols] = c[:, cols] * sf + si * np.tanh(gates[..., 1])
            h_new[:, cols] = np.tanh(c[:, cols]) * so
        h = h_new.astype(np.float32)
        out[:, t] = h
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden,split", [(100, 2), (128, 4)])
def test_k6_cta_replay_gives_the_plain_recurrence(hidden, split, reverse):
    """A numpy replay of every CTA's K6 steps over ``pack_wh``'s layout
    (H=100 in a 2-CTA cluster, H=128 in a 4-CTA one, each a launch
    ``lstm_layer_shape`` takes; one tile of windows, T=5) gives
    ``lstm_recurrence_plain``'s (B, T, H) within 1e-5."""
    shape = k6.lstm_layer_shape(hidden, split=split)
    assert shape.split == split
    rng = np.random.default_rng(hidden + split)
    lim = np.sqrt(6.0 / (7 + 5 * hidden))
    w_h = rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)
    xp = rng.standard_normal((shape.tile, 5, 4 * hidden)).astype(np.float32)
    wp = k6.pack_wh(torch.from_numpy(w_h)).numpy()
    got = _k6_replay(xp, wp, hidden, split, 1.0, reverse)
    want = k6.lstm_recurrence_plain(torch.from_numpy(xp),
                                    torch.from_numpy(w_h), 1.0,
                                    reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_k6_bits_tool_compares_trees(capsys):
    """``tools/k6_bits`` runs each tree's own package in a child process
    on the same seeded inputs and holds every tree's outputs against the
    first's: the checkout named twice (plain versions on the CPU) gives
    the same bits in all four cases."""
    from deepmod_tpu_torch.tools import k6_bits

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert k6_bits.main(["--tree", repo, "--tree", repo, "--device", "cpu",
                         "--batch", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 8
    second = [line for line in lines[1::2]]
    assert all("the first tree's bits: True, max abs 0.000e+00" in line
               for line in second), lines
    assert {line.split()[1] for line in lines} == {
        "h100_fw", "h100_bw", "h128_fw", "h128_bw"}


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
