"""The fp32 core of K1 and K4 (``csrc/lstm_f32.cuh``) and K4's readout
cone, on the CPU.

``f32_pack_layer`` lays a layer's fp32 weights out gate-interleaved, each
unit's (i, j, f, o) adjacent in every row of [Wx; Wh], units padded to a
multiple of 4; a CTA of a ``split``-CTA cluster loads its units' vectors
of every row. These tests unpack that layout, replay one CTA's step of the
kernel in numpy (its unit range, its threads' windows, one fp32
multiply-add a row in the kernel's order: x rows, then h rows, then the
bias) and hold the gate pre-activations against the plain version's
within 1e-5, at H=100 (a 2-CTA cluster) and H=128 (4 CTAs). K4 runs each
layer only over the readout cone (``cone``: fw steps 0..T//2, bw steps
0..T-1-T//2 of the reversed lane); the plain layer loop over those steps
must give the JAX package's center features (its XLA scan path, which
runs all T) within 2e-5 at even T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as ops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: under the suite's parallel workers its
    intra-op threads contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(seed, cfg):
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
    tree["out_w"] = rng.standard_normal((2 * h, 2)).astype(np.float32)
    tree["out_b"] = rng.standard_normal(2).astype(np.float32)
    return tree


def _cone_plain(params, x, cfg):
    """K4's schedule in plain torch: each layer of both lanes over the
    cone's steps only (``layer_plain``), the bw lane kept reversed, read
    fw at T//2 and bw at T-1-T//2."""
    steps, fw_step, bw_step = ops.cone(cfg.timesteps)
    xt = x.transpose(0, 1)
    in_fw = in_bw = xt
    for layer in range(cfg.num_layers):
        weights = (*ops.layer_weights(params["fw"][layer], "fp32"),
                   *ops.layer_weights(params["bw"][layer], "fp32"))
        in_fw, in_bw = ops.layer_plain(in_fw, in_bw, weights, steps,
                                       cfg.forget_bias, layer == 0, False)
    assert in_fw.shape[0] == steps == cfg.timesteps // 2 + 1
    return torch.cat([in_fw[fw_step], in_bw[bw_step]], dim=1)


@pytest.mark.parametrize("timesteps", [20, 22, 64])
def test_cone_matches_jax_at_even_t(timesteps):
    """The cone's T//2+1 steps a layer give the center features of the
    JAX package's scan path, which runs all T steps (H=16, 2 layers, 8
    windows); the port's plain layer loop, which also runs all T, gives
    the same."""
    kw = dict(num_input=7, num_hidden=16, timesteps=timesteps, num_layers=2)
    jcfg, tcfg = jb.BiLSTMConfig(**kw), tb.BiLSTMConfig(**kw)
    tree = _tree(timesteps, jcfg)
    x = np.random.default_rng(timesteps).standard_normal(
        (8, timesteps, 7)).astype(np.float32)
    params = params_from_numpy(tree, "cpu")
    got = _cone_plain(params, torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jb._bidi_fused_features(tree, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    full = ops.bilstm_layered_plain(params, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=2e-5)
    assert ops.cone(timesteps) == (timesteps // 2 + 1, timesteps // 2,
                                   timesteps - 1 - timesteps // 2)


def _layer(seed, in_dim, hidden):
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (in_dim + 5 * hidden))
    params = {
        "kernel": torch.from_numpy(rng.uniform(
            -lim, lim, (in_dim + hidden, 4 * hidden)).astype(np.float32)),
        "bias": torch.from_numpy(
            (0.1 * rng.standard_normal(4 * hidden)).astype(np.float32)),
    }
    return ops.layer_weights(params, "fp32"), rng


@pytest.mark.parametrize("in_dim,hidden", [(7, 100), (100, 100), (7, 128),
                                           (128, 128), (57, 36)])
def test_f32_pack_round_trip(in_dim, hidden):
    """The packed (in+H, Hp4, 4) weights hold w[k, g*H + u] at [k, u, g],
    zeros for the padded units; the bias (Hp4, 4) likewise."""
    (w, b), _ = _layer(hidden + in_dim, in_dim, hidden)
    wp, bp = ops.f32_pack_layer(w, b, in_dim, hidden)
    hp4 = ops.f32_units(hidden)
    assert hp4 % 4 == 0 and hidden <= hp4 < hidden + 4
    wp = wp.reshape(in_dim + hidden, hp4, 4)
    assert torch.equal(wp[:, :hidden].permute(0, 2, 1).reshape(
        in_dim + hidden, 4 * hidden), w)
    assert not wp[:, hidden:].any() and not bp[hidden:].any()
    assert torch.equal(bp[:hidden].t().reshape(-1), b)


def _cta_step(wp, bp, xs, hs, in_dim, hidden, split, rank, tile):
    """CTA ``rank``'s step of the kernel, in numpy fp32: its units r*U ..
    r*U+U-1 of the packed weights as its shared memory holds them
    ([k][U][4]); thread (u, g) for u < U, g < tile/8, one multiply-add a
    row over the x rows, then the h rows, then the bias. Returns (gates
    (tile, U, 4), valid units)."""
    windows = 8
    units = -(-hidden // split)
    hp4 = ops.f32_units(hidden)
    assert split * units <= hp4
    smem = wp.reshape(in_dim + hidden, hp4, 4)[:, rank * units:
                                               (rank + 1) * units].numpy()
    ops_rows = np.concatenate([xs.T, hs.T]).astype(np.float32)  # [k][tile]
    acc = np.zeros((tile // windows, windows, units, 4), np.float32)
    for k in range(in_dim + hidden):
        op = ops_rows[k].reshape(tile // windows, windows)
        acc = acc + op[:, :, None, None] * smem[k][None, None]
    gates = acc.reshape(tile, units, 4) + bp.numpy()[
        rank * units:(rank + 1) * units][None]
    valid = np.arange(rank * units, (rank + 1) * units) < hidden
    return gates, valid


@pytest.mark.parametrize("in_dim,hidden,split", [(7, 100, 2), (100, 100, 2),
                                                 (7, 128, 4), (128, 128, 4)])
def test_f32_cta_step_gives_the_plain_gates(in_dim, hidden, split):
    """At H=100 (2 CTAs, 50 units each) and H=128 (4 CTAs, 32 each), the
    CTAs' products over the packed layout together give every unit's four
    gate pre-activations of the plain version (x @ Wx + h @ Wh + b) within
    1e-5, each unit from exactly one CTA; ``f32_shape`` picks that split
    and its CTA fits the card."""
    (w, b), rng = _layer(in_dim * hidden, in_dim, hidden)
    wp, bp = ops.f32_pack_layer(w, b, in_dim, hidden)
    shape = ops.f32_shape(in_dim, hidden)
    assert shape.split == split
    assert shape.threads <= ops.F32_MAX_THREADS
    assert shape.smem == ops.f32_smem(max(in_dim, hidden), hidden, split,
                                      shape.tile) <= ops.MAX_SMEM
    tile = shape.tile
    xs = rng.standard_normal((tile, in_dim)).astype(np.float32)
    hs = np.tanh(rng.standard_normal((tile, hidden))).astype(np.float32)
    want = (torch.from_numpy(xs) @ w[:in_dim] + torch.from_numpy(hs)
            @ w[in_dim:] + b).numpy().reshape(tile, 4, hidden)
    seen = np.zeros(hidden, np.int64)
    units = -(-hidden // split)
    for rank in range(split):
        gates, valid = _cta_step(wp, bp, xs, hs, in_dim, hidden, split, rank,
                                 tile)
        u = np.arange(rank * units, (rank + 1) * units)[valid]
        np.testing.assert_allclose(gates[:, valid], want[:, :, u].transpose(
            0, 2, 1), rtol=0, atol=1e-5)
        assert not gates[:, ~valid].any() or np.allclose(gates[:, ~valid], 0)
        seen[u] += 1
    assert (seen == 1).all()


def test_f32_shape_limits():
    """At the default tile, the fewest CTAs that hold the weights and the
    operand rings: one at H=40 (F=7), two at H=100, four at H=105-128;
    over 128, a tile that is not a multiple of 8, or a CTA over 256
    threads or 232,448 B raises."""
    assert ops.f32_shape(7, 40).split == 1
    assert ops.f32_shape(7, 100) == ops.F32Shape(2, ops.TILE_B, 250, 224960)
    assert ops.f32_shape(7, 105).split == ops.f32_shape(7, 128).split == 4
    assert ops.f32_shape(7, 100, tile_b=8).threads == 50
    with pytest.raises(ValueError, match="hidden <= 128"):
        ops.f32_shape(7, 136)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.f32_shape(7, 100, tile_b=44)
    assert ops.f32_shape(7, 100, tile_b=64) == ops.F32Shape(4, 64, 200,
                                                            183056)
    with pytest.raises(ValueError, match="256 threads"):
        ops.f32_shape(7, 100, tile_b=128)
