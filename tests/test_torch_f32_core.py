"""The fp32 core of K1, K4 and K2 (``csrc/lstm_f32.cuh``) and K4's readout
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

K2, the training forward, runs the same core with its own policy
(``bilstm_train.cu::TrainFwd``): its prologue gathers the same layout
straight from the TF (in+H, 4H) kernels, the cell is the train contract
(tanh sigmoids, forget_bias after the f bias), and the next layer reads
the stored (in bf16: rounded) h. A numpy replay of every CTA's steps of a
layer, fed with that gather, gives ``train_fwd_plain``'s gates and h/c
within 1e-5 in fp32, at layer 0 and a later layer, H=100 (2 CTAs) and
H=128 (4 CTAs); ``fwd_shape`` is pinned at the trainer's batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as ops
from deepmod_tpu_torch.ops import bilstm_fused_train as tr
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


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


# ------------------------------------------------------- K2 on the core


def _k2_gather(w, b, in_dim, hidden, split, rank):
    """CTA ``rank``'s shared memory after K2's prologue
    (``TrainFwd::weights`` / ``bias``): for the kernel's flat index i <
    (in+H) * U, row k = i // U and unit u = rank*U + i % U hold the TF
    columns g*H + u (g = i, j, f, o), zeros past the hidden width; the
    bias likewise. Returns ([k][U][4], [U][4]) float32."""
    units = -(-hidden // split)
    rows = in_dim + hidden
    smem = np.zeros((rows * units, 4), np.float32)
    bias = np.zeros((units, 4), np.float32)
    for i in range(rows * units):
        k, ul = divmod(i, units)
        u = rank * units + ul
        if u < hidden:
            smem[i] = w[k, u::hidden]
    for ul in range(units):
        u = rank * units + ul
        if u < hidden:
            bias[ul] = b[u::hidden]
    return smem.reshape(rows, units, 4), bias


def _sigmoid(v):
    return np.float32(0.5) * np.tanh(np.float32(0.5) * v) + np.float32(0.5)


def _k2_layer_replay(w, b, seq, hidden, split, fb):
    """One layer of one lane over the tile's windows, every CTA of the
    cluster: thread (u, g) one multiply-add a row over x_t's rows, then
    h_{t-1}'s (from every CTA: the ring), then the bias, the train cell.
    seq (steps, tile, in) fp32. Returns the gates (steps, tile, H, 4) and
    the fp32 h and c (steps, tile, H)."""
    steps, tile, in_dim = seq.shape
    units = -(-hidden // split)
    ctas = [_k2_gather(w, b, in_dim, hidden, split, r) for r in range(split)]
    h = np.zeros((tile, hidden), np.float32)
    c = np.zeros((tile, hidden), np.float32)
    gates_all, hs, cs = [], [], []
    for t in range(steps):
        gates = np.zeros((tile, hidden, 4), np.float32)
        for rank, (smem, bias) in enumerate(ctas):
            acc = np.zeros((tile, units, 4), np.float32)
            for k in range(in_dim):
                acc = acc + seq[t][:, k, None, None] * smem[k][None]
            if t > 0:
                for k in range(hidden):
                    acc = acc + h[:, k, None, None] * smem[in_dim + k][None]
            acc = acc + bias[None]
            live = min(units, hidden - rank * units)  # a prefix of units
            gates[:, rank * units:rank * units + live] = acc[:, :live]
        si, sj = _sigmoid(gates[..., 0]), np.tanh(gates[..., 1])
        sf = _sigmoid(gates[..., 2] + np.float32(fb))
        so = _sigmoid(gates[..., 3])
        c = (c * sf + si * sj).astype(np.float32)
        h = (np.tanh(c) * so).astype(np.float32)
        gates_all.append(gates)
        hs.append(h)
        cs.append(c)
    return np.stack(gates_all), np.stack(hs), np.stack(cs)


@pytest.mark.parametrize("hidden,split", [(100, 2), (128, 4)])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_k2_cta_replay_gives_the_plain_forward(hidden, split, precision):
    """K2's launch at this width (``fwd_shape``: 2 CTAs at H=100, 4 at
    128), one tile of windows, T=5 (3 steps), 2 layers, both lanes: the
    replay of every CTA's steps over the gathered weights gives
    ``train_fwd_plain``'s gates (recomputed from its fp32 h) and h/c
    within 1e-5 in fp32. Layer 1 reads the stored h of layer 0: in bf16
    rounded, and the replay's h/c rounded to bf16 lie within a bf16 step
    of the plain version's. The gather holds ``f32_pack_layer``'s CTA
    slice, the layout K1 and K4 load."""
    shape = tr.fwd_shape(7, hidden)
    assert shape.split == split
    tile, fb, in_dim = shape.tile, 1.0, 7
    rng = np.random.default_rng(hidden + split)
    weights, np_weights = [], []
    for layer in range(2):
        lin = in_dim if layer == 0 else hidden
        lim = np.sqrt(6.0 / (lin + 5 * hidden))
        w = rng.uniform(-lim, lim, (2, lin + hidden, 4 * hidden)).astype(
            np.float32)
        b = (0.1 * rng.standard_normal((2, 4 * hidden))).astype(np.float32)
        np_weights.append((w, b))
        weights.append((torch.from_numpy(w), torch.from_numpy(b)))
    x = rng.standard_normal((tile, 5, in_dim)).astype(np.float32)
    dt = tr.storage_dtype(precision)
    xin = tr.layer_inputs(torch.from_numpy(x).to(dt), 3)
    hs, cs = tr.train_fwd_plain(xin, weights, fb)
    hp = hs.float().numpy()
    cp = cs.float().numpy()
    for lane in range(2):
        seq = xin[lane].float().numpy()  # (steps, tile, in)
        for layer, (w, b) in enumerate(np_weights):
            wl, bl = w[lane], b[lane]
            lin = seq.shape[-1]
            if precision == "fp32":
                # the plain gates from its own fp32 h
                h_prev = np.concatenate([np.zeros((1, tile, hidden),
                                                  np.float32), hp[layer, lane,
                                                                  :-1]])
                want = (seq @ wl[:lin] + h_prev @ wl[lin:] + bl).reshape(
                    3, tile, 4, hidden).transpose(0, 1, 3, 2)
            gates, h, c = _k2_layer_replay(wl, bl, seq, hidden, split, fb)
            if precision == "fp32":
                np.testing.assert_allclose(gates, want, rtol=0, atol=1e-5)
                np.testing.assert_allclose(h, hp[layer, lane], rtol=0,
                                           atol=1e-5)
                np.testing.assert_allclose(c, cp[layer, lane], rtol=0,
                                           atol=1e-5)
                seq = h
            else:
                rh = torch.from_numpy(h).to(dt).float().numpy()
                rc = torch.from_numpy(c).to(dt).float().numpy()
                np.testing.assert_allclose(rh, hp[layer, lane], rtol=2**-7,
                                           atol=1e-6)
                np.testing.assert_allclose(rc, cp[layer, lane], rtol=2**-7,
                                           atol=1e-6)
                seq = rh  # the next layer reads the rounded rows
        for layer, (w, b) in enumerate(np_weights):
            lin = in_dim if layer == 0 else hidden
            wp, bp = ops.f32_pack_layer(torch.from_numpy(w[lane]),
                                        torch.from_numpy(b[lane]), lin,
                                        hidden)
            hp4 = ops.f32_units(hidden)
            units = -(-hidden // split)
            for rank in range(split):
                smem, bias = _k2_gather(w[lane], b[lane], lin, hidden, split,
                                        rank)
                packed = wp.reshape(lin + hidden, hp4, 4)[
                    :, rank * units:(rank + 1) * units].numpy()
                assert np.array_equal(smem, packed)
                assert np.array_equal(bias, bp[rank * units:
                                              (rank + 1) * units].numpy())


def test_k2_shape_at_the_train_batch():
    """K2's launch at the trainer's batch 2048 (H=100, F=7): tile 32 in
    2-CTA clusters, one thread a unit and 8 windows, a CTA within 232,448
    B; the batch needs 128 clusters (two waves of the 66 an H100 holds).
    Hidden 105-128 take 4-CTA clusters; K1's and K4's shape
    (``f32_shape``, tile 40) is their own."""
    shape = tr.fwd_shape(7, 100)
    assert shape == ops.F32Shape(2, tr.FWD_TILE_B, 200, 212128)
    assert tr.FWD_TILE_B == 32
    assert shape.smem == ops.f32_smem(100, 100, 2, 32) <= 232448
    assert shape.threads <= ops.F32_MAX_THREADS
    assert 2 * -(-2048 // shape.tile) == 128
    assert tr.fwd_shape(57, 100) == shape
    assert tr.fwd_shape(7, 105).split == tr.fwd_shape(7, 128).split == 4
    assert tr.fwd_shape(7, 128).smem <= 232448
    assert tr.fwd_shape(7, 100, tile_b=64) == ops.F32Shape(4, 64, 200,
                                                            183056)
    assert ops.f32_shape(7, 100) == ops.F32Shape(2, ops.TILE_B, 250, 224960)
