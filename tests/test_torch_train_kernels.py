"""The port's training kernels' plain versions (K2 forward, K3 BPTT) and
their autograd Function against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages:

- full width (H=100, 3 layers, T=21, F=7, B=12) against jax.grad of the
  JAX scan path: features 2e-5 absolute, gradients rtol 5e-4 / atol 5e-5
  (the tolerances at which tests/test_bilstm_train_vjp.py pins the TPU
  kernels to that scan: summation order and the two sigmoid forms);
- small width (H=16) against the JAX fused custom VJP itself, run as the
  JAX suite runs it (interpret mode, tile_b 8): the same contract down to
  the tanh sigmoid and the bf16 storage. fp32 as above; bf16 features
  atol 2e-3 (one bf16 step at the rounding points), the gradient tree
  within relative L2 5e-3 and cosine 0.9999;
- even T and depths 1 and 3 against the scan path in fp32;
- the hand-written backward against torch.autograd through the plain
  forward loop, which has no custom backward;
- K2's and K3's block limits, and the dW product's tiling and ordered split-K
  ranges replayed from the wrapper's sizing (every output once, every
  row once, the ordered fp32 sum within 1e-6 of fp64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.bilstm_fused_train import bilstm_fused_center_train
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused_train as tr
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


FP32_TOL = dict(rtol=5e-4, atol=5e-5)


def _numpy_params(hidden, layers, seed):
    """Random params as numpy, with non-zero LSTM biases so their
    gradients are exercised."""
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=hidden, num_layers=layers)
    tree = tb.init_bilstm_params(seed, cfg, "cpu")
    rng = np.random.default_rng(seed + 1)
    out = {lane: [{"kernel": lp["kernel"].numpy(),
                   "bias": rng.normal(0, 0.1, lp["bias"].shape).astype(np.float32)}
                  for lp in tree[lane]] for lane in ("fw", "bw")}
    out["out_w"] = tree["out_w"].numpy()
    out["out_b"] = tree["out_b"].numpy()
    return out


def _leaf_arrays(grads_tree, layers):
    return [np.asarray(grads_tree[lane][layer][key]) for lane in ("fw", "bw")
            for layer in range(layers) for key in ("kernel", "bias")]


def _torch_run(tree, x, cfg, precision):
    """Features and gradients of 0.5*sum(f^2) + sum(f) through the port's
    autograd Function (plain versions on the CPU)."""
    params = params_from_numpy(tree, "cpu")
    leaves = tr._lstm_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    feats = tr.bilstm_center_train(params, xt, cfg, precision).to(torch.float32)
    loss = 0.5 * (feats * feats).sum() + feats.sum()
    grads = torch.autograd.grad(loss, leaves + [xt])
    return feats.detach().numpy(), [g.numpy() for g in grads]


def _jax_run(tree, x, cfg, fused, precision="fp32"):
    jcfg = jb.BiLSTMConfig(num_input=cfg.num_input, num_hidden=cfg.num_hidden,
                           timesteps=cfg.timesteps, num_layers=cfg.num_layers)

    def feats(p, xx):
        if fused:
            return bilstm_fused_center_train(
                p, xx, jcfg.num_layers, jcfg.num_hidden, jcfg.timesteps,
                jcfg.forget_bias, 8, True, precision).astype(jnp.float32)
        return jb.bilstm_center_features(p, xx, jcfg)

    @jax.jit
    def run(p, xx):
        f, vjp = jax.vjp(feats, p, xx)
        return f, vjp(f + 1.0)  # d/df of 0.5*sum(f^2) + sum(f)

    f, (gp, gx) = run(tree, jnp.asarray(x))
    return np.asarray(f), _leaf_arrays(gp, cfg.num_layers) + [np.asarray(gx)]


def _names(layers):
    return [f"{lane}/{layer}/{key}" for lane in ("fw", "bw")
            for layer in range(layers) for key in ("kernel", "bias")] + ["x"]


def _assert_grads_close(got, want, layers, **tol):
    for name, a, b in zip(_names(layers), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


def _case(hidden, layers, timesteps, batch, seed):
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=hidden, num_layers=layers,
                          timesteps=timesteps)
    x = np.random.default_rng(seed).standard_normal(
        (batch, timesteps, 7)).astype(np.float32)
    return cfg, _numpy_params(hidden, layers, seed), x


@pytest.fixture(scope="module")
def full_width():
    cfg, tree, x = _case(100, 3, 21, 12, 0)
    return cfg, tree, x, _jax_run(tree, x, cfg, fused=False)


def test_full_width_fp32_matches_jax_scan(full_width):
    cfg, tree, x, (f_want, g_want) = full_width
    before = dict(tr.LAUNCHES)
    f_got, g_got = _torch_run(tree, x, cfg, "fp32")
    assert tr.LAUNCHES == before  # CPU tensors take the plain versions
    np.testing.assert_allclose(f_got, f_want, rtol=0, atol=2e-5)
    _assert_grads_close(g_got, g_want, cfg.num_layers, **FP32_TOL)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps", [5, 21])
def test_small_width_matches_jax_fused_vjp(timesteps, precision):
    cfg, tree, x = _case(16, 3, timesteps, 8, timesteps)
    f_want, g_want = _jax_run(tree, x, cfg, fused=True, precision=precision)
    f_got, g_got = _torch_run(tree, x, cfg, precision)
    if precision == "fp32":
        np.testing.assert_allclose(f_got, f_want, rtol=0, atol=2e-5)
        _assert_grads_close(g_got, g_want, cfg.num_layers, **FP32_TOL)
        return
    np.testing.assert_allclose(f_got, f_want, rtol=0, atol=2e-3)
    a = np.concatenate([g.ravel() for g in g_got[:-1]])
    b = np.concatenate([g.ravel() for g in g_want[:-1]])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 5e-3
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999


@pytest.mark.parametrize("layers", [1, 3])
def test_even_window_matches_jax_scan(layers):
    cfg, tree, x = _case(16, layers, 8, 8, 30 + layers)
    f_want, g_want = _jax_run(tree, x, cfg, fused=False)
    f_got, g_got = _torch_run(tree, x, cfg, "fp32")
    np.testing.assert_allclose(f_got, f_want, rtol=0, atol=2e-5)
    _assert_grads_close(g_got, g_want, layers, **FP32_TOL)


def test_custom_backward_equals_autograd_through_plain_loop(full_width):
    cfg, tree, x, _ = full_width
    f_got, g_got = _torch_run(tree, x, cfg, "fp32")

    params = params_from_numpy(tree, "cpu")
    leaves = tr._lstm_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    steps, center, bw_center = tr.readout(cfg.timesteps)
    hs, _ = tr.train_fwd_plain(tr.layer_inputs(xt, steps),
                               tr.stack_lanes(params), cfg.forget_bias)
    feats = torch.cat([hs[-1, 0, center], hs[-1, 1, bw_center]], dim=1)
    loss = 0.5 * (feats * feats).sum() + feats.sum()
    g_want = [g.numpy() for g in torch.autograd.grad(loss, leaves + [xt])]
    np.testing.assert_array_equal(f_got, feats.detach().numpy())
    _assert_grads_close(g_got, g_want, cfg.num_layers, **FP32_TOL)


def test_bf16_storage_keeps_fp32_weights_and_grads():
    cfg, tree, x = _case(16, 2, 5, 8, 7)
    params = params_from_numpy(tree, "cpu")
    feats = tr.bilstm_center_train(params, torch.from_numpy(x), cfg, "bf16")
    assert feats.dtype == torch.bfloat16
    xin = tr.layer_inputs(torch.from_numpy(x).to(torch.bfloat16), 3)
    hs, cs = tr.train_fwd(xin, tr.stack_lanes(params), cfg.forget_bias)
    assert hs.dtype == cs.dtype == torch.bfloat16
    assert hs.shape == (2, 2, 3, 8, 16)
    _, g = _torch_run(tree, x, cfg, "bf16")
    assert all(a.dtype == np.float32 for a in g)


def test_kernel_block_limits_raise():
    # K2 (the fp32 core, ``fwd_shape``): hidden up to 128, fnum <= hidden,
    # a tile a multiple of 8 and a CTA within 256 threads and 232,448 B
    assert tr.fwd_shape(7, 128).smem <= tr.MAX_SMEM
    with pytest.raises(ValueError, match="hidden <= 128"):
        tr.fwd_shape(7, 200)
    with pytest.raises(ValueError, match="threads"):
        tr.fwd_shape(7, 100, tile_b=128, split=2)
    with pytest.raises(ValueError, match="shared memory"):
        tr.fwd_shape(7, 100, tile_b=48, split=2)
    with pytest.raises(ValueError, match="multiple of 8"):
        tr.fwd_shape(7, 100, tile_b=44)
    with pytest.raises(ValueError, match="fnum <= hidden"):
        tr.fwd_shape(57, 16)
    # K3's recurrence: 2 x (H rounded up to 8) threads in whole warps, the
    # step's da and, up to H = 104, Wh^T in shared memory (H = 100: 51,200
    # + 166,400 B)
    assert tr.bwd_block(100) == (224, 217600, True)
    assert tr.bwd_block(104) == (224, 226304, True)
    assert tr.bwd_block(105) == (224, 53760, False)
    assert tr.bwd_block(128) == (256, 65536, False)
    assert tr._check_bwd_block(100, 57) and not tr._check_bwd_block(128, 7)
    with pytest.raises(ValueError, match="threads"):
        tr._check_bwd_block(130, 7)
    with pytest.raises(ValueError, match="fnum <= hidden"):
        tr._check_bwd_block(16, 57)


def _dw_ranges(rows, splits):
    """The [begin, end) rows each split of the dW product sums
    (``bilstm_train.cu::dw_rows_per_split``): the rows over ``splits``,
    rounded up to DW_CHUNK; trailing ranges may be empty."""
    per = -(-rows // splits)
    per = -(-per // tr.DW_CHUNK) * tr.DW_CHUNK
    return [(min(s * per, rows), min(s * per + per, rows))
            for s in range(splits)]


def _patch(t, i, size, tile):
    """gemm_kernel's ``patch``: value i of thread t's patch of ``size``;
    an 8-wide patch is two runs of 4 half a tile apart."""
    if size == 8:
        return t * 4 + (i & 3) + (i >> 2) * (tile // 2)
    return t * size + i


@pytest.mark.parametrize("hidden", [100, 128])
@pytest.mark.parametrize("fnum", [7, 57])
def test_dw_tiling_covers_each_output_once(fnum, hidden):
    """K3's dW product at batch 2,083 (ragged), T=21: the 128 x 128 tiles
    of 16 x 16 threads with 8 x 8 patches cover every (row, column) of the
    (in+H+1) x 4H output once, the split ranges cover the steps*B rows
    once in order, and the ranges' fp32 partial sums added in order equal
    the fp64 product within 1e-6 relative."""
    batch, steps = 2083, 11
    rows, m_all, n_all = steps * batch, fnum + hidden + 1, 4 * hidden
    tm, tn = tr.dw_tiles(fnum, hidden)
    (tile_m, tile_n), t = tr.DW_TILE, torch.arange(16)
    local_m = _patch(t[:, None], torch.arange(8)[None, :], 8,
                     tile_m).reshape(-1)
    local_n = _patch(t[:, None], torch.arange(8)[None, :], 8,
                     tile_n).reshape(-1)
    assert sorted(local_m.tolist()) == list(range(tile_m))
    assert sorted(local_n.tolist()) == list(range(tile_n))
    count = torch.zeros(m_all, n_all, dtype=torch.int64)
    for bm in range(tm):
        for bn in range(tn):
            m = bm * tile_m + local_m
            n = bn * tile_n + local_n
            m, n = m[m < m_all], n[n < n_all]
            count[m[:, None], n[None, :]] += 1
    assert torch.equal(count, torch.ones_like(count))

    splits = tr.dw_splits(rows, fnum, hidden)
    assert 2 * tm * tn * splits >= 132 or splits == tr.DW_SPLITS
    ranges = _dw_ranges(rows, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % tr.DW_CHUNK == 0 for lo, _ in ranges)

    rng = np.random.default_rng(fnum + hidden)
    a = rng.standard_normal((rows, m_all)).astype(np.float32)
    a[:, -1] = 1.0  # the bias row's ones
    da = (rng.standard_normal((rows, n_all)) / batch).astype(np.float32)
    total = np.zeros((m_all, n_all), np.float32)
    for lo, hi in ranges:
        total += a[lo:hi].T @ da[lo:hi]
    want = a.astype(np.float64).T @ da.astype(np.float64)
    assert np.linalg.norm(total - want) / np.linalg.norm(want) <= 1e-6
