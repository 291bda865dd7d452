"""The tensor-core layout of K4 and K5a's bf16 mode (``csrc/lstm_tc.cuh``),
on the CPU.

``tc_pack_layer`` pads, permutes and stores a layer's weights for the
kernels' ``wgmma`` chain. These tests replay one kernel step in plain
torch exactly as the kernel addresses it: the A operand [h_{t-1}; x_t;
zero] in ring slots of 8-wide core columns, each k-tile read through a
no-swizzle shared-memory descriptor (start, leading byte offset along K,
stride byte offset along M/N), the product into each thread's accumulator
fragment (the wgmma D layout), and the cell on the four gates the
permutation puts in that fragment. Gates and h must match the reference
step of ``layer_weights`` + ``_run_lane``'s formulas within 1e-6 (fp32
arithmetic on the same bf16 operands; only the summation order differs),
and a padded unit's h must be exactly 0.
"""

import numpy as np
import pytest
import torch

from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
from deepmod_tpu_torch.ops import bilstm_fused as ops

ROWS = ops.TC_TILE_B
COL = ROWS * 8  # elements of one core column: 64 rows x 8
FORGET_BIAS = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: under the suite's parallel workers its
    intra-op threads contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layer(seed, in_dim, hidden):
    """A layer's params at the model's init scale (Glorot uniform), the
    bias at the same scale."""
    rng = np.random.default_rng(seed)
    limit = np.sqrt(6.0 / (in_dim + 5 * hidden))
    params = {
        "kernel": torch.from_numpy(rng.uniform(
            -limit, limit, (in_dim + hidden, 4 * hidden)).astype(np.float32)),
        "bias": torch.from_numpy(rng.uniform(
            -limit, limit, 4 * hidden).astype(np.float32)),
    }
    return ops.layer_weights(params, "bf16"), rng


def _slot(a):
    """(64, 8n) -> the kernel's ring-slot layout: core column c holds
    a[:, 8c:8c+8] row-major."""
    return a.reshape(ROWS, -1, 8).permute(1, 0, 2).reshape(-1)


def _read(mem, start, lbo, sbo, rows):
    """A (rows, 16) k-tile through a no-swizzle K-major descriptor, in
    elements: core matrices of 8 rows x 8, rows 8 apart inside one, the
    next 8 rows ``sbo`` on, the next 8 of K ``lbo`` on."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    return mem[start + (r // 8) * sbo + (r % 8) * 8 + (k // 8) * lbo
               + (k % 8)]


def _kernel_step(w_tc, b_tc, h_prev, x_t, c_prev, in_dim, hidden, s):
    """One step of lstm_tc.cuh::run_layer at ring slot s (t & 1) for the
    block's 64 windows: gates (64, Hp, 4) as the cells see them (bias
    added) and h (64, Hp) in fp32. h_prev, x_t: the step's bf16 operands,
    (64, Hp) and (64, 8*nx); c_prev: (64, Hp) fp32."""
    hp, nx, nk = ops.tc_dims(in_dim, hidden)
    nh, nc = hp // 8, hp // 8 + nx
    # carve: h ring, x ring, zero column, weights (element addresses)
    h_slot, x_slot = nh * COL, nx * COL
    h_ring = torch.zeros(2, h_slot, dtype=torch.bfloat16)
    x_ring = torch.zeros(2, x_slot, dtype=torch.bfloat16)
    h_ring[s ^ 1] = _slot(h_prev)
    x_ring[s] = _slot(x_t)
    mem = torch.cat([h_ring.reshape(-1), x_ring.reshape(-1),
                     torch.zeros(COL, dtype=torch.bfloat16), w_tc]).float()
    h_base, x_base = (s ^ 1) * h_slot, 2 * h_slot + s * x_slot
    zero_col = 2 * h_slot + 2 * x_slot
    w_start = zero_col + COL
    w_lbo = 4 * hp * 8

    def col(c):
        if c < nh:
            return h_base + c * COL
        return x_base + (c - nh) * COL if c < nc else zero_col

    d = torch.zeros(2, ROWS, 2 * hp)
    for wg in range(2):
        w_base = w_start + wg * (2 * hp // 8) * 64
        for j in range(nk):
            a = _read(mem, col(2 * j), col(2 * j + 1) - col(2 * j), 64, ROWS)
            b = _read(mem, w_base + 2 * j * w_lbo, w_lbo, 64, 2 * hp)
            d[wg] += a @ b.t()

    # each thread's accumulator fragment: d[4c+r] at row 16*warp + g +
    # 8*(r // 2), column 8c + 2q + r % 2
    tid = torch.arange(ops.TC_THREADS)
    wg, warp, g, q = tid // 128, (tid % 128) // 32, (tid % 32) // 4, tid % 4
    jj = torch.arange(hp)
    rows = 16 * warp[:, None] + g[:, None] + 8 * ((jj % 4) // 2)[None, :]
    cols = 8 * (jj // 4)[None, :] + 2 * q[:, None] + (jj % 2)[None, :]
    acc = d[wg[:, None], rows, cols]
    # the kernel's cell: unit wg*Hp/2 + q + 4p, rows row0 and row0 + 8
    p = torch.arange(hp // 8)
    unit = wg[:, None] * (hp // 2) + q[:, None] + 4 * p[None, :]
    row0 = 16 * warp + g
    gates = torch.zeros(ROWS, hp, 4)
    for half, (ri, rj, rf, ro) in enumerate(((0, 1, 4, 5), (2, 3, 6, 7))):
        r = (row0 + 8 * half)[:, None].expand_as(unit)
        four = torch.stack([acc[:, 8 * p + k] for k in (ri, rj, rf, ro)], -1)
        gates[r, unit] = four + b_tc[unit]
    c = c_prev * (0.5 * torch.tanh(gates[..., 2] + 0.5 * FORGET_BIAS) + 0.5)
    c = c + (0.5 * torch.tanh(gates[..., 0]) + 0.5) * torch.tanh(gates[..., 1])
    h = torch.tanh(c) * (0.5 * torch.tanh(gates[..., 3]) + 0.5)
    # groups with no real unit are skipped: h stays 0
    u = torch.arange(hp)
    group_start = u // (hp // 2) * (hp // 2) + u % (hp // 2) // 4 * 4
    return gates, torch.where(group_start < hidden, h, torch.zeros_like(h))


def _reference_step(w, b, h_prev, x_t, c_prev, in_dim, hidden):
    """``_run_lane``'s step on unpadded operands: gates (64, H, 4), h."""
    gates = (x_t[:, :in_dim].float() @ w[:in_dim].float()
             + h_prev[:, :hidden].float() @ w[in_dim:].float() + b)
    i, j, f, o = gates.split(hidden, dim=1)
    sig = lambda v: 0.5 * torch.tanh(v) + 0.5  # noqa: E731
    c = c_prev[:, :hidden] * sig(f + 0.5 * FORGET_BIAS) + sig(i) * torch.tanh(j)
    return torch.stack([i, j, f, o], -1), torch.tanh(c) * sig(o)


def _operands(rng, in_dim, hidden, nx):
    hp = ops.tc_dims(in_dim, hidden)[0]
    h_prev = torch.zeros(ROWS, hp, dtype=torch.bfloat16)
    h_prev[:, :hidden] = torch.from_numpy(
        rng.uniform(-1, 1, (ROWS, hidden)).astype(np.float32)).bfloat16()
    x_t = torch.zeros(ROWS, 8 * nx, dtype=torch.bfloat16)
    x_t[:, :in_dim] = torch.from_numpy(
        rng.standard_normal((ROWS, in_dim)).astype(np.float32)).bfloat16()
    c_prev = torch.zeros(ROWS, hp)
    c_prev[:, :hidden] = torch.from_numpy(
        rng.uniform(-2, 2, (ROWS, hidden)).astype(np.float32))
    return h_prev, x_t, c_prev


@pytest.mark.parametrize("hidden", [16, 18, 40, 100])
@pytest.mark.parametrize("layer", [0, 1])
def test_tc_step_matches_reference(hidden, layer):
    """Layer 0 (F=7: one x column, an odd column count at H=16 and 18, so
    a zero column) and a later layer (x = the previous layer's padded h)."""
    in_dim = 7 if layer == 0 else hidden
    (w, b), rng = _layer(hidden + layer, in_dim, hidden)
    w_tc, b_tc = ops.tc_pack_layer(w, b, in_dim, hidden)
    hp, nx, _ = ops.tc_dims(in_dim, hidden)
    for s in (0, 1):
        h_prev, x_t, c_prev = _operands(rng, in_dim, hidden, nx)
        gates, h = _kernel_step(w_tc, b_tc, h_prev, x_t, c_prev, in_dim,
                                hidden, s)
        want_g, want_h = _reference_step(w, b, h_prev, x_t, c_prev, in_dim,
                                         hidden)
        torch.testing.assert_close(gates[:, :hidden], want_g, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(h[:, :hidden], want_h, rtol=0, atol=1e-6)
        # padded units: zero gates, h exactly 0
        assert torch.equal(gates[:, hidden:], torch.zeros_like(gates[:, hidden:]))
        assert torch.equal(h[:, hidden:], torch.zeros_like(h[:, hidden:]))


def test_reference_step_is_run_lane():
    """The reference step above is ``_run_lane``'s first step (zero h, c)."""
    (w, b), rng = _layer(5, 7, 40)
    x = torch.from_numpy(rng.standard_normal((ROWS, 7)).astype(
        np.float32)).bfloat16()
    zeros = torch.zeros(ROWS, 40)
    _, want = _reference_step(w, b, zeros.bfloat16(), x, zeros, 7, 40)
    got = ops._run_lane([x], w, b, FORGET_BIAS, "bf16")[0]
    assert torch.equal(got, want.bfloat16())


def test_tc_layout_sizes():
    cfg = BiLSTMConfig()  # H=100, F=7, 3 layers
    assert ops.tc_dims(7, 100) == (104, 1, 7)      # K = 112 at layer 0
    assert ops.tc_dims(100, 100) == (104, 13, 13)  # K = 208 after it
    assert ops.tc_smem(cfg) == 228992 <= ops.MAX_SMEM
    packed = ops.pack_bilstm_params(
        {lane: [{"kernel": torch.zeros(i + 100, 400), "bias": torch.zeros(400)}
                for i in (7, 100, 100)] for lane in ("fw", "bw")}, cfg, "bf16")
    assert packed.tc_w.numel() == 2 * (112 + 2 * 208) * 416
    assert packed.tc_bias.shape == (3, 2, 104, 4)
    assert ops.pack_bilstm_params(packed.params, cfg, "fp32").tc_w is None
    assert ops.mono_block(cfg, "merged", 64, "bf16") == (256, 256, 228992)


def test_tc_kernels_refuse_other_tiles_and_widths():
    cfg = BiLSTMConfig(num_hidden=16)
    params = {lane: [{"kernel": torch.zeros(i + 16, 64), "bias": torch.zeros(64)}
                     for i in (7, 16, 16)] for lane in ("fw", "bw")}
    packed = ops.pack_bilstm_params(params, cfg, "bf16")
    ops._check_tc(packed, cfg, 64)
    with pytest.raises(ValueError, match="tile_b=64"):
        ops._check_tc(packed, cfg, 24)
    wide = BiLSTMConfig(num_hidden=112, num_layers=1)
    with pytest.raises(ValueError, match="hidden <= 104"):
        ops._check_tc(packed, wide, 64)
    assert ops.tensor_core("merged", "bf16") and ops.tensor_core("layered", "bf16")
    assert not ops.tensor_core("merged", "fp32")
    assert not ops.tensor_core("mono", "bf16")
    assert ops.SCHEDULE_TILE_B["layered"] == {"fp32": 24, "bf16": 64}
