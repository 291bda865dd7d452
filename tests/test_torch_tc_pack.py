"""The tensor-core layout of the bf16 modes of K1, K4 and K5a-c
(``csrc/lstm_tc.cuh``), on the CPU.

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
and a padded unit's h must be exactly 0. Hp 112-128 replay the 2-CTA
split (each CTA's half of the gate columns, one warpgroup each), K5b's
schedule (the projection into the gate buffer in fragment order, then the
h-only chain on top of it) and K1's two-dot step (separate x and h
k-tile lists over the same packing).
"""

import numpy as np
import pytest
import torch

from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
from deepmod_tpu_torch.ops import bilstm_fused as ops
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

ROWS = ops.TC_TILE_B
COL = ROWS * 8  # elements of one core column: 64 rows x 8
FORGET_BIAS = 1.0


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


def _product(a_cols, w_tc, hp, nk, split, a_bufs):
    """The wgmma chains of one step, (2, 64, 2Hp): warpgroup (gate-column
    half) w's accumulator. ``a_bufs``: the A-side buffers in address order
    (ring slots, then the zero column); ``a_cols(c, starts)`` the element
    address of A's core column c. With ``split`` 2, CTA r holds only the
    gate columns r*2Hp.. of each core column ([kc][2Hp][8], the next k
    core 2Hp*8 elements on) and runs warpgroup r alone."""
    starts, at = [], 0
    for buf in a_bufs:
        starts.append(at)
        at += buf.numel()
    n_cta = 4 * hp // split
    d = torch.zeros(2, ROWS, 2 * hp)
    for cta in range(split):
        w_cta = w_tc.reshape(-1, 4 * hp, 8)[:, cta * n_cta:(cta + 1) * n_cta]
        mem = torch.cat([*(b.reshape(-1) for b in a_bufs),
                         w_cta.reshape(-1)]).float()
        w_lbo = n_cta * 8
        for local, wg in enumerate(range(2) if split == 1 else [cta]):
            w_base = at + local * (2 * hp // 8) * 64
            for j in range(nk):
                c0, c1 = a_cols(2 * j, starts), a_cols(2 * j + 1, starts)
                a = _read(mem, c0, c1 - c0, 64, ROWS)
                b = _read(mem, w_base + 2 * j * w_lbo, w_lbo, 64, 2 * hp)
                d[wg] += a @ b.t()
    return d


def _fragments(d, hp):
    """Each thread's accumulator fragment, (256, Hp): d[4c+r] at row
    16*warp + g + 8*(r // 2), column 8c + 2q + r % 2 of its warpgroup."""
    tid = torch.arange(ops.TC_THREADS)
    wg, warp, g, q = tid // 128, (tid % 128) // 32, (tid % 32) // 4, tid % 4
    jj = torch.arange(hp)
    rows = 16 * warp[:, None] + g[:, None] + 8 * ((jj % 4) // 2)[None, :]
    cols = 8 * (jj // 4)[None, :] + 2 * q[:, None] + (jj % 2)[None, :]
    return d[wg[:, None], rows, cols]


def _kernel_step(w_tc, b_tc, h_prev, x_t, c_prev, in_dim, hidden, s,
                 split=1):
    """One step of lstm_tc.cuh::run_layer at ring slot s (t & 1) for the
    block's 64 windows: gates (64, Hp, 4) as the cells see them (bias
    added) and h (64, Hp) in fp32. h_prev, x_t: the step's bf16 operands,
    (64, Hp) and (64, 8*nx); c_prev: (64, Hp) fp32. ``split`` 2 replays
    the 2-CTA cluster of Hp 112-128: each CTA's half of the units from the
    full h_{t-1}."""
    hp, nx, nk = ops.tc_dims(in_dim, hidden)
    nh, nc = hp // 8, hp // 8 + nx
    # carve: h ring, x ring, zero column, weights (element addresses)
    h_ring = torch.zeros(2, nh * COL, dtype=torch.bfloat16)
    x_ring = torch.zeros(2, nx * COL, dtype=torch.bfloat16)
    h_ring[s ^ 1] = _slot(h_prev)
    x_ring[s] = _slot(x_t)

    def col(c, starts):
        if c < nh:
            return starts[0] + (s ^ 1) * nh * COL + c * COL
        if c < nc:
            return starts[1] + s * nx * COL + (c - nh) * COL
        return starts[2]

    d = _product(col, w_tc, hp, nk, split,
                 [h_ring, x_ring, torch.zeros(COL, dtype=torch.bfloat16)])
    return _cell(_fragments(d, hp), b_tc, c_prev, hidden)[:2]


def _gates(acc):
    """The fragments (256, Hp) as the (64, Hp, 4) gate pre-activations they
    hold: thread tid's unit wg*Hp/2 + q + 4p, rows row0 and row0 + 8."""
    hp = acc.shape[1]
    tid = torch.arange(ops.TC_THREADS)
    wg, warp, g, q = tid // 128, (tid % 128) // 32, (tid % 32) // 4, tid % 4
    p = torch.arange(hp // 8)
    unit = wg[:, None] * (hp // 2) + q[:, None] + 4 * p[None, :]
    row0 = 16 * warp + g
    gates = torch.zeros(ROWS, hp, 4)
    for half, (ri, rj, rf, ro) in enumerate(((0, 1, 4, 5), (2, 3, 6, 7))):
        r = (row0 + 8 * half)[:, None].expand_as(unit)
        four = torch.stack([acc[:, 8 * p + k] for k in (ri, rj, rf, ro)], -1)
        gates[r, unit] = four
    return gates


def _cell(acc, b_tc, c_prev, hidden):
    """The kernel's cell on the fragments (256, Hp): gates (64, Hp, 4)
    with the bias, h (64, Hp) fp32, 0 where a 4-unit group has no real
    unit, and c."""
    hp = acc.shape[1]
    gates = _gates(acc) + b_tc
    c = c_prev * (0.5 * torch.tanh(gates[..., 2] + 0.5 * FORGET_BIAS) + 0.5)
    c = c + (0.5 * torch.tanh(gates[..., 0]) + 0.5) * torch.tanh(gates[..., 1])
    h = torch.tanh(c) * (0.5 * torch.tanh(gates[..., 3]) + 0.5)
    # groups with no real unit are skipped: h stays 0
    u = torch.arange(hp)
    group_start = u // (hp // 2) * (hp // 2) + u % (hp // 2) // 4 * 4
    return gates, torch.where(group_start < hidden, h, torch.zeros_like(h)), c


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


@pytest.mark.parametrize("hidden", [16, 18, 40, 100, 128])
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


@pytest.mark.parametrize("hidden", [112, 120, 128])
@pytest.mark.parametrize("layer", [0, 1])
def test_tc_split_step_is_the_one_block_step(hidden, layer):
    """Hp 112-128: K4, K5a and K5c split a layer-lane over a 2-CTA cluster,
    CTA r holding warpgroup r's gate columns ([kc][2Hp][8]) and computing
    its units from the full h_{t-1}; the two halves together are the
    one-block step, and match the reference."""
    in_dim = 7 if layer == 0 else hidden
    (w, b), rng = _layer(hidden + layer, in_dim, hidden)
    w_tc, b_tc = ops.tc_pack_layer(w, b, in_dim, hidden)
    hp, nx, _ = ops.tc_dims(in_dim, hidden)
    assert ops.tc_split(hidden) == 2
    for s in (0, 1):
        h_prev, x_t, c_prev = _operands(rng, in_dim, hidden, nx)
        one = _kernel_step(w_tc, b_tc, h_prev, x_t, c_prev, in_dim, hidden, s)
        two = _kernel_step(w_tc, b_tc, h_prev, x_t, c_prev, in_dim, hidden, s,
                           split=2)
        for a, b_ in zip(one, two):
            torch.testing.assert_close(b_, a, rtol=0, atol=1e-6)
        want_g, want_h = _reference_step(w, b, h_prev, x_t, c_prev, in_dim,
                                         hidden)
        torch.testing.assert_close(two[0][:, :hidden], want_g, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(two[1][:, :hidden], want_h, rtol=0,
                                   atol=1e-6)
        assert torch.equal(two[1][:, hidden:],
                           torch.zeros_like(two[1][:, hidden:]))


def _pregemm_layer(w_tc, b_tc, xs, in_dim, hidden, gate_store):
    """K5b's bf16 schedule for one layer-lane on 64 windows, as
    csrc/bilstm_mono_pregemm.cu addresses it. The projection: every step's
    x_t @ Wx (Wx: the packing's core columns after Wh's, a zero column
    after an odd count) into the gate buffer in fragment order, group p of
    thread tid at (p * 256 + tid) * 8, in gate_store's dtype. The
    recurrence: step t's fragments loaded back as the accumulator, the
    h-only chain (Wh's core columns) on top from t = 1, then bias and
    cell. Returns, per step, (gx decoded to (64, Hp, 4), h_{t-1} in bf16,
    c_{t-1}, gates, h)."""
    hp, nx, _ = ops.tc_dims(in_dim, hidden)
    nh = hp // 8
    cols = w_tc.reshape(-1, 4 * hp, 8)

    def even(w):
        if w.shape[0] % 2 == 0:
            return w
        return torch.cat([w, torch.zeros(1, 4 * hp, 8, dtype=w.dtype)])

    wx, wh = even(cols[nh:nh + nx]).reshape(-1), even(cols[:nh]).reshape(-1)
    zero = torch.zeros(COL, dtype=torch.bfloat16)
    buffer = []
    for x_t in xs:
        d = _product(lambda c, st: st[0] + c * COL if c < nx else st[1], wx,
                     hp, (nx + 1) // 2, 1, [_slot(x_t), zero])
        frag = _fragments(d, hp).reshape(ops.TC_THREADS, hp // 8, 8)
        stored = frag.transpose(0, 1).reshape(-1)
        buffer.append(stored.to(ops.seq_dtype(gate_store)))
    h = torch.zeros(ROWS, hp, dtype=torch.bfloat16)
    c = torch.zeros(ROWS, hp)
    steps = []
    for t, stored in enumerate(buffer):
        acc = stored.float().reshape(hp // 8, ops.TC_THREADS, 8).transpose(
            0, 1).reshape(ops.TC_THREADS, hp)
        gx = _gates(acc)
        if t > 0:
            d = _product(lambda cc, st: st[0] + cc * COL if cc < nh else st[1],
                         wh, hp, (nh + 1) // 2, 1, [_slot(h), zero])
            acc = acc + _fragments(d, hp)
        gates, h_new, c_new = _cell(acc, b_tc, c, hidden)
        steps.append((gx, h, c, gates, h_new))
        h, c = h_new.bfloat16(), c_new
    return steps


@pytest.mark.parametrize("gate_store", ["fp32", "bf16"])
@pytest.mark.parametrize("hidden", [16, 100, 128])
@pytest.mark.parametrize("layer", [0, 1])
def test_pregemm_replay_matches_run_lane(hidden, layer, gate_store):
    """K5b bf16 over 3 steps: the gate buffer holds each step's projection
    (fp32: within 1e-6 of ``_run_lane``'s x @ Wx; bf16: that sum rounded,
    within a rounding step of ``_run_lane``'s rounded value, the two sums
    differing in order), each step's
    gates and h are gx + h @ Wh + b from the buffer within 1e-6, and the h
    sequence is ``_run_lane(..., gate_store)``'s at the bf16 tolerance (a
    1-ulp rounding flip of a stored value propagates)."""
    in_dim = 7 if layer == 0 else hidden
    (w, b), rng = _layer(3 * hidden + layer, in_dim, hidden)
    w_tc, b_tc = ops.tc_pack_layer(w, b, in_dim, hidden)
    hp, nx, _ = ops.tc_dims(in_dim, hidden)
    xs = [_operands(rng, in_dim, hidden, nx)[1] for _ in range(3)]
    steps = _pregemm_layer(w_tc, b_tc, xs, in_dim, hidden, gate_store)
    want = ops._run_lane([x[:, :in_dim] for x in xs], w, b, FORGET_BIAS,
                         "bf16", gate_store)
    w_x, w_h = w[:in_dim].float(), w[in_dim:].float()

    def by_unit(m):  # (64, 4H) gate-major -> (64, H, 4)
        return m.reshape(ROWS, 4, hidden).transpose(1, 2)

    sig = lambda v: 0.5 * torch.tanh(v) + 0.5  # noqa: E731
    for t, (gx, h_prev, c_prev, gates, h) in enumerate(steps):
        ref_gx = by_unit(xs[t][:, :in_dim].float() @ w_x)
        if gate_store == "fp32":
            torch.testing.assert_close(gx[:, :hidden], ref_gx, rtol=0,
                                       atol=1e-6)
        else:
            # the two fp32 sums (1e-6 apart at most) round to bf16 values
            # at most a rounding step apart; most round alike
            ulp = torch.exp2(torch.floor(torch.log2(ref_gx.abs())) - 7)
            diff = (gx[:, :hidden] - ref_gx.bfloat16().float()).abs()
            assert bool((diff <= 2 * ulp + 1e-6).all())
            assert float((diff == 0).float().mean()) > 0.99
        assert torch.equal(gx[:, hidden:], torch.zeros_like(gx[:, hidden:]))
        ref_g = (gx[:, :hidden] + by_unit(h_prev[:, :hidden].float() @ w_h)
                 + by_unit(b.expand(ROWS, -1)))
        torch.testing.assert_close(gates[:, :hidden], ref_g, rtol=0,
                                   atol=1e-6)
        i, j, f, o = ref_g.unbind(-1)
        ref_c = (c_prev[:, :hidden] * sig(f + 0.5 * FORGET_BIAS)
                 + sig(i) * torch.tanh(j))
        torch.testing.assert_close(h[:, :hidden], torch.tanh(ref_c) * sig(o),
                                   rtol=0, atol=1e-6)
        assert torch.equal(h[:, hidden:], torch.zeros_like(h[:, hidden:]))
        torch.testing.assert_close(h[:, :hidden].bfloat16().float(),
                                   want[t].float(), rtol=2e-2, atol=2e-3)


def _zero_params(cfg):
    return {lane: [{"kernel": torch.zeros(
        (cfg.num_input if layer == 0 else cfg.num_hidden) + cfg.num_hidden,
        4 * cfg.num_hidden), "bias": torch.zeros(4 * cfg.num_hidden)}
        for layer in range(cfg.num_layers)] for lane in ("fw", "bw")}


@pytest.mark.parametrize("hidden,split,smem", [
    (100, 1, {"merged": 228992, "pregemm": 149120}),
    (104, 1, {"merged": 228992, "pregemm": 149120}),
    (112, 2, {"merged": 160512, "pregemm": 160512}),
    (120, 2, {"merged": 179584, "pregemm": 187264}),
    (128, 2, {"merged": 199680, "pregemm": 199680}),
])
def test_tc_cta_fits_shared_memory(hidden, split, smem):
    """One CTA of every tensor-core kernel fits a block's 232,448 B at
    every padded width up to 128: K4, K5a and K5c hold [Wh; Wx] (their half
    in a split, 128 threads), K5b one of them at a time (256 threads)."""
    cfg = BiLSTMConfig(num_hidden=hidden)  # F=7, 3 layers
    assert ops.tc_split(hidden) == split
    assert ops.tc_smem(cfg) == smem["merged"] <= ops.MAX_SMEM
    assert ops.tc_smem(cfg, "pregemm") == smem["pregemm"] <= ops.MAX_SMEM
    for schedule in ("merged", "pregemm", "wavefront"):
        threads, most, got = ops.mono_block(cfg, schedule, 64, "bf16")
        assert got == smem["pregemm" if schedule == "pregemm" else "merged"]
        assert threads == most == (256 if schedule == "pregemm"
                                   else 256 // split)
    assert ops.tc_threads("layered", hidden) == 256 // split


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
    # hidden 105-128 (Hp 112-128, the 2-CTA split) are taken, as JAX's
    # fused kernels take them; 136 is refused with the limit named
    for hidden in (112, 128):
        wide = BiLSTMConfig(num_hidden=hidden, num_layers=2)
        ops._check_tc(ops.pack_bilstm_params(_zero_params(wide), wide,
                                             "bf16"), wide, 64)
    too_wide = BiLSTMConfig(num_hidden=136, num_layers=1)
    with pytest.raises(ValueError, match="hidden <= 128"):
        ops._check_tc(ops.pack_bilstm_params(_zero_params(too_wide),
                                             too_wide, "bf16"), too_wide, 64)
    for kernel in ("mono", "merged", "pregemm", "wavefront", "layered"):
        assert ops.tensor_core(kernel, "bf16")
        assert not ops.tensor_core(kernel, "fp32")
        assert ops.SCHEDULE_TILE_B[kernel]["bf16"] == 64
    assert ops.SCHEDULE_TILE_B["layered"] == {"fp32": 40, "bf16": 64}
    assert ops.SCHEDULE_TILE_B["mono"] == {"fp32": 40, "bf16": 64}
    # K1 in bf16 reads the CUDA-core default tile as the tensor-core tile
    assert ops._mono_tile(ops.TILE_B, "bf16") == 64
    assert ops._mono_tile(None, "bf16") == 64
    assert ops._mono_tile(16, "bf16") == 16  # and refuses it at launch
    assert ops._mono_tile(ops.TILE_B, "fp32") == ops.TILE_B


# ------------------------------------------------ K1 bf16: the two-dot step

def _k1_chains(in_dim, hidden):
    """K1 bf16's two chains a step (csrc/bilstm_fused.cu::run_layer_k1)
    over the ``tc_pack_layer`` weights: (k-tiles of the h chain, the
    packed core column at which the x chain starts, k-tiles of the x
    chain). The h chain pairs an odd last h column with the zero column;
    the x chain starts at Wh's last even column (paired with the zero
    column where Hp/8 is odd) and ends on a zero column where its count
    is odd."""
    hp, _, nk = ops.tc_dims(in_dim, hidden)
    nh = hp // 8
    cb = nh - nh % 2
    return (nh + 1) // 2, cb, nk - cb // 2


def _k1_chain(w_tc, hp, split, a_bufs, a_cols, start_col, nk):
    """One chain of K1 bf16 (csrc/bilstm_fused.cu::run_layer_k1) for every
    warpgroup: (2, 64, 2Hp), B from packed core column ``start_col`` on
    (split 2: CTA r holds warpgroup r's gate columns)."""
    starts, at = [], 0
    for buf in a_bufs:
        starts.append(at)
        at += buf.numel()
    n_cta = 4 * hp // split
    d = torch.zeros(2, ROWS, 2 * hp)
    for cta in range(split):
        w_cta = w_tc.reshape(-1, 4 * hp, 8)[:, cta * n_cta:(cta + 1) * n_cta]
        mem = torch.cat([*(b.reshape(-1) for b in a_bufs),
                         w_cta.reshape(-1)]).float()
        w_lbo = n_cta * 8
        for local, wg in enumerate(range(2) if split == 1 else [cta]):
            w_base = at + local * (2 * hp // 8) * 64 + start_col * w_lbo
            for j in range(nk):
                c0, c1 = a_cols(2 * j, starts), a_cols(2 * j + 1, starts)
                a = _read(mem, c0, c1 - c0, 64, ROWS)
                b = _read(mem, w_base + 2 * j * w_lbo, w_lbo, 64, 2 * hp)
                d[wg] += a @ b.t()
    return d


def _k1_layer(w_tc, b_tc, xs, in_dim, hidden, split):
    """K1 bf16's two-dot step for one layer-lane over the steps ``xs``
    (each (64, 8*nx) bf16): the x chain (the x k-tile list: from Wh's last
    even core column, the zero column before x and after it) overwrites
    the accumulator, the h chain (the h k-tile list, an odd last column
    paired with the zero column) adds to it, then the cell. Buffers in the
    kernel's address order: h ring, zero column, x ring, zero column.
    Returns per step (h_{t-1}, c_{t-1}, gates, h)."""
    hp, nx, _ = ops.tc_dims(in_dim, hidden)
    nh = hp // 8
    kh, cb, kx = _k1_chains(in_dim, hidden)
    zero = torch.zeros(COL, dtype=torch.bfloat16)
    h_ring = torch.zeros(2, nh * COL, dtype=torch.bfloat16)
    x_ring = torch.zeros(2, nx * COL, dtype=torch.bfloat16)
    c = torch.zeros(ROWS, hp)
    h = torch.zeros(ROWS, hp, dtype=torch.bfloat16)
    out = []
    for t, x_t in enumerate(xs):
        s = t & 1
        h_ring[s ^ 1] = _slot(h)
        x_ring[s] = _slot(x_t)

        def x_cols(p, st):
            cc = cb + p
            if cc < nh:
                return st[1]
            if cc < nh + nx:
                return st[2] + s * nx * COL + (cc - nh) * COL
            return st[3]

        def h_cols(cc, st):
            return st[0] + (s ^ 1) * nh * COL + cc * COL if cc < nh else st[1]

        bufs = [h_ring, zero, x_ring, zero]
        acc = _k1_chain(w_tc, hp, split, bufs, x_cols, cb, kx)
        acc = acc + _k1_chain(w_tc, hp, split, bufs, h_cols, 0, kh)
        gates, h_new, c_new = _cell(_fragments(acc, hp), b_tc, c, hidden)
        out.append((h, c, gates, h_new))
        h, c = h_new.bfloat16(), c_new
    return out


@pytest.mark.parametrize("hidden", [8, 16, 100, 128])
@pytest.mark.parametrize("layer,fnum", [(0, 7), (0, 57), (1, None)])
def test_k1_two_dot_step_matches_run_lane(hidden, layer, fnum):
    """K1 bf16 over 3 steps: the x k-tile list then the h k-tile list give
    ``_run_lane``'s gates and h at every step within 1e-6 (fp32 sums of
    the same bf16 operands in another order); padded units stay exactly
    0, and the h sequence is ``_run_lane``'s at the bf16 tolerance. Hidden
    128 replays the 2-CTA split's weight layout."""
    in_dim = fnum if layer == 0 else hidden
    (w, b), rng = _layer(5 * hidden + in_dim, in_dim, hidden)
    w_tc, b_tc = ops.tc_pack_layer(w, b, in_dim, hidden)
    hp, nx, nk = ops.tc_dims(in_dim, hidden)
    kh, cb, kx = _k1_chains(in_dim, hidden)
    # one k-tile more than K5a's merged chain where Hp/8 is odd
    assert kh + kx == nk + (hp // 8) % 2
    xs = [_operands(rng, in_dim, hidden, nx)[1] for _ in range(3)]
    steps = _k1_layer(w_tc, b_tc, xs, in_dim, hidden, ops.tc_split(hidden))
    want = ops._run_lane([x[:, :in_dim] for x in xs], w, b, FORGET_BIAS,
                         "bf16")
    for t, (h_prev, c_prev, gates, h) in enumerate(steps):
        want_g, want_h = _reference_step(w, b, h_prev, xs[t], c_prev, in_dim,
                                         hidden)
        torch.testing.assert_close(gates[:, :hidden], want_g, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(h[:, :hidden], want_h, rtol=0, atol=1e-6)
        assert torch.equal(h[:, hidden:], torch.zeros_like(h[:, hidden:]))
        torch.testing.assert_close(h[:, :hidden].bfloat16().float(),
                                   want[t].float(), rtol=2e-2, atol=2e-3)


def test_k1_chains_cover_the_packed_columns_once():
    """At every Hp from 8 to 128 and F = 7, 57 and Hp (a later layer), the
    h chain's core columns (Wh's, an odd last one beside the zero column)
    and the x chain's (from Wh's last even column) cover each packed core
    column of the layer's weights once with a non-zero A column; at Hp 104
    the chains are 7 + 1 k-tiles at layer 0 (F=7) and 7 + 7 after it."""
    for hp in range(8, ops.TC_MAX_HP + 1, 8):
        for in_dim in (7, 57, hp):
            _, nx, nk = ops.tc_dims(in_dim, hp)
            nh = hp // 8
            kh, cb, kx = _k1_chains(in_dim, hp)
            used = torch.zeros(2 * nk, dtype=torch.int64)
            for c in range(2 * kh):  # the h chain: A is h or the zero column
                if c < nh:
                    used[c] += 1
            for p in range(2 * kx):  # the x chain: zero, x, zero
                c = cb + p
                if nh <= c < nh + nx:
                    used[c] += 1
            assert cb + 2 * kx <= 2 * nk + 1
            assert torch.equal(used[:nh + nx],
                               torch.ones(nh + nx, dtype=torch.int64))
    assert _k1_chains(7, 100) == (7, 12, 1)
    assert _k1_chains(100, 100) == (7, 12, 7)


@pytest.mark.parametrize("fnum", [7, 57])
def test_k1_cta_fits_shared_memory(fnum):
    """K1 bf16's CTA (K5a's buffers plus a second zero column) fits a
    block's 232,448 B at every Hp from 8 to 128, 256 threads up to Hp 104
    and 128 in a 2-CTA split beyond."""
    for hp in range(8, ops.TC_MAX_HP + 1, 8):
        cfg = BiLSTMConfig(num_input=fnum, num_hidden=hp)
        threads, most, smem = ops.mono_block(cfg, "mono", 64, "bf16")
        assert smem == ops.tc_smem(cfg) + ROWS * 8 * 2 <= ops.MAX_SMEM, hp
        assert threads == most == 256 // ops.tc_split(hp)
    assert ops.tc_smem(BiLSTMConfig(num_hidden=100), "mono") == 230016


def test_stamp_tool_patches_the_current_sources():
    """``tools/stamp_steps`` finds each of its anchors once in today's K1
    and K3 sources, so the step-time probe runs on the kernels as they
    are."""
    import os

    from deepmod_tpu_torch.tools import stamp_steps

    csrc = os.path.join(os.path.dirname(ops.__file__), "..", "csrc")
    for kernel, spec in stamp_steps.KERNELS.items():
        with open(os.path.join(csrc, spec[0])) as fh:
            text = fh.read()
        patched = stamp_steps.patch(kernel, text)
        assert patched.count("clock64()") == len(spec[5]) + text.count(
            "clock64()")
        assert "dmt_read_stamps" in patched
