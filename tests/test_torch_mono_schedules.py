"""The port's mono schedules K5a-c (plain versions of the CUDA kernels,
through ``bilstm_center_mono``'s flags) against the JAX package's
``bilstm_fused_center_mono`` with the same flags, in interpret mode.

Inputs and weights come from one numpy seed and go through both packages
as numpy arrays. Tolerances: fp32 2e-5 absolute (the two sides sum the
gate products in different orders); bf16 atol 2e-3 + rtol 2e-2, the
tolerance between two bf16 schedules of the same contract (a 1-ulp
rounding flip of a stored bf16 value propagates). A bf16 gate store is
held to the bf16 tolerance in both precisions: its rounded projections
can flip by one ulp the same way. The JAX kernels run with ``tile_b=8``
on 17 windows: interpret mode costs seconds a call, so each of the eight
full-width calls runs once, in a module fixture; so do the three calls of
the hidden-128 case (bf16, 2 layers, 5 windows: K1 and K5b with both gate
stores). K5a-c in fp32 run the fp32 core: their launch shapes, K5b's
per-slot workspace, K5c's clusters, grid and ring slots, and the weight
rows they read are checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.bilstm_fused import LANE, _pad_weights, bilstm_fused_center_mono
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models.tf_import import params_from_numpy
from deepmod_tpu_torch.ops import bilstm_fused as tf_ops
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

TOL = {"fp32": dict(rtol=0, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-3)}
# (label, flags of both packages' mono function)
SCHEDULES = {
    "merged": dict(merged_gemm=True),
    "pregemm_f32_gates": dict(pregemm=True),
    "pregemm_bf16_gates": dict(pregemm=True, gate_store="bf16"),
    "wavefront": dict(wavefront=True),
}


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


def _case(timesteps=21, hidden=100, layers=3, batch=17, seed=0):
    kw = dict(num_input=7, num_hidden=hidden, timesteps=timesteps,
              num_layers=layers)
    jcfg, tcfg = jb.BiLSTMConfig(**kw), tb.BiLSTMConfig(**kw)
    tree = _numpy_params(seed, jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, timesteps, 7)).astype(np.float32)
    return jcfg, tcfg, tree, x


def _jax_mono(tree, x, cfg, precision, **flags):
    return np.asarray(bilstm_fused_center_mono(
        tree, jnp.asarray(x), num_layers=cfg.num_layers,
        num_hidden=cfg.num_hidden, timesteps=cfg.timesteps, tile_b=8,
        interpret=True, precision=precision, **flags))


@pytest.fixture(scope="module")
def full_width():
    """H=100, 3 layers, T=21, F=7, B=17; JAX's output for every schedule
    and precision, computed once."""
    jcfg, tcfg, tree, x = _case()
    want = {(label, precision): _jax_mono(tree, x, jcfg, precision, **flags)
            for label, flags in SCHEDULES.items()
            for precision in ("fp32", "bf16")}
    return tcfg, tree, x, want


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("label", list(SCHEDULES))
def test_schedule_matches_jax(full_width, label, precision):
    tcfg, tree, x, want = full_width
    flags = SCHEDULES[label]
    params = params_from_numpy(tree, "cpu")
    tf_ops.reset_launch_counts()
    got = tf_ops.bilstm_center_mono(params, torch.from_numpy(x), tcfg,
                                    precision, **flags).numpy()
    tol = TOL["bf16" if flags.get("gate_store") == "bf16" else precision]
    np.testing.assert_allclose(got, want[label, precision], **tol)
    # the plain version on a CPU tensor: no kernel launched
    assert not any(n for c in tf_ops.MONO_SCHEDULE_LAUNCHES.values()
                   for n in c.values())
    assert tf_ops.LAUNCHES == {"fp32": 0, "bf16": 0}


# (label, flags) of the hidden-128 case: K1's plain version and K5b's with
# both gate stores
WIDE_SCHEDULES = {
    "mono": {},
    "pregemm_f32_gates": dict(pregemm=True),
    "pregemm_bf16_gates": dict(pregemm=True, gate_store="bf16"),
}


@pytest.fixture(scope="module")
def hidden_128():
    """bf16 at hidden 128 (Hp 128, the widest the tensor-core kernels
    take; the JAX kernels' LANE), 2 layers, T=21, 5 windows; JAX's output
    for each of WIDE_SCHEDULES, computed once."""
    jcfg, tcfg, tree, x = _case(hidden=128, layers=2, batch=5, seed=6)
    want = {label: _jax_mono(tree, x, jcfg, "bf16", **flags)
            for label, flags in WIDE_SCHEDULES.items()}
    return tcfg, tree, x, want


@pytest.mark.parametrize("label", list(WIDE_SCHEDULES))
def test_hidden_128_matches_jax(hidden_128, label):
    tcfg, tree, x, want = hidden_128
    got = tf_ops.bilstm_center_mono(params_from_numpy(tree, "cpu"),
                                    torch.from_numpy(x), tcfg, "bf16",
                                    **WIDE_SCHEDULES[label]).numpy()
    np.testing.assert_allclose(got, want[label], **TOL["bf16"])


def test_wavefront_small_matches_jax():
    """T=5, 2 layers, H=16: the skew's start and drain dominate."""
    jcfg, tcfg, tree, x = _case(timesteps=5, hidden=16, layers=2, batch=9,
                                seed=3)
    want = _jax_mono(tree, x, jcfg, "fp32", wavefront=True)
    got = tf_ops.bilstm_center_mono(params_from_numpy(tree, "cpu"),
                                    torch.from_numpy(x), tcfg, "fp32",
                                    wavefront=True).numpy()
    np.testing.assert_allclose(got, want, **TOL["fp32"])


def test_schedule_plain_versions_and_precedence():
    """K5a and K5c are K1's function, and so is K5b with fp32 gates: the
    port's plain versions give the same bits. bf16 gates round each input
    projection; the flags take JAX's precedence."""
    _, tcfg, tree, x = _case(hidden=16, batch=5, seed=4)
    params = params_from_numpy(tree, "cpu")
    xt = torch.from_numpy(x)
    for precision in ("fp32", "bf16"):
        k1 = tf_ops.bilstm_center_features(params, xt, tcfg, precision)
        for flags in (dict(merged_gemm=True), dict(pregemm=True),
                      dict(wavefront=True, pregemm=True),
                      dict(merged_gemm=True, pregemm=True,
                           gate_store="bf16")):
            got = tf_ops.bilstm_center_mono(params, xt, tcfg, precision,
                                            **flags)
            assert torch.equal(got, k1), flags
        g16 = tf_ops.bilstm_center_mono(params, xt, tcfg, precision,
                                        pregemm=True, gate_store="bf16")
        assert not torch.equal(g16, k1)
        torch.testing.assert_close(g16, k1, **TOL["bf16"])
    assert tf_ops.mono_schedule(tcfg) == "mono"
    assert tf_ops.mono_schedule(tcfg, wavefront=True, pregemm=True) == "wavefront"
    assert tf_ops.mono_schedule(tcfg, merged_gemm=True, pregemm=True) == "merged"


@pytest.mark.parametrize("case,match", [
    (dict(timesteps=20), "odd T"),
    (dict(layers=4, flags=dict(wavefront=True)), "num_layers <= 3"),
    (dict(flags=dict(wavefront=True, merged_gemm=True)), "merged_gemm"),
    (dict(flags=dict(pregemm=True, gate_store="fp16")), "gate_store"),
])
def test_argument_checks(case, match):
    _, tcfg, tree, x = _case(timesteps=case.get("timesteps", 21), hidden=8,
                             layers=case.get("layers", 3), batch=2)
    with pytest.raises(ValueError, match=match):
        tf_ops.bilstm_center_mono(params_from_numpy(tree, "cpu"),
                                  torch.from_numpy(x), tcfg, "fp32",
                                  **case.get("flags", {}))


@pytest.mark.parametrize("tool", ["probe_mono", "probe_merged_gemm",
                                  "probe_pregemm"])
def test_probe_tool_runs_plain_versions(tool, capsys, monkeypatch):
    import importlib

    from deepmod_tpu_torch.tools import _mono_probe

    monkeypatch.setattr(_mono_probe, "ITERS", 1)
    monkeypatch.setattr(_mono_probe, "TILES", (8, 24))
    mod = importlib.import_module(f"deepmod_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu", "--batch", "32"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device: cpu")
    rows = lines[1:]
    assert rows and all("tile_b=" in r and "/s" in r for r in rows)
    # fp32 at both tiles (probe_mono and probe_merged_gemm: both kernels
    # too), the bf16 tensor-core kernels (K1, K4, K5a, K5b) at 64 only:
    # one line a kernel (probe_pregemm: one line a tile, its variants side
    # by side)
    assert len(rows) == (3 if tool == "probe_pregemm" else 6)
    assert sum("tile_b=64" in r for r in rows) == (
        1 if tool == "probe_pregemm" else 2)


# ------------------------------------------- K5a and K5b fp32: the fp32 core

@pytest.mark.parametrize("fnum", [7, 57])
@pytest.mark.parametrize("hidden", [16, 100, 128])
@pytest.mark.parametrize("schedule", ["merged", "pregemm", "wavefront"])
def test_f32_schedule_shapes(schedule, hidden, fnum):
    """fp32 K5a-c launch their CTAs as K1 fp32 does (``f32_shape``'s split,
    tile and threads), within the card's limits: K5a's operand ring and
    K5c's CTA of a layer take K1's bytes, K5b holds one of Wx and Wh at a
    time and takes fewer."""
    cfg = tb.BiLSTMConfig(num_input=fnum, num_hidden=hidden, timesteps=21)
    k1 = tf_ops.f32_shape(fnum, hidden)
    for tile in (None, 8, 24, 40):
        shape = tf_ops.f32_schedule_shape(fnum, hidden, schedule, tile)
        base = tf_ops.f32_shape(fnum, hidden, tile)
        assert (shape.split, shape.tile, shape.threads) == (
            base.split, base.tile, base.threads)
        assert shape.threads <= tf_ops.F32_MAX_THREADS
        assert shape.smem <= tf_ops.MAX_SMEM
        in_max = max(fnum, hidden)
        if schedule == "pregemm":
            assert shape.smem == tf_ops.f32_smem(in_max, hidden, shape.split,
                                                 shape.tile, w_rows=in_max)
            assert shape.smem < base.smem
        else:
            assert shape.smem == base.smem
    tile = tf_ops.SCHEDULE_TILE_B[schedule]["fp32"]
    threads, most, smem = tf_ops.mono_block(cfg, schedule, tile, "fp32")
    shape = tf_ops.f32_schedule_shape(fnum, hidden, schedule, tile)
    assert (threads, most, smem) == (shape.threads, tf_ops.F32_MAX_THREADS,
                                     shape.smem)
    assert shape.split == tf_ops.f32_shape(fnum, hidden, tile).split
    assert k1.split == (1 if hidden == 16 else 2 if hidden == 100 else 4)
    with pytest.raises(ValueError, match="hidden <= 128"):
        tf_ops.mono_block(tb.BiLSTMConfig(num_input=fnum, num_hidden=136),
                          schedule, tile, "fp32")


@pytest.mark.parametrize("gate_store", ["fp32", "bf16"])
def test_pregemm_f32_workspace_is_per_slot(gate_store):
    """fp32 K5b's workspaces are a function of the card's resident
    clusters, not of the batch: the same bytes at 262,144 and 4,194,304
    windows (the old layout, a gate region a block, took 9.2 GB and 148 GB
    there in fp32); a batch with fewer work items than slots takes fewer."""
    cfg = tb.BiLSTMConfig(num_input=7, num_hidden=100, timesteps=21)
    shape = tf_ops.f32_schedule_shape(7, 100, "pregemm")
    assert (shape.split, shape.tile) == (2, 40)
    resident = 66  # 2-CTA clusters on a 132-SM card, one CTA an SM
    got = {}
    for batch in (262144, 4194304):
        slots = tf_ops.f32_slots(batch, shape.tile, resident)
        assert slots == resident
        got[batch] = tf_ops.pregemm_f32_bytes(cfg, shape, slots, gate_store)
    assert got[262144] == got[4194304]
    size = 4 if gate_store == "fp32" else 2
    # per CTA [11][50][4][40] gate values; per slot [11][100][40] fp32 rows
    assert got[262144] == 66 * (2 * 11 * 50 * 4 * 40 * size + 11 * 100 * 40 * 4)
    old = 262144 * 2 * 11 * 400 * 4
    assert got[262144] * 100 < old
    small = tf_ops.f32_slots(100, shape.tile, resident)
    assert small == 6  # 3 tiles x 2 lanes
    assert tf_ops.pregemm_f32_bytes(cfg, shape, small, gate_store) < got[262144]


# ------------------------------------- K5c fp32: the streamed wavefront

@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("fnum", [7, 57])
@pytest.mark.parametrize("hidden", [16, 100, 128])
def test_wavefront_f32_cluster(hidden, fnum, layers):
    """fp32 K5c's cluster is a CTA group a layer of ``f32_shape``'s split:
    num_layers x split CTAs, 6 at H=100 and 12 at H=128 with 3 layers,
    never over the 16 an H100 places; each CTA K1's at the default tile."""
    cfg = tb.BiLSTMConfig(num_input=fnum, num_hidden=hidden, num_layers=layers)
    shape = tf_ops.f32_schedule_shape(fnum, hidden, "wavefront")
    assert shape == tf_ops.f32_shape(fnum, hidden)
    assert shape.tile == tf_ops.SCHEDULE_TILE_B["wavefront"]["fp32"]
    split = {16: 1, 100: 2, 128: 4}[hidden]
    assert shape.split == split
    assert layers * shape.split <= 16
    assert tf_ops.mono_block(cfg, "wavefront", shape.tile, "fp32") == (
        shape.threads, tf_ops.F32_MAX_THREADS, shape.smem)


@pytest.mark.parametrize("batch,tile,resident", [
    (262144, 40, 17), (262144, 40, 8), (333, 40, 17), (1000, 40, 1),
    (7, 8, 20), (80, 40, 3)])
def test_wavefront_f32_slots_run_every_item_once(batch, tile, resident):
    """``f32_slots``: the resident clusters, at most the (tile,
    lane) items; the kernel's split of the lane-major items (item i: lane
    i // tiles, tile i % tiles) into one contiguous run a cluster runs each
    item exactly once, the runs differ by at most one item, and a run
    crosses from one lane to the other at most once (one weight reload)."""
    slots = tf_ops.f32_slots(batch, tile, resident)
    tiles = -(-batch // tile)
    assert slots == min(2 * tiles, resident) >= 1
    seen, sizes = [], set()
    for slot in range(slots):
        first = 2 * tiles * slot // slots
        items = 2 * tiles * (slot + 1) // slots - first
        sizes.add(items)
        run = [(i // tiles, i % tiles) for i in range(first, first + items)]
        lanes = [lane for lane, _ in run]
        assert lanes == sorted(lanes)  # fw items, then bw ones
        seen += [2 * t + lane for lane, t in run]
    assert sorted(seen) == list(range(2 * tiles))
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def _wavefront_walk(layers, timesteps, items, slot_of):
    """The rings of one fp32 K5c cluster over ``items`` items, wavefront
    step by step as the kernel runs them: group L at step s runs q = s - L
    (item q // steps, step q % steps); it reads x slot ``slot_of(q, t)``
    (layer 0's own prefetch, or group L-1's h) and, from t = 1 on, h slot
    ``slot_of(q - 1, t - 1)``; it writes its h into its h slot and group
    L+1's x slot ``slot_of(q, t)``, and layer 0 prefetches step q + 1's x
    into ``slot_of(q + 1, ...)``. Asserts that no slot is written in the
    step that reads it and that every read sees the value it needs,
    written in the wavefront step before (behind its barrier). Returns the
    (item, layer) readouts in order."""
    steps = timesteps // 2 + 1
    work = items * steps
    h = [[None, None] for _ in range(layers)]
    x = [[None, None] for _ in range(layers)]
    x[0][slot_of(0, 0)] = (("x", 0, 0), -1)  # the prologue's x_0
    readouts = []
    for s in range(work + layers - 1):
        reads, writes = set(), []
        for layer in range(layers):
            q = s - layer
            if not 0 <= q < work:
                continue  # fill or drain: the barrier only
            j, t = divmod(q, steps)
            xs = slot_of(q, t)
            want = ("x", j, t) if layer == 0 else ("h", layer - 1, j, t)
            assert x[layer][xs] == (want, s - 1), (s, layer, x[layer][xs])
            reads.add(("x", layer, xs))
            if t > 0:
                hs = slot_of(q - 1, t - 1)
                assert h[layer][hs] == (("h", layer, j, t - 1), s - 1)
                reads.add(("h", layer, hs))
            value = ("h", layer, j, t)
            writes.append(("h", layer, slot_of(q, t), value))
            if layer + 1 < layers:
                writes.append(("x", layer + 1, slot_of(q, t), value))
            if layer == 0 and q + 1 < work:
                jn, tn = divmod(q + 1, steps)
                writes.append(("x", 0, slot_of(q + 1, tn), ("x", jn, tn)))
            if layer == layers - 1 and t == steps - 1:
                readouts.append((j, layer))
        written = {(kind, layer, slot) for kind, layer, slot, _ in writes}
        assert not reads & written, (s, reads & written)
        for kind, layer, slot, value in writes:  # the barrier
            (h if kind == "h" else x)[layer][slot] = (value, s)
    return readouts


@pytest.mark.parametrize("items", [1, 2, 3])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_wavefront_f32_ring_slots_across_items(layers, items):
    """The streamed wavefront's two-slot rings, at every odd T the mono
    schedules take (1-25) and 1-3 items a cluster: with the kernel's slots
    (q & 1, q counting the group's steps over its item stream) one cluster
    barrier a wavefront step is enough, across item boundaries too, and
    every item's readout comes out once, in order, in n * steps +
    num_layers - 1 wavefront steps. Slots by t & 1 instead fail as soon as
    an item follows another after an odd number of steps."""
    for timesteps in range(1, 26, 2):
        steps = timesteps // 2 + 1
        got = _wavefront_walk(layers, timesteps, items,
                              lambda q, t: q & 1)
        assert got == [(j, layers - 1) for j in range(items)]
        if items > 1 and steps % 2 == 1:
            with pytest.raises(AssertionError):
                _wavefront_walk(layers, timesteps, items, lambda q, t: t & 1)


@pytest.mark.parametrize("fnum,hidden", [(7, 100), (57, 100), (7, 128),
                                         (7, 16)])
def test_f32_pack_row_blocks_are_the_jax_weights(fnum, hidden):
    """The rows fp32 K5a and K5b read from ``f32_pack_layer`` (K5a: all
    in+H of [Wx; Wh]; K5b: the first ``in`` rows, Wx, in phase 1 and the
    next H, Wh, in phase 2), each CTA its unit range of the split,
    reassemble to the JAX kernels' W_x and W_h (``_pad_weights`` of the
    same numpy-seeded params, padding dropped), every layer and lane."""
    tcfg = tb.BiLSTMConfig(num_input=fnum, num_hidden=hidden, num_layers=2)
    jcfg = jb.BiLSTMConfig(num_input=fnum, num_hidden=hidden, num_layers=2)
    tree = _numpy_params(7, jcfg)
    split = tf_ops.f32_shape(fnum, hidden).split
    units = -(-hidden // split)
    hp4 = tf_ops.f32_units(hidden)
    packed = tf_ops.pack_bilstm_params(params_from_numpy(tree, "cpu"), tcfg,
                                       "fp32")
    flat = packed.f32_w.numpy()
    off = 0
    for layer in range(2):
        lin = fnum if layer == 0 else hidden
        for lane in ("fw", "bw"):
            block = flat[off:off + (lin + hidden) * hp4 * 4].reshape(
                lin + hidden, hp4, 4)
            off += (lin + hidden) * hp4 * 4
            wx, wh = (np.asarray(a) for a in _pad_weights(
                jnp.asarray(tree[lane][layer]["kernel"]), lin, hidden))
            for rows, want, n in ((block[:lin], wx, lin),
                                  (block[lin:], wh, hidden)):
                got = np.zeros((n, 4 * hidden), np.float32)
                for rank in range(split):
                    u0, u1 = rank * units, min(hidden, rank * units + units)
                    for g in range(4):
                        got[:, g * hidden + u0:g * hidden + u1] = (
                            rows[:, u0:u1, g])
                jax_w = np.concatenate(
                    [want[:n, g * LANE:g * LANE + hidden] for g in range(4)],
                    axis=1)
                np.testing.assert_array_equal(got, jax_w)
            # the padded units hold zeros
            assert not block[:, hidden:].any()
    assert off == flat.size


def test_time_fp32_schedules_tool_runs_plain_versions(capsys, monkeypatch):
    """``tools/time_fp32_schedules`` on the CPU: the plain versions of K1,
    K5a and K5b (both gate stores), one line with each time and whether
    the output holds K1's bits (the plain K5a and K5b with fp32 gates are
    K1's function; bf16 gates round the projections)."""
    import ast

    from deepmod_tpu_torch.tools import time_fp32_schedules as tool

    monkeypatch.setattr(tool, "REPS", 1)
    assert tool.main(["--device", "cpu", "--batch", "16", "--label", "A"]) == 0
    line = capsys.readouterr().out.strip()
    label, _, got = line.split(" ", 2)
    got = ast.literal_eval(got)
    assert label == "A"
    assert got["k5a"][1] and got["k5b"][1] and not got["k5b_bf16_gates"][1]
    assert set(got) == {"k1", "k5a", "k5b", "k5b_bf16_gates", "k5b_tile32",
                        "k5b_tile40"}
    assert all(v > 0 for v in (got["k1"], got["k5b_tile32"], got["k5a"][0]))
