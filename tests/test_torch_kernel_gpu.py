"""The CUDA kernels (K1; K2 and K3; K4; K5a-c; K6; P1) against their
plain versions, on the card. In bf16, K1, K4 and K5a-c are the
tensor-core kernels (``csrc/lstm_tc.cuh``, 64 windows a tile; hidden
105-128 over 2-CTA clusters in K1, K4, K5a and K5c, K5c a cluster of one
CTA a layer). In fp32, K1, K4 and K5a-c run the fp32 core
(``csrc/lstm_f32.cuh``, a layer's weights resident over a cluster of 1, 2
or 4 CTAs; K5b on a persistent grid; K5c a persistent grid of clusters of
a CTA group a layer), and K4 runs every T over the readout cone only; K2,
the training forward, and K6 run the same core's pieces.

Marked ``gpu``: each test skips (inside its fixture) where no CUDA GPU is
present. On a machine with a GPU and nvcc (the repo's conftest imports
JAX, which this file does not need):

    python -m pytest tests/test_torch_kernel_gpu.py --noconftest -q

Tolerances: fp32 2e-5 absolute (different summation order, accurate
expf/tanhf on both sides, TF32 off); bf16 atol 2e-3 + rtol 2e-2 (a 1-ulp
bf16 rounding flip of a stored h propagates).
"""

import numpy as np
import pytest
import torch

from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu_torch.ops import bilstm_fused as ops

pytestmark = pytest.mark.gpu

TOL = {"fp32": dict(rtol=0.0, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps,layers,hidden,batch", [
    (21, 3, 100, 1000),   # production shape, ragged last tile
    (5, 1, 16, 7),        # one partial tile
    (9, 2, 40, 129),
    (25, 3, 64, 64),      # longest T the kernel takes
])
def test_kernel_matches_plain(cuda, precision, timesteps, layers, hidden,
                              batch):
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps + layers, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    x = x.to(ops.seq_dtype(precision))
    before = ops.LAUNCHES[precision]
    got = ops.bilstm_center_features(params, x, cfg, precision)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[precision] == before + 1
    want = ops.bilstm_center_plain(params, x, cfg, precision)
    torch.testing.assert_close(got, want, **TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_kernel_reads_overlapping_window_view(cuda, precision):
    """The compact path's (rows-T+1, T, F) view of a (rows, F) block gives
    the same features as the materialized windows."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(3, cfg, device=cuda)
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, 7), dtype=np.float32)).to(cuda).to(ops.seq_dtype(precision))
    view = rows.as_strided((300 - 21 + 1, 21, 7), (7, 7, 1))
    got = ops.bilstm_center_features(params, view, cfg, precision)
    want = ops.bilstm_center_features(params, view.contiguous(), cfg,
                                      precision)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile_b", [8, 16, 40])
def test_kernel_tiles_agree(cuda, tile_b):
    """K1 fp32 on the fp32 core gives the same bits at every tile (each
    gate one thread's ordered fmaf chain, whatever the tile)."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(4, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (333, 21, 7), dtype=np.float32)).to(cuda)
    a = ops.bilstm_center_features(params, x, cfg, "fp32", tile_b=tile_b)
    b = ops.bilstm_center_features(params, x, cfg, "fp32")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K1 bf16 on the tensor cores: (T, F, hidden), every odd T to 25
K1_TC_CASES = [
    (1, 7, 8), (3, 57, 16), (5, 7, 24), (7, 57, 40), (9, 7, 56),
    (11, 57, 64), (13, 7, 72), (15, 57, 88), (17, 7, 96), (19, 57, 100),
    (21, 7, 100), (21, 57, 104), (23, 7, 112), (25, 57, 120), (21, 7, 128),
    (25, 7, 128),
]


@pytest.mark.parametrize("timesteps,fnum,hidden", K1_TC_CASES)
def test_k1_tc_matches_plain_and_k5a(cuda, timesteps, fnum, hidden):
    """K1 bf16 (the two-dot tensor-core kernel) against its plain version
    and against K5a bf16 on 333 random windows (a ragged last tile) and on
    the window view of a row block, read in place: atol 2e-3 + rtol
    2e-2."""
    cfg = BiLSTMConfig(num_input=fnum, num_hidden=hidden,
                       timesteps=timesteps)
    params = init_bilstm_params(timesteps + hidden, cfg, device=cuda)
    gen = np.random.default_rng(fnum + hidden)
    x = torch.from_numpy(gen.standard_normal(
        (333, timesteps, fnum), dtype=np.float32)).to(cuda).bfloat16()
    rows = torch.from_numpy(gen.standard_normal(
        (333 + timesteps - 1, fnum), dtype=np.float32)).to(cuda).bfloat16()
    view = rows.as_strided((333, timesteps, fnum), (fnum, fnum, 1))
    for inp in (x, view):
        before = ops.LAUNCHES["bf16"]
        got = ops.bilstm_center_features(params, inp, cfg, "bf16")
        torch.cuda.synchronize()
        assert ops.LAUNCHES["bf16"] == before + 1
        want = ops.bilstm_center_plain(params, inp, cfg, "bf16")
        torch.testing.assert_close(got, want, **TOL["bf16"])
        k5a = ops.bilstm_center_mono(params, inp, cfg, "bf16",
                                     merged_gemm=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, k5a, **TOL["bf16"])


@pytest.mark.parametrize("tile_b", [8, 16, 128])
def test_k1_tc_takes_tile_64_only(cuda, tile_b):
    """K1 bf16 runs 64 windows a tile; the default and the CUDA-core
    default TILE_B give 64, any other tile raises, and hidden over 128
    raises naming the limit (no fallback to another body)."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=16, num_layers=2)
    params = init_bilstm_params(0, cfg, device=cuda)
    x = torch.randn(70, 21, 7, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="tile_b=64"):
        ops.bilstm_center_features(params, x, cfg, "bf16", tile_b=tile_b)
    a = ops.bilstm_center_features(params, x, cfg, "bf16")
    b = ops.bilstm_center_features(params, x, cfg, "bf16", tile_b=ops.TILE_B)
    c = ops.bilstm_center_mono(params, x, cfg, "bf16", tile_b=64)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    wide = BiLSTMConfig(num_input=7, num_hidden=136, num_layers=1)
    with pytest.raises(ValueError, match="hidden <= 128"):
        ops.bilstm_center_features(init_bilstm_params(0, wide, device=cuda),
                                   x, wide, "bf16")


# ---------------------------------------------------------------- K4

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps,layers,hidden,batch", [
    (20, 3, 100, 1000),   # even T: all steps, readout at 10 and 9
    (31, 3, 100, 333),    # odd T past K1's range: the 16-step cone
    (64, 2, 16, 77),      # a long runtime step loop
    (20, 2, 64, 128),     # a multiple of 64 windows
    (22, 1, 40, 50),      # under one 64-window tile, the last layer first
])
def test_layered_kernel_matches_plain(cuda, precision, timesteps, layers,
                                      hidden, batch):
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    x = x.to(ops.seq_dtype(precision))
    before, k1 = ops.LAYERED_LAUNCHES[precision], dict(ops.LAUNCHES)
    got = ops.bilstm_center_features(params, x, cfg, precision)
    torch.cuda.synchronize()
    assert ops.LAYERED_LAUNCHES[precision] == before + layers
    assert ops.LAUNCHES == k1
    want = ops.bilstm_layered_plain(params, x, cfg, precision)
    torch.testing.assert_close(got, want, **TOL[precision])
    # the detect path's overlapping window view, read in place
    rows = x[:, 0].contiguous()
    view = rows.as_strided((batch - timesteps + 1, timesteps, 7), (7, 7, 1))
    a = ops.bilstm_center_features(params, view, cfg, precision)
    b = ops.bilstm_center_features(params, view.contiguous(), cfg, precision)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_layered_kernel_forced_at_t21_matches_k1(cuda, precision):
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(6, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (500, 21, 7), dtype=np.float32)).to(cuda).to(ops.seq_dtype(precision))
    k4 = ops.bilstm_center_features(params, x, cfg, precision, mono=False)
    k1 = ops.bilstm_center_features(params, x, cfg, precision)
    torch.cuda.synchronize()
    torch.testing.assert_close(k4, k1, **TOL[precision])


# ---------------------------------------------------------------- K5a-c

K5_FLAGS = {
    "merged": dict(merged_gemm=True),
    "pregemm": dict(pregemm=True),
    "pregemm_bf16_gates": dict(pregemm=True, gate_store="bf16"),
    "wavefront": dict(wavefront=True),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("label", list(K5_FLAGS))
@pytest.mark.parametrize("timesteps,layers,hidden,batch", [
    (21, 3, 100, 1000),   # production shape, ragged last tile
    (5, 1, 16, 7),        # one partial tile
    (9, 2, 40, 129),
    (13, 2, 64, 192),     # a multiple of 64 windows
])
def test_mono_schedule_matches_plain(cuda, label, precision, timesteps,
                                     layers, hidden, batch):
    """A bf16 gate store is held to the bf16 tolerance in both precisions
    (a 1-ulp flip of a rounded projection propagates)."""
    flags = K5_FLAGS[label]
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps + layers, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    x = x.to(ops.seq_dtype(precision))
    schedule = ops.mono_schedule(cfg, **flags)
    before, k1 = ops.MONO_SCHEDULE_LAUNCHES[schedule][precision], dict(ops.LAUNCHES)
    got = ops.bilstm_center_mono(params, x, cfg, precision, **flags)
    torch.cuda.synchronize()
    assert ops.MONO_SCHEDULE_LAUNCHES[schedule][precision] == before + 1
    assert ops.LAUNCHES == k1
    gates = flags.get("gate_store", "fp32")
    want = ops.bilstm_center_plain(params, x, cfg, precision, gate_store=gates)
    torch.testing.assert_close(
        got, want, **TOL["bf16" if gates == "bf16" else precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("label", list(K5_FLAGS))
def test_mono_schedule_reads_overlapping_window_view(cuda, label, precision):
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(8, cfg, device=cuda)
    rows = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (300, 7), dtype=np.float32)).to(cuda).to(ops.seq_dtype(precision))
    view = rows.as_strided((300 - 21 + 1, 21, 7), (7, 7, 1))
    flags = K5_FLAGS[label]
    got = ops.bilstm_center_mono(params, view, cfg, precision, **flags)
    want = ops.bilstm_center_mono(params, view.contiguous(), cfg, precision,
                                  **flags)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("label", list(K5_FLAGS))
def test_mono_schedule_tiles_agree(cuda, label):
    cfg = BiLSTMConfig(num_input=7, num_layers=2)
    params = init_bilstm_params(9, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (333, 21, 7), dtype=np.float32)).to(cuda)
    outs = [ops.bilstm_center_mono(params, x, cfg, "fp32", tile_b=t,
                                   **K5_FLAGS[label]) for t in (8, 16, 24)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_wavefront_matches_k1(cuda, precision, layers):
    """The one-barrier-a-step ring at every depth the schedule takes: the
    same features as K1's sequential schedule."""
    cfg = BiLSTMConfig(num_input=7, num_layers=layers)
    params = init_bilstm_params(10 + layers, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(layers).standard_normal(
        (777, 21, 7), dtype=np.float32)).to(cuda).to(ops.seq_dtype(precision))
    wave = ops.bilstm_center_mono(params, x, cfg, precision, wavefront=True)
    k1 = ops.bilstm_center_features(params, x, cfg, precision)
    torch.cuda.synchronize()
    torch.testing.assert_close(wave, k1, **TOL[precision])


@pytest.mark.parametrize("tile_b", [8, 24, 128])
def test_tensor_core_kernels_take_tile_64_only(cuda, tile_b):
    """K4 and K5a-c in bf16 run 64 windows a tile (the wgmma M) and refuse
    any other tile; the default is 64."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=16, num_layers=2)
    params = init_bilstm_params(0, cfg, device=cuda)
    x = torch.zeros(70, 21, 7, device=cuda, dtype=torch.bfloat16)
    for flags in (dict(merged_gemm=True), dict(pregemm=True),
                  dict(wavefront=True)):
        with pytest.raises(ValueError, match="tile_b=64"):
            ops.bilstm_center_mono(params, x, cfg, "bf16", tile_b=tile_b,
                                   **flags)
        ops.bilstm_center_mono(params, x, cfg, "bf16", **flags)
    with pytest.raises(ValueError, match="tile_b=64"):
        ops.bilstm_center_features(params, x, cfg, "bf16", tile_b=tile_b,
                                   mono=False)
    ops.bilstm_center_features(params, x, cfg, "bf16", mono=False)
    torch.cuda.synchronize()


# (label, flags, layers) of the bf16 tensor-core K5b and K5c cases
TC_SCHEDULES = [
    ("pregemm", dict(pregemm=True), 3),
    ("pregemm_bf16_gates", dict(pregemm=True, gate_store="bf16"), 3),
    ("wavefront_1", dict(wavefront=True), 1),
    ("wavefront_2", dict(wavefront=True), 2),
    ("wavefront_3", dict(wavefront=True), 3),
]


@pytest.mark.parametrize("hidden", [100, 128])
@pytest.mark.parametrize("timesteps", [5, 21, 25])
@pytest.mark.parametrize("label,flags,layers", TC_SCHEDULES,
                         ids=[c[0] for c in TC_SCHEDULES])
def test_tc_schedules_match_plain(cuda, label, flags, layers, timesteps,
                                  hidden):
    """bf16 K5b (persistent grid, both gate stores) and K5c (a cluster of
    one CTA a layer, two at hidden 128) against their plain versions on
    333 windows (a ragged last tile) and on the window view of a row
    block, read in place."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps + hidden, cfg, device=cuda)
    rows = torch.from_numpy(np.random.default_rng(hidden).standard_normal(
        (333 + timesteps - 1, 7), dtype=np.float32)).to(cuda).bfloat16()
    view = rows.as_strided((333, timesteps, 7), (7, 7, 1))
    x = torch.from_numpy(np.random.default_rng(timesteps).standard_normal(
        (333, timesteps, 7), dtype=np.float32)).to(cuda).bfloat16()
    schedule = ops.mono_schedule(cfg, **flags)
    gates = flags.get("gate_store", "fp32")
    for inp in (x, view):
        before = ops.MONO_SCHEDULE_LAUNCHES[schedule]["bf16"]
        got = ops.bilstm_center_mono(params, inp, cfg, "bf16", **flags)
        torch.cuda.synchronize()
        assert ops.MONO_SCHEDULE_LAUNCHES[schedule]["bf16"] == before + 1
        want = ops.bilstm_center_plain(params, inp, cfg, "bf16",
                                       gate_store=gates)
        torch.testing.assert_close(got, want, **TOL["bf16"])


# (label, flags) of fp32 K5a and K5b on the fp32 core
F32_SCHEDULES = [
    ("merged", dict(merged_gemm=True)),
    ("pregemm", dict(pregemm=True)),
    ("pregemm_bf16_gates", dict(pregemm=True, gate_store="bf16")),
]


@pytest.mark.parametrize("hidden", [100, 128])
@pytest.mark.parametrize("timesteps", [5, 21, 25])
@pytest.mark.parametrize("label,flags", F32_SCHEDULES,
                         ids=[c[0] for c in F32_SCHEDULES])
def test_f32_schedules_match_k1(cuda, label, flags, timesteps, hidden):
    """fp32 K5a (the merged operand ring) and K5b (persistent grid, fp32
    gates) on the fp32 core (2-CTA clusters at hidden 100, 4 at 128) give
    K1 fp32's bits on 333 windows (a ragged last tile) and on the window
    view of a row block, read in place; K5b with bf16 gates is within the
    bf16 tolerance of its plain version."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps)
    schedule = ops.mono_schedule(cfg, **flags)
    shape = ops.f32_schedule_shape(7, hidden, schedule)
    assert shape.split == (2 if hidden == 100 else 4)
    params = init_bilstm_params(timesteps + hidden, cfg, device=cuda)
    rows = torch.from_numpy(np.random.default_rng(hidden).standard_normal(
        (333 + timesteps - 1, 7), dtype=np.float32)).to(cuda)
    view = rows.as_strided((333, timesteps, 7), (7, 7, 1))
    x = torch.from_numpy(np.random.default_rng(timesteps).standard_normal(
        (333, timesteps, 7), dtype=np.float32)).to(cuda)
    gates = flags.get("gate_store", "fp32")
    for inp in (x, view):
        before = ops.MONO_SCHEDULE_LAUNCHES[schedule]["fp32"]
        got = ops.bilstm_center_mono(params, inp, cfg, "fp32", **flags)
        torch.cuda.synchronize()
        assert ops.MONO_SCHEDULE_LAUNCHES[schedule]["fp32"] == before + 1
        if gates == "bf16":
            want = ops.bilstm_center_plain(params, inp, cfg, "fp32",
                                           gate_store="bf16")
            torch.testing.assert_close(got, want, **TOL["bf16"])
        else:
            k1 = ops.bilstm_center_features(params, inp, cfg, "fp32")
            torch.cuda.synchronize()
            assert torch.equal(got, k1)


@pytest.mark.parametrize("hidden", [100, 128])
def test_fp32_core_one_step_layers(cuda, hidden):
    """T=1: one step a layer, so the next layer's first read of the row
    workspace follows the previous layer's stores with no step barrier
    between (the core's prologue adds one in a cluster). K1 fp32 against
    its plain version, K5a-c (K5b with fp32 gates) K1's bits, 3 layers in
    2- and 4-CTA clusters (K5c: a step an item), on 1,001 windows."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=1)
    params = init_bilstm_params(hidden + 1, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(hidden).standard_normal(
        (1001, 1, 7), dtype=np.float32)).to(cuda)
    k1 = ops.bilstm_center_features(params, x, cfg, "fp32")
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k1, ops.bilstm_center_plain(params, x, cfg, "fp32"), **TOL["fp32"])
    for flags in (dict(merged_gemm=True), dict(pregemm=True),
                  dict(wavefront=True)):
        got = ops.bilstm_center_mono(params, x, cfg, "fp32", **flags)
        torch.cuda.synchronize()
        assert torch.equal(got, k1), flags


F32_SAME_BITS = F32_SCHEDULES[:2] + [("wavefront", dict(wavefront=True))]


@pytest.mark.parametrize("label,flags", F32_SAME_BITS,
                         ids=[c[0] for c in F32_SAME_BITS])
def test_f32_schedules_launches_agree(cuda, label, flags):
    """fp32 K5a-c (K5b with fp32 gates) give K1 fp32's bits at every tile
    of the fp32 core at H=100 (8 to 40 windows in 2-CTA clusters, 64 and
    80 in 4-CTA ones; K5c's clusters 3 times that), at F=57, and with more
    (tile, lane) items than K5b's persistent grid has slots (4,001
    windows: 202 items at tile 40)."""
    for fnum in (7, 57):
        cfg = BiLSTMConfig(num_input=fnum)
        params = init_bilstm_params(fnum, cfg, device=cuda)
        packed = ops.pack_bilstm_params(params, cfg, "fp32")
        x = torch.from_numpy(np.random.default_rng(fnum).standard_normal(
            (4001, 21, fnum), dtype=np.float32)).to(cuda)
        k1 = ops.bilstm_center_features(packed, x, cfg, "fp32")
        for tile in (8, 24, 40, 64, 80):
            got = ops.bilstm_center_mono(packed, x, cfg, "fp32", tile_b=tile,
                                         **flags)
            torch.cuda.synchronize()
            assert torch.equal(got, k1), (fnum, tile)
    shape = ops.f32_schedule_shape(7, 100, "pregemm")
    resident = ops.pregemm_f32_clusters(BiLSTMConfig(num_input=7), shape,
                                        "fp32", cuda)
    assert ops.f32_slots(4001, shape.tile, resident) < 202


@pytest.mark.parametrize("hidden", [112, 128])
@pytest.mark.parametrize("kernel,timesteps", [("merged", 21),
                                              ("layered", 20),
                                              ("layered", 31)])
def test_split_kernels_match_plain(cuda, kernel, timesteps, hidden):
    """bf16 K5a and K4 at hidden 112 and 128 (the 2-CTA split) against
    their plain versions on 333 windows and on the window view."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps)
    params = init_bilstm_params(timesteps + hidden, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(hidden).standard_normal(
        (333, timesteps, 7), dtype=np.float32)).to(cuda).bfloat16()
    rows = x[:, 0].contiguous()
    view = rows.as_strided((333 - timesteps + 1, timesteps, 7), (7, 7, 1))
    for inp in (x, view):
        if kernel == "merged":
            got = ops.bilstm_center_mono(params, inp, cfg, "bf16",
                                         merged_gemm=True)
            want = ops.bilstm_center_plain(params, inp, cfg, "bf16")
        else:
            got = ops.bilstm_center_features(params, inp, cfg, "bf16",
                                             mono=False)
            want = ops.bilstm_layered_plain(params, inp, cfg, "bf16")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL["bf16"])


def test_tc_kernels_refuse_hidden_over_128(cuda):
    cfg = BiLSTMConfig(num_input=7, num_hidden=136, num_layers=1)
    params = init_bilstm_params(0, cfg, device=cuda)
    x = torch.zeros(70, 21, 7, device=cuda, dtype=torch.bfloat16)
    for flags in (dict(merged_gemm=True), dict(pregemm=True),
                  dict(wavefront=True)):
        with pytest.raises(ValueError, match="hidden <= 128"):
            ops.bilstm_center_mono(params, x, cfg, "bf16", **flags)
    with pytest.raises(ValueError, match="hidden <= 128"):
        ops.bilstm_center_features(params, x, cfg, "bf16", mono=False)


def test_fp32_pregemm_and_wavefront_unchanged(cuda):
    """fp32 K5b (fp32 gates, the fp32 core on a persistent grid) and K5c
    (the fp32 core, a persistent grid of clusters of a CTA group a layer)
    give K1's bits."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(13, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1000, 21, 7), dtype=np.float32)).to(cuda)
    k1 = ops.bilstm_center_features(params, x, cfg, "fp32")
    k5b = ops.bilstm_center_mono(params, x, cfg, "fp32", pregemm=True)
    k5c = ops.bilstm_center_mono(params, x, cfg, "fp32", wavefront=True)
    torch.cuda.synchronize()
    assert torch.equal(k5b, k1)
    assert torch.equal(k5c, k1)


def test_fp32_merged_and_layered_unchanged(cuda):
    """K5a fp32 (the fp32 core's merged operand ring) gives the bits of
    K1 fp32 (the same fmaf chains), K4 fp32 (forced at T=21) K1's features
    within 2e-5."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(12, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1000, 21, 7), dtype=np.float32)).to(cuda)
    k1 = ops.bilstm_center_features(params, x, cfg, "fp32")
    k5a = ops.bilstm_center_mono(params, x, cfg, "fp32", merged_gemm=True)
    k4 = ops.bilstm_center_features(params, x, cfg, "fp32", mono=False)
    torch.cuda.synchronize()
    assert torch.equal(k5a, k1)
    torch.testing.assert_close(k4, k1, **TOL["fp32"])


# ---------------------------------------------------------------- the fp32 core

@pytest.mark.parametrize("hidden", [100, 128])
def test_k1_fp32_core_matches_plain_and_k5a(cuda, hidden):
    """K1 fp32 on the fp32 core (a 2-CTA cluster a tile-lane at H=100, 4
    at H=128) against its plain version (2e-5) and against K5a fp32 (the
    same fmaf chains: the same bits; the max abs is printed), on 1,001
    random windows (no multiple of the tile) and on the window view of a
    row block, read in place."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden)
    assert ops.f32_shape(7, hidden).split == (2 if hidden == 100 else 4)
    params = init_bilstm_params(hidden, cfg, device=cuda)
    gen = np.random.default_rng(hidden)
    x = torch.from_numpy(gen.standard_normal((1001, 21, 7),
                                             dtype=np.float32)).to(cuda)
    rows = torch.from_numpy(gen.standard_normal((1021, 7),
                                                dtype=np.float32)).to(cuda)
    view = rows.as_strided((1001, 21, 7), (7, 7, 1))
    for inp in (x, view):
        before = ops.LAUNCHES["fp32"]
        got = ops.bilstm_center_features(params, inp, cfg, "fp32")
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fp32"] == before + 1
        want = ops.bilstm_center_plain(params, inp, cfg, "fp32")
        torch.testing.assert_close(got, want, **TOL["fp32"])
        k5a = ops.bilstm_center_mono(params, inp, cfg, "fp32",
                                     merged_gemm=True)
        torch.cuda.synchronize()
        print(f"K1 fp32 vs K5a fp32, H={hidden}: max abs "
              f"{float((got - k5a).abs().max()):.3e}")
        assert torch.equal(got, k5a)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps", [20, 21, 22, 31, 64])
def test_layered_cone_at_hidden_128(cuda, precision, timesteps):
    """K4 at H=128 (fp32: the fp32 core's 4-CTA clusters; bf16: 2-CTA
    tensor-core clusters) over the readout cone, against the plain
    version, which runs all T at even T; T=21 forced (mono=False)."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=128, timesteps=timesteps,
                       num_layers=2 if timesteps == 64 else 3)
    params = init_bilstm_params(timesteps, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(timesteps).standard_normal(
        (300, timesteps, 7), dtype=np.float32)).to(cuda)
    x = x.to(ops.seq_dtype(precision))
    got = ops.bilstm_center_features(params, x, cfg, precision, mono=False)
    torch.cuda.synchronize()
    want = ops.bilstm_layered_plain(params, x, cfg, precision)
    torch.testing.assert_close(got, want, **TOL[precision])


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_fp32_core_launches_agree(cuda, kernel):
    """K1 and K4 fp32 give the same bits at every tile of the fp32 core
    at H=100: 8 to 40 windows in 2-CTA clusters, 64 and 80 in 4-CTA
    ones."""
    timesteps = 21 if kernel == "K1" else 20
    cfg = BiLSTMConfig(num_input=7, timesteps=timesteps)
    params = init_bilstm_params(5, cfg, device=cuda)
    packed = ops.pack_bilstm_params(params, cfg, "fp32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (777, timesteps, 7), dtype=np.float32)).to(cuda)
    assert [ops.f32_shape(7, 100, t).split for t in (8, 40, 64, 80)] == [
        2, 2, 4, 4]
    outs = [ops.bilstm_center_features(packed, x, cfg, "fp32", tile_b=tile,
                                       mono=kernel == "K1")
            for tile in (8, 24, ops.TILE_B, 64, 80)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_fp32_core_refuses_what_it_does_not_take(cuda):
    """Hidden over 128, or a tile that no launch takes, raises
    ``ValueError`` before any launch; nothing falls back."""
    wide = BiLSTMConfig(num_input=7, num_hidden=136, num_layers=1)
    x = torch.zeros(8, 21, 7, device=cuda)
    params = init_bilstm_params(0, wide, device=cuda)
    for mono in (None, False):
        with pytest.raises(ValueError, match="hidden <= 128"):
            ops.bilstm_center_features(params, x, wide, "fp32", mono=mono)
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(0, cfg, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.bilstm_center_features(params, x, cfg, "fp32", tile_b=12)
    with pytest.raises(ValueError, match="256 threads"):
        ops.bilstm_center_features(params, x, cfg, "fp32", tile_b=256)


def test_wavefront_rejects_too_many_threads(cuda):
    """fp32 K5c launches the fp32 core's CTAs: a tile that is not a
    multiple of 8, a CTA over 256 threads (100 units x 128/8 in any
    split) or 4 layers raise ``ValueError`` before any launch."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(0, cfg, device=cuda)
    x = torch.zeros(8, 21, 7, device=cuda)
    before = ops.MONO_SCHEDULE_LAUNCHES["wavefront"]["fp32"]
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.bilstm_center_mono(params, x, cfg, wavefront=True, tile_b=12)
    with pytest.raises(ValueError, match="256 threads"):
        ops.bilstm_center_mono(params, x, cfg, wavefront=True, tile_b=256)
    deep = BiLSTMConfig(num_input=7, num_layers=4)
    with pytest.raises(ValueError, match="num_layers <= 3"):
        ops.bilstm_center_mono(init_bilstm_params(0, deep, device=cuda), x,
                               deep, wavefront=True)
    assert ops.MONO_SCHEDULE_LAUNCHES["wavefront"]["fp32"] == before


@pytest.mark.parametrize("hidden", [100, 128])
@pytest.mark.parametrize("timesteps", [5, 21, 25])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_fp32_wavefront_gives_k1_bits(cuda, layers, timesteps, hidden):
    """fp32 K5c (the fp32 core, a CTA group a layer: clusters of 2 x
    layers CTAs at H=100, 4 x layers at H=128) gives K1 fp32's bits
    (``torch.equal``) on 333 windows and on the window view of a row
    block, streamed (the default grid; 2 clusters, one lane each; 3, whose
    middle run crosses from the fw lane to the bw lane and reloads its
    weights) and as a cluster a tile-lane."""
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps + hidden + layers, cfg,
                                device=cuda)
    packed = ops.pack_bilstm_params(params, cfg, "fp32")
    gen = np.random.default_rng(timesteps + layers)
    x = torch.from_numpy(gen.standard_normal((333, timesteps, 7),
                                             dtype=np.float32)).to(cuda)
    rows = torch.from_numpy(gen.standard_normal((333 + timesteps - 1, 7),
                                                dtype=np.float32)).to(cuda)
    view = rows.as_strided((333, timesteps, 7), (7, 7, 1))
    shape = ops.f32_schedule_shape(7, hidden, "wavefront")
    items = 2 * -(-333 // shape.tile)
    for inp in (x, view):
        k1 = ops.bilstm_center_features(packed, inp, cfg, "fp32")
        before = ops.MONO_SCHEDULE_LAUNCHES["wavefront"]["fp32"]
        wave = ops.bilstm_center_mono(packed, inp, cfg, "fp32",
                                      wavefront=True)
        grids = {slots: ops._launch_mono_f32(packed, inp, cfg, None,
                                             "wavefront", slots=slots)
                 for slots in (items, 2, 3)}
        torch.cuda.synchronize()
        assert ops.MONO_SCHEDULE_LAUNCHES["wavefront"]["fp32"] == before + 4
        assert torch.equal(wave, k1)
        for slots, got in grids.items():
            assert torch.equal(got, k1), slots


# ---------------------------------------------------------------- K6, P1

@pytest.mark.parametrize("hidden", [100, 128, 170])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_kernel_matches_plain(cuda, reverse, hidden):
    """K6 (W_h resident over a cluster: 2 CTAs at H=100 and 128, 4 at 170)
    within 1e-5 of its plain version on 1,001 windows (a ragged last
    tile), each launch split (1, 2, 4) at H=100 with the same bits."""
    from deepmod_tpu_torch.ops import lstm_layer as k6

    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden)
    lp = init_bilstm_params(7, cfg, device=cuda)["fw"][0]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1001, 21, 7), dtype=np.float32)).to(cuda)
    xp = k6.project(lp["kernel"], lp["bias"], x)
    w_h = lp["kernel"][7:].contiguous()
    before = k6.LAUNCHES["fp32"]
    got = k6.lstm_recurrence(xp, w_h, 1.0, reverse)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["fp32"] == before + 1
    want = k6.lstm_recurrence_plain(xp, w_h, 1.0, reverse)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if hidden == 100:
        wp = k6.pack_wh(w_h)
        for tile, split in ((16, 1), (40, 2), (64, 4)):
            shape = k6.lstm_layer_shape(hidden, tile, split)
            other = k6.recurrence_packed(xp, wp, 1.0, reverse, shape)
            torch.cuda.synchronize()
            assert torch.equal(other, got), (tile, split)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("op", ["tanh", "pade", "mul"])
def test_probe_kernel_matches_plain(cuda, op, precision):
    """fp32 rtol 1e-5; bf16 within one bf16 ulp of the value."""
    from deepmod_tpu_torch.tools import probe_transcendental as p1

    x = p1.probe_input(precision, cuda)
    got = p1.probe(x, op, 256).float()
    torch.cuda.synchronize()
    want = p1.probe_plain(x, op, 256).float()
    if precision == "fp32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
        assert bool(((got - want).abs() <= ulp).all())


# ---------------------------------------------------------------- K2 / K3

def _train_case(cuda, batch, timesteps, precision, seed):
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg = BiLSTMConfig(num_input=7, timesteps=timesteps)
    params = init_bilstm_params(seed, cfg, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for lane in ("fw", "bw"):
        for lp in params[lane]:
            lp["bias"] = (0.1 * torch.randn(lp["bias"].shape, generator=gen)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    steps, _, _ = tr.readout(timesteps)
    xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)), steps)
    return cfg, params, x, xin, tr.stack_lanes(params)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("batch,timesteps", [(2083, 21), (37, 8), (5, 5),
                                             (2048, 20)])
def test_train_kernels_match_plain(cuda, precision, batch, timesteps):
    """K2 (all layers) and K3 (each layer) against their plain versions.
    fp32: sequences 2e-5 absolute, gradients rtol 5e-4 / atol 5e-5 (a
    mean-scaled cotangent, as the trainer's masked mean gives); bf16:
    sequences atol 2e-3 + rtol 2e-2 (a 1-ulp flip of a stored bf16 value),
    the gradient tree within relative L2 1e-2 and cosine 0.9999."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, params, _, xin, weights = _train_case(cuda, batch, timesteps,
                                               precision, batch)
    fb = cfg.forget_bias
    before = dict(tr.LAUNCHES)
    hs, cs = tr.train_fwd(xin, weights, fb)
    torch.cuda.synchronize()
    assert tr.LAUNCHES[f"fwd_{precision}"] == before[f"fwd_{precision}"] + 1
    hs_p, cs_p = tr.train_fwd_plain(xin, weights, fb)
    seq_tol = TOL[precision]
    torch.testing.assert_close(hs.float(), hs_p.float(), **seq_tol)
    torch.testing.assert_close(cs.float(), cs_p.float(), **seq_tol)

    gen = torch.Generator(device="cpu").manual_seed(1)
    dh = (torch.randn(hs.shape[1:], generator=gen) / batch).to(cuda).to(hs.dtype)
    got, want = [], []
    for layer in range(cfg.num_layers):
        layer_in = xin if layer == 0 else hs[layer - 1]
        w, b = weights[layer]
        got += tr.train_bwd(layer_in, hs[layer], cs[layer], dh, w, b, fb)
        torch.cuda.synchronize()
        want += tr.train_bwd_plain(layer_in, hs[layer], cs[layer], dh, w, b, fb)
    assert tr.LAUNCHES[f"bwd_{precision}"] == (
        before[f"bwd_{precision}"] + cfg.num_layers)
    if precision == "fp32":
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
        return
    a = torch.cat([t.float().ravel() for t in got])
    b = torch.cat([t.float().ravel() for t in want])
    assert float((a - b).norm() / b.norm()) <= 1e-2
    assert float(a @ b / (a.norm() * b.norm())) >= 0.9999


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("batch,timesteps", [(2048, 21), (2048, 20),
                                             (37, 8)])
def test_train_fwd_at_hidden_128(cuda, precision, batch, timesteps):
    """K2 at hidden 128 (4-CTA clusters: ``fwd_shape``) against its plain
    version, odd T over the readout cone, even T all T steps; two runs
    give the same bits."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg = BiLSTMConfig(num_input=7, num_hidden=128, timesteps=timesteps)
    params = init_bilstm_params(batch + timesteps, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)),
                          tr.readout(timesteps)[0])
    weights = tr.stack_lanes(params)
    assert tr.fwd_shape(7, 128).split == 4
    hs, cs = tr.train_fwd(xin, weights, cfg.forget_bias)
    hs2, cs2 = tr.train_fwd(xin, weights, cfg.forget_bias)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    hs_p, cs_p = tr.train_fwd_plain(xin, weights, cfg.forget_bias)
    torch.testing.assert_close(hs.float(), hs_p.float(), **TOL[precision])
    torch.testing.assert_close(cs.float(), cs_p.float(), **TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_fwd_is_deterministic(cuda, precision):
    """Two K2 runs on the trainer's batch give the same bits."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, _, _, xin, weights = _train_case(cuda, 2048, 21, precision, 4)
    runs = [tr.train_fwd(xin, weights, cfg.forget_bias) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_fwd_shapes_agree(cuda, precision):
    """K2 at every tile and split it takes at H=100 gives the default
    launch's bits: each gate is one thread's ordered chain whatever the
    shape."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, _, _, xin, weights = _train_case(cuda, 301, 21, precision, 6)
    want = tr.train_fwd(xin, weights, cfg.forget_bias)
    for split, tile in ((2, 8), (2, 16), (2, 40), (4, 32), (4, 40), (4, 80)):
        got = tr.train_fwd(xin, weights, cfg.forget_bias, tile, split)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (split, tile)


def test_train_fwd_refuses_what_it_does_not_take(cuda):
    """Over hidden 128, fnum over hidden, a tile not a multiple of 8, a
    split of 3 or a CTA over 256 threads raise before any launch."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, _, _, xin, weights = _train_case(cuda, 64, 21, "fp32", 1)
    before = tr.LAUNCHES["fwd_fp32"]
    for tile, split in ((44, 2), (128, 2), (40, 3)):
        with pytest.raises(ValueError):
            tr.train_fwd(xin, weights, cfg.forget_bias, tile, split)
    wide = [(torch.zeros(2, 7 + 136, 544, device=cuda),
             torch.zeros(2, 544, device=cuda))]
    with pytest.raises(ValueError, match="hidden <= 128"):
        tr.train_fwd(xin, wide, cfg.forget_bias)
    assert tr.LAUNCHES["fwd_fp32"] == before


def test_train_bwd_is_deterministic(cuda):
    """No float atomics: two K3 runs on the same inputs give the same bits."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, _, _, xin, weights = _train_case(cuda, 2048, 21, "fp32", 3)
    hs, cs = tr.train_fwd(xin, weights, cfg.forget_bias)
    dh = torch.randn_like(hs[0]) / 2048
    runs = [tr.train_bwd(hs[1], hs[2], cs[2], dh, *weights[2], cfg.forget_bias)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_function_cuda_matches_cpu(cuda, precision):
    """The autograd Function on the card (K2/K3) against itself on the CPU
    (the plain versions), features and every gradient."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg, params, x, _, _ = _train_case(cuda, 300, 21, precision, 5)

    def run(dev):
        p = {lane: [{k: v.detach().to(dev).requires_grad_(True)
                     for k, v in lp.items()} for lp in params[lane]]
             for lane in ("fw", "bw")}
        xx = x.detach().to(dev).requires_grad_(True)
        f = tr.bilstm_center_train(p, xx, cfg, precision).float()
        loss = (0.5 * (f * f).sum() + f.sum()) / len(f)
        leaves = tr._lstm_leaves(p) + [xx]
        return f.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    f_gpu, g_gpu = run(cuda)
    f_cpu, g_cpu = run("cpu")
    torch.testing.assert_close(f_gpu, f_cpu, **TOL[precision])
    if precision == "fp32":
        for a, b in zip(g_gpu, g_cpu):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
    else:
        a = torch.cat([t.ravel() for t in g_gpu[:-1]])
        b = torch.cat([t.ravel() for t in g_cpu[:-1]])
        assert float((a - b).norm() / b.norm()) <= 1e-2


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("fnum,hidden", [(57, 100), (7, 128), (57, 128)])
def test_train_bwd_wide_matches_plain(cuda, precision, fnum, hidden):
    """K3 at F=57 and at hidden 128 (Wh^T read from the global copy, past
    the 105 units whose Wh^T fits shared memory) against its plain version
    on 2,083 windows, at the tolerances above; two runs give the same
    bits."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    cfg = BiLSTMConfig(num_input=fnum, num_hidden=hidden, timesteps=21)
    params = init_bilstm_params(hidden + fnum, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(hidden).standard_normal(
        (2083, 21, fnum), dtype=np.float32)).to(cuda)
    steps = tr.readout(21)[0]
    xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)), steps)
    weights = tr.stack_lanes(params)
    hs, cs = tr.train_fwd(xin, weights, cfg.forget_bias)
    gen = torch.Generator(device="cpu").manual_seed(2)
    dh = (torch.randn(hs.shape[1:], generator=gen) / 2083).to(cuda).to(hs.dtype)
    got, want = [], []
    for layer in range(cfg.num_layers):
        layer_in = xin if layer == 0 else hs[layer - 1]
        w, b = weights[layer]
        args = (layer_in, hs[layer], cs[layer], dh, w, b, cfg.forget_bias)
        run = tr.train_bwd(*args)
        again = tr.train_bwd(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(run, again))
        got += run
        want += tr.train_bwd_plain(*args)
    if precision == "fp32":
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
        return
    a = torch.cat([t.float().ravel() for t in got])
    b = torch.cat([t.float().ravel() for t in want])
    assert float((a - b).norm() / b.norm()) <= 1e-2
    assert float(a @ b / (a.norm() * b.norm())) >= 0.9999


def test_k1_tanh_sigmoid_variant(cuda):
    """K1 fp32 built with -DDMT_TANH_SIGMOID (tools/probe_sigmoid.py's
    variant) launches from its own build inside ``_build.variant`` and
    stays within the fp32 tolerance of the default build; outside the
    block the default build runs again, with the same bits as before."""
    from deepmod_tpu_torch.ops import _build

    cfg = BiLSTMConfig(num_input=7, num_hidden=100, timesteps=21)
    params = init_bilstm_params(3, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1000, 21, 7), dtype=np.float32)).to(cuda)
    want = ops.bilstm_center_mono(params, x, cfg, "fp32")
    with _build.variant(_build.TANH_SIGMOID) as lib:
        assert _build.library() is lib
        got = ops.bilstm_center_mono(params, x, cfg, "fp32")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL["fp32"])
    assert torch.equal(ops.bilstm_center_mono(params, x, cfg, "fp32"), want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_compact_rows_cast_on_card_match_the_pack(cuda, precision):
    """Detect's compact transfer ships the caller's fp32 rows and casts
    them on the card: over two chunks of the 4,096-row bucket and a last
    one of the 780 rows left (no bucket's size, with buckets of 1,024 and
    4,096 rows), its predictions equal the packed transfer's of
    ``tools/probe_compact_pack.py`` (the JAX package's one-hot pack: codes
    rebuilt through a LUT on the card, the rest cast on the host) and the
    materialized windows', bit for bit, and every chunk reaches K1 in the
    kernel's dtype."""
    from deepmod_tpu_torch.engine.detect import WindowPredictor
    from deepmod_tpu_torch.tools.probe_compact_pack import predict_packed

    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(12, cfg, device="cpu")  # both classes
    rng = np.random.default_rng(20)
    rows = 2 * 4096 + 740
    feats = np.zeros((rows, 7), np.float32)
    hot = rng.integers(0, 5, rows)  # 4: no base
    for b in range(4):
        feats[hot == b, b] = 1.0
    feats[:, 4:6] = rng.standard_normal((rows, 2)) * 2  # bf16 rounds them
    feats[:, 6] = rng.integers(1, 40, rows)
    centers = np.arange(10, rows - 10, dtype=np.int64)
    kw = dict(buckets=(1024, 4096), device=cuda, precision=precision)
    plain = WindowPredictor(params, cfg, compact_transfer=True, **kw)
    win = WindowPredictor(params, cfg, compact_transfer=False, **kw)
    fed = []
    real_fn = plain._fn

    def spy_fn(x):
        fed.append((x.dtype, x.device.type))
        return real_fn(x)

    plain._fn = spy_fn
    before = ops.LAUNCHES[precision]
    got = plain.predict_from_features(feats, centers)
    assert ops.LAUNCHES[precision] == before + 3
    assert fed == [(plain._dtype, "cuda")] * 3
    assert plain.transfer_bytes == 4 * 7 * (2 * 4096 + 780)
    want, moved = predict_packed(plain, feats, centers)
    assert moved < plain.transfer_bytes
    assert 0 < int(got.sum()) < len(got)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, win.predict_from_features(feats,
                                                                 centers))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_staging_on_card_matches_the_concatenated_array(cuda, precision,
                                                        shards):
    """Detect's compact path stages each chunk's rows from the reads' own
    blocks into a pinned buffer from PyTorch's caching host allocator.
    With buckets of 1,024 and 4,096 rows, ``_LOOKAHEAD`` chunks stay in
    flight and the allocator's buffers are handed out again many times
    over four batches; the predictions equal those of the concatenated
    array (``predict_from_features``) and of the materialized windows, bit
    for bit, on one stream and on two shards' streams of one card. A
    buffer rewritten before the copies that read it completed would
    change them."""
    from deepmod_tpu_torch.engine.detect import (
        WindowPredictor,
        predict_batch_windows,
    )
    from deepmod_tpu_torch.engine.host_worker import HostReadResult
    from deepmod_tpu_torch.engine.outputs import (
        FEATURE_PAD,
        build_batch_request,
    )

    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(12, cfg, device="cpu")  # both classes
    kw = dict(buckets=(1024, 4096), precision=precision,
              devices=[cuda] * shards)
    staged = WindowPredictor(params, cfg, compact_transfer=True, **kw)
    win = WindowPredictor(params, cfg, compact_transfer=False, **kw)
    stage, pinned = staged._stage, []

    def spy(*args):
        buf = stage(*args)
        pinned.append(buf.is_pinned())
        return buf

    staged._stage = spy
    rng = np.random.default_rng(22)
    for batch in range(4):
        reads = []
        for i, n in enumerate(rng.integers(50, 3000, 40)):
            rows = int(n) + 2 * FEATURE_PAD
            feats = np.zeros((rows, 7), np.float32)
            hot = rng.integers(0, 5, rows)  # 4: no base
            for b in range(4):
                feats[hot == b, b] = 1.0
            feats[:, 4:6] = rng.standard_normal((rows, 2)) * 2
            feats[:, 6] = rng.integers(1, 40, rows)
            reads.append(HostReadResult(
                read_id=f"r{i}", path="", rname="chr1", strand="+", pos0=0,
                base_map=None, left_clip=0, right_clip=0, first_match_pos=0,
                num_match=int(n), num_mismatch=0, num_insert=0, num_del=0,
                features=feats, n_aligned=int(n), chrom_length=0))
        got = predict_batch_windows(reads, staged)
        feats, centers, _, _ = build_batch_request(reads)
        assert len(got) == len(centers) and 0 < int(got.sum()) < len(got)
        np.testing.assert_array_equal(
            got, staged.predict_from_features(feats, centers),
            err_msg=f"batch {batch}")
        np.testing.assert_array_equal(
            got, win.predict_from_features(feats, centers),
            err_msg=f"batch {batch}")
    assert len(pinned) > 20 and all(pinned)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_trimmed_cfdna_batch_matches_the_untrimmed_route(cuda, precision):
    """A cfDNA-shaped batch of 1,000 reads (60-600 events, median ~170)
    through ``predict_batch_windows`` at the default buckets: each block
    trimmed to the rows its windows read, one chunk of those ~200,000
    rows (no bucket's size), K1 over every window they hold. Its
    predictions equal the untrimmed route's (the whole blocks
    concatenated, centers ``start + FEATURE_PAD + i``) on every asked
    window, and K1's center features of those windows equal, bit for bit,
    K1's over the untrimmed rows."""
    from deepmod_tpu_torch.engine.detect import (
        WindowPredictor,
        predict_batch_windows,
    )
    from deepmod_tpu_torch.engine.host_worker import HostReadResult
    from deepmod_tpu_torch.engine.outputs import FEATURE_PAD

    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(12, cfg, device="cpu")  # both classes
    pred = WindowPredictor(params, cfg, device=cuda, precision=precision)
    rng = np.random.default_rng(23)
    events = np.clip(np.exp(rng.normal(np.log(170), 0.35, 1000)), 60,
                     600).astype(int)
    reads = []
    for i, n in enumerate(events):
        rows = int(n) + 2 * FEATURE_PAD
        feats = np.zeros((rows, 7), np.float32)
        hot = rng.integers(0, 5, rows)  # 4: no base
        for b in range(4):
            feats[hot == b, b] = 1.0
        feats[:, 4:6] = rng.standard_normal((rows, 2)) * 2
        feats[:, 6] = rng.integers(1, 40, rows)
        reads.append(HostReadResult(
            read_id=f"r{i}", path="", rname="chr1", strand="+", pos0=0,
            base_map=None, left_clip=0, right_clip=0, first_match_pos=0,
            num_match=int(n), num_mismatch=0, num_insert=0, num_del=0,
            features=feats, n_aligned=int(n), chrom_length=0))
    model = pred._replicas[pred.device]
    seen, real_fn = [], pred._fn

    def spy_fn(x):
        seen.append(ops.bilstm_center_features(model, x, cfg, precision))
        return real_fn(x)

    pred._fn = spy_fn
    got = predict_batch_windows(reads, pred)
    pred._fn = real_fn
    trimmed = int(events.sum()) + 20 * len(events)
    assert trimmed not in pred.buckets and trimmed < pred.buckets[-1]
    assert [len(f) for f in seen] == [trimmed - 20]
    # each read's asked windows in the chunk: its events, from its start
    starts = np.cumsum(events + 20) - (events + 20)
    asked = np.concatenate([s + np.arange(n) for s, n in zip(starts, events)])
    whole = np.concatenate([r.features for r in reads])
    # an untrimmed block holds 2 * FEATURE_PAD - 20 rows more than its view
    pad_starts = starts + (2 * FEATURE_PAD - 20) * np.arange(len(events))
    centers = np.concatenate([s + FEATURE_PAD + np.arange(n)
                              for s, n in zip(pad_starts, events)])
    want = pred.predict_from_features(whole, centers)
    assert len(got) == len(asked) and 0 < int(got.sum()) < len(got)
    np.testing.assert_array_equal(got, want)
    rows = torch.from_numpy(whole).to(cuda).to(ops.seq_dtype(precision))
    view = rows.as_strided((len(whole) - 20, 21, 7), (7, 7, 1))
    untrimmed = ops.bilstm_center_features(model, view, cfg, precision)
    torch.cuda.synchronize()
    idx = torch.from_numpy(centers - 10).to(cuda)
    assert torch.equal(seen[0][torch.from_numpy(asked).to(cuda)],
                       untrimmed[idx])
