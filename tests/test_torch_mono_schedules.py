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
stores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu.ops.bilstm_fused import bilstm_fused_center_mono
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
