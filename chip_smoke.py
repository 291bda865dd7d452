#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepmod_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit. Phases (any failure raises, and the script exits non-zero
without printing the result line):

1. the card's name and power limit;
2. build the CUDA kernels from the checkout's sources (nvcc, sm_90a);
3. the BiLSTM center kernel (K1) against its plain PyTorch version at
   full width (H=100, 3 layers, T=21, F=7) on 65,536 random windows and
   on the overlapping window view of a 262,144-row feature chunk (the
   shape detect gives it), in fp32 (max abs 2e-5) and bf16 (atol 2e-3 +
   rtol 2e-2, the tolerance of two bf16 schedules of the same contract);
4. kernel, plain and library (cuDNN nn.LSTM) times at 262,144 windows,
   beside the bound the card's peak rates set;
5. the training kernels K2 (forward with residuals, all layers) and K3
   (BPTT recurrence + weight-gradient product, per layer) against their
   plain versions at full width on 2,048 and 2,083 windows (a ragged last
   block), fp32 (sequences 2e-5 absolute; dx/dW/db rtol 5e-4 / atol 5e-5
   under a mean-scaled cotangent, as the trainer's masked mean gives) and
   bf16 storage (sequences atol 2e-3 + rtol 2e-2, one bf16 step at a
   rounding point; the gradient tree within relative L2 1e-2, cosine
   0.9999); K3 run twice must give the same bits;
6. K2, K3 and whole train-step times at 2,048 windows beside their plain
   versions, cuDNN nn.LSTM forward / backward and the bound, and a
   torch.profiler breakdown of the train step's device time by kernel;
7. detect end to end through the CLI over a synthetic pod5 + basecall BAM
   dataset (one 200 kb chromosome, 100 reads of 1.5-3 kb, no h5py) on the
   card at bf16 and fp32, with K1's launch counts read around those runs;
   the fp32 run's BEDs against a --device cpu run's, and the window-level
   predictions of the two devices, where every disagreement must be a
   near tie (|logit margin| below the two devices' logit difference);
8. train end to end through the CLI: getfeatures over a mod and a ctl
   pod5 + BAM dataset (same genome, a CG signal shift on mod only), one
   epoch of train on the card at fp32 and at bf16 with K2/K3's launch
   counts read around those runs, a --device cpu fp32 run whose params
   must end within relative L2 1e-3 of the card's, and detect on the card
   with the trained model.

Prints the ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): CUDA-core fp32 for the
# fp32 contract, dense bf16 tensor rate for bf16, HBM3 bandwidth
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
CHECK_B = 65536
TIME_B = 262144
TRAIN_B = 2048
TRAIN_READS = 12
SEED = 2024


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flops_per_window(cfg) -> int:
    """Multiply-adds x2 over both lanes, T//2+1 steps, all layers."""
    h, steps = cfg.num_hidden, cfg.timesteps // 2 + 1
    per_step = sum(
        2 * ((cfg.num_input if layer == 0 else h) + h) * 4 * h
        for layer in range(cfg.num_layers)
    )
    return 2 * steps * per_step


def bound_ms(cfg, batch: int, precision: str, weight_bytes: int) -> tuple:
    size = 4 if precision == "fp32" else 2
    nbytes = (batch * cfg.timesteps * cfg.num_input * size
              + batch * 2 * cfg.num_hidden * 4 + weight_bytes)
    t_ops = flops_per_window(cfg) * batch / PEAK_OPS[precision]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def cudnn_lstms(params, cfg, precision: str, device):
    """Two cuDNN nn.LSTM stacks (one per lane) holding the same weights:
    TF i,j,f,o columns mapped to torch's i,f,g,o rows, forget_bias folded
    into the f bias. A yardstick only; the port never calls it."""
    h = cfg.num_hidden
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    lstms = []
    for lane in ("fw", "bw"):
        lstm = torch.nn.LSTM(cfg.num_input, h, cfg.num_layers,
                             batch_first=True).to(device)
        with torch.no_grad():
            for layer, lp in enumerate(params[lane]):
                k, b = lp["kernel"], lp["bias"]
                in_dim = k.shape[0] - h
                i, j, f, o = k.split(h, dim=1)
                bi, bj, bf, bo = b.split(h)
                w = torch.cat([i, f, j, o], dim=1).t()
                getattr(lstm, f"weight_ih_l{layer}").copy_(w[:, :in_dim])
                getattr(lstm, f"weight_hh_l{layer}").copy_(w[:, in_dim:])
                getattr(lstm, f"bias_ih_l{layer}").copy_(
                    torch.cat([bi, bf + cfg.forget_bias, bj, bo]))
                getattr(lstm, f"bias_hh_l{layer}").zero_()
        lstm = lstm.to(dtype)
        lstm.flatten_parameters()
        lstms.append(lstm)
    return lstms


def cudnn_center(lstms, x, cfg):
    steps = cfg.timesteps // 2 + 1
    fw, _ = lstms[0](x[:, :steps])
    bw, _ = lstms[1](x.flip(1)[:, :steps])
    return torch.cat([fw[:, -1], bw[:, -1]], dim=1).float()


def phase_kernel(device) -> dict:
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BiLSTMConfig()
    params = init_bilstm_params(SEED, cfg, device=device)
    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal((TIME_B, cfg.timesteps, cfg.num_input),
                               dtype=np.float32)
    x_all = torch.from_numpy(x_np).to(device)
    results = {}
    for precision in ("fp32", "bf16"):
        dt = ops.seq_dtype(precision)
        packed = ops.pack_bilstm_params(params, cfg, precision)
        x = x_all[:CHECK_B].to(dt).contiguous()
        got = ops.bilstm_center_features(packed, x, cfg, precision)
        torch.cuda.synchronize()
        want = ops.bilstm_center_plain(params, x, cfg, precision)
        lib = cudnn_lstms(params, cfg, precision, device)
        with torch.no_grad():
            lib_out = cudnn_center(lib, x, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_err = float(err.max())
        assert torch.isfinite(got).all(), f"{precision}: non-finite output"
        if precision == "fp32":
            assert max_err <= 2e-5, f"fp32 kernel vs plain: {max_err}"
            n_out = 0
        else:
            assert torch.allclose(got, want, rtol=2e-2, atol=2e-3), (
                f"bf16 kernel vs plain: max abs {max_err}")
            n_out = int((err > 2e-3).sum())
        ow, ob = params["out_w"], params["out_b"]
        lg, lw = got @ ow + ob, want @ ow + ob
        agree = float((lg.argmax(1) == lw.argmax(1)).float().mean())
        lib_err = float((lib_out - want).abs().max())
        log(f"[K1 {precision}] B={CHECK_B} max_abs_err={max_err:.3e} "
            f"(elements past atol 2e-3: {n_out}) argmax agreement={agree:.6f} "
            f"cudnn-vs-plain max_abs={lib_err:.3e}")

        # the detect path's shape: the overlapping window view of one
        # full (262,144, F) row chunk, read in place by the kernel
        rows = x_all[:, 0].to(dt).contiguous()
        view = rows.as_strided(
            (TIME_B - cfg.timesteps + 1, cfg.timesteps, cfg.num_input),
            (cfg.num_input, cfg.num_input, 1))
        got_v = ops.bilstm_center_features(packed, view, cfg, precision)
        torch.cuda.synchronize()
        want_v = ops.bilstm_center_plain(params, view, cfg, precision)
        err_v = float((got_v - want_v).abs().max())
        if precision == "fp32":
            assert err_v <= 2e-5, f"fp32 kernel vs plain, window view: {err_v}"
        else:
            assert torch.allclose(got_v, want_v, rtol=2e-2, atol=2e-3), (
                f"bf16 kernel vs plain, window view: max abs {err_v}")
        log(f"[K1 {precision}] window view of {TIME_B} rows: "
            f"max_abs_err={err_v:.3e}")
        max_err = max(max_err, err_v)
        del rows, view, got_v, want_v

        xt = x_all.to(dt).contiguous()
        ms = time_ms(lambda: ops.bilstm_center_features(packed, xt, cfg, precision))
        plain_ms = time_ms(
            lambda: ops.bilstm_center_plain(params, xt, cfg, precision))
        with torch.no_grad():
            lib_ms = time_ms(lambda: cudnn_center(lib, xt, cfg))
        ms2 = time_ms(lambda: ops.bilstm_center_features(packed, xt, cfg, precision))
        tiles = {}
        for tile in (16, 32, 40):
            if cfg.num_hidden * tile // 8 <= ops.MAX_THREADS and (
                    (cfg.timesteps // 2 + 1) * (cfg.num_hidden + cfg.num_input)
                    * tile * xt.element_size() <= ops.MAX_SMEM):
                tiles[tile] = round(time_ms(lambda: ops.bilstm_center_features(
                    packed, xt, cfg, precision, tile_b=tile)), 3)
        log(f"[K1 {precision}] tile_b sweep (ms): {tiles} vs "
            f"{ops.TILE_B}: {ms:.3f}")
        w_bytes = packed.w.numel() * packed.w.element_size() + packed.bias.numel() * 4
        b_ms, b_by = bound_ms(cfg, TIME_B, precision, w_bytes)
        log(f"[K1 {precision}] B={TIME_B} kernel {ms:.3f} / {ms2:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cudnn {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); {flops_per_window(cfg)} FLOP/window, "
            f"{flops_per_window(cfg) * TIME_B / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        results[precision] = dict(
            max_abs_err=max_err, ms=ms, ms_repeat=ms2, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            argmax_agreement=agree,
        )
        del xt, x, got, want, lib, lib_out
        torch.cuda.empty_cache()
    return results


def train_cost_per_window(cfg) -> tuple:
    """(K2, K3) FLOP per window: multiply-adds x2 over both lanes and the
    steps each layer runs. K3 counts the gate recompute, the dh/dx
    products and the [x; h; 1] x da weight-gradient product."""
    from deepmod_tpu_torch.ops.bilstm_fused_train import readout

    h = cfg.num_hidden
    k2 = k3 = 0
    for layer in range(cfg.num_layers):
        i = cfg.num_input if layer == 0 else h
        k2 += 2 * (i + h) * 4 * h
        k3 += 2 * (i + h) * 4 * h + 2 * 4 * h * (h + i) + 2 * (i + h + 1) * 4 * h
    steps = 2 * readout(cfg.timesteps)[0]
    return steps * k2, steps * k3


def train_bound_ms(flops: float, nbytes: float) -> tuple:
    """Both kernels run fp32 FMAs on the CUDA cores in either precision."""
    t_ops, t_bytes = flops / PEAK_OPS["fp32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _train_inputs(cfg, params, batch, precision, device):
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    rng = np.random.default_rng(SEED + batch)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(device)
    steps = tr.readout(cfg.timesteps)[0]
    xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)), steps)
    gen = torch.Generator().manual_seed(SEED + batch)
    dh = (torch.randn(2, steps, batch, cfg.num_hidden, generator=gen)
          / batch).to(device).to(xin.dtype)
    return x, xin, tr.stack_lanes(params), dh


def _bwd_all(fn, xin, hs, cs, dh, weights, fb):
    """K3's work for a whole backward: every layer, the same dh stream."""
    out = []
    for layer, (w, b) in enumerate(weights):
        layer_in = xin if layer == 0 else hs[layer - 1]
        out += fn(layer_in, hs[layer], cs[layer], dh, w, b, fb)
    return out


def device_time_by_kernel(fn, reps: int = 3) -> tuple:
    """torch.profiler over ``reps`` calls of ``fn``: (device ms a call by
    kernel name, largest first; total device ms a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0:
            rows.append((us / reps / 1e3, ev.key))
    rows.sort(reverse=True)
    return rows, sum(ms for ms, _ in rows)


def phase_train_kernels(device) -> dict:
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BiLSTMConfig()
    params = init_bilstm_params(SEED + 3, cfg, device=device)
    gen = torch.Generator().manual_seed(SEED + 3)
    for lane in ("fw", "bw"):
        for lp in params[lane]:
            lp["bias"] = (0.1 * torch.randn(lp["bias"].shape, generator=gen)).to(device)
    fb = cfg.forget_bias
    results = {}
    for precision in ("fp32", "bf16"):
        err_fwd = err_bwd = 0.0
        for batch in (TRAIN_B, TRAIN_B + 35):
            _, xin, weights, dh = _train_inputs(cfg, params, batch, precision,
                                                device)
            hs, cs = tr.train_fwd(xin, weights, fb)
            torch.cuda.synchronize()
            hs_p, cs_p = tr.train_fwd_plain(xin, weights, fb)
            for got, want in ((hs, hs_p), (cs, cs_p)):
                got, want = got.float(), want.float()
                assert torch.isfinite(got).all(), f"K2 {precision}: non-finite"
                err = float((got - want).abs().max())
                err_fwd = max(err_fwd, err)
                if precision == "fp32":
                    assert err <= 2e-5, f"K2 fp32 B={batch}: {err}"
                else:
                    assert torch.allclose(got, want, rtol=2e-2, atol=2e-3), (
                        f"K2 bf16 B={batch}: max abs {err}")
            got = _bwd_all(tr.train_bwd, xin, hs, cs, dh, weights, fb)
            again = _bwd_all(tr.train_bwd, xin, hs, cs, dh, weights, fb)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                f"K3 {precision} B={batch}: two runs differ")
            want = _bwd_all(tr.train_bwd_plain, xin, hs, cs, dh, weights, fb)
            for a, b in zip(got, want):
                assert torch.isfinite(a).all(), f"K3 {precision}: non-finite"
                err_bwd = max(err_bwd, float((a.float() - b.float()).abs().max()))
                if precision == "fp32":
                    assert torch.allclose(a, b, rtol=5e-4, atol=5e-5), (
                        f"K3 fp32 B={batch}: max abs "
                        f"{float((a - b).abs().max())}")
            a = torch.cat([t.double().ravel() for t in got])
            b = torch.cat([t.double().ravel() for t in want])
            rel = float((a - b).norm() / b.norm())
            cos = float(a @ b / (a.norm() * b.norm()))
            if precision == "bf16":
                assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)
            log(f"[K2/K3 {precision}] B={batch} K2 max_abs_err={err_fwd:.3e} "
                f"K3 max_abs_err={err_bwd:.3e} grad rel_l2={rel:.3e} "
                f"cos={cos:.8f}; K3 twice: same bits")
            del hs, cs, hs_p, cs_p, got, again, want

        # times at the train batch
        x, xin, weights, dh = _train_inputs(cfg, params, TRAIN_B, precision,
                                            device)
        hs, cs = tr.train_fwd(xin, weights, fb)
        k2_ms = time_ms(lambda: tr.train_fwd(xin, weights, fb))
        k2_plain = time_ms(lambda: tr.train_fwd_plain(xin, weights, fb))
        k3_ms = time_ms(lambda: _bwd_all(tr.train_bwd, xin, hs, cs, dh,
                                         weights, fb))
        k3_plain = time_ms(lambda: _bwd_all(tr.train_bwd_plain, xin, hs, cs,
                                            dh, weights, fb))
        lib = cudnn_lstms(params, cfg, precision, device)
        xl = x.to(lib[0].weight_ih_l0.dtype).requires_grad_(True)
        lib_fwd_ms = time_ms(lambda: cudnn_center(lib, xl, cfg))
        out = cudnn_center(lib, xl, cfg)
        gout = torch.randn_like(out) / TRAIN_B
        lib_bwd_ms = time_ms(lambda: torch.autograd.backward(
            out, gout, retain_graph=True))

        step_params = params_from_numpy(params, device)  # a copy to update
        state = adam_init(step_params)
        labels = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 2, TRAIN_B)).to(device)
        y = torch.nn.functional.one_hot(labels, 2).float()
        mask = torch.ones(TRAIN_B, device=device)
        step = make_train_step(cfg, False, precision)
        step_ms = time_ms(lambda: step(step_params, state, x, y, mask))

        f2, f3 = train_cost_per_window(cfg)
        w_bytes = sum(_nbytes(w, b) for w, b in weights)
        b2_ms, b2_by = train_bound_ms(f2 * TRAIN_B, _nbytes(xin, hs, cs) + w_bytes)
        # K3 reads each layer's input, h, c, dh stream and weights once and
        # writes dx (the input's shape and dtype), dW and db
        k3_bytes = 0
        for layer, (w, b) in enumerate(weights):
            layer_in = xin if layer == 0 else hs[layer - 1]
            k3_bytes += (_nbytes(layer_in, hs[layer], cs[layer], dh, w, b)
                         + _nbytes(layer_in, w, b))
        b3_ms, b3_by = train_bound_ms(f3 * TRAIN_B, k3_bytes)
        log(f"[K2 {precision}] B={TRAIN_B} kernel {k2_ms:.4f} ms, plain "
            f"{k2_plain:.4f} ms, cudnn fwd {lib_fwd_ms:.4f} ms, bound "
            f"{b2_ms:.4f} ms ({b2_by}); {f2} FLOP/window, "
            f"{f2 * TRAIN_B / (k2_ms * 1e-3) / 1e12:.2f} TFLOP/s")
        log(f"[K3 {precision}] B={TRAIN_B} kernels {k3_ms:.4f} ms (3 layers), "
            f"plain {k3_plain:.4f} ms, cudnn bwd {lib_bwd_ms:.4f} ms, bound "
            f"{b3_ms:.4f} ms ({b3_by}); {f3} FLOP/window, "
            f"{f3 * TRAIN_B / (k3_ms * 1e-3) / 1e12:.2f} TFLOP/s")
        log(f"[train step {precision}] B={TRAIN_B} forward+backward+Adam "
            f"{step_ms:.4f} ms ({TRAIN_B / (step_ms * 1e-3):.1f} samples/s); "
            f"cudnn fwd+bwd {lib_fwd_ms + lib_bwd_ms:.4f} ms")
        by_kernel, busy_ms = device_time_by_kernel(
            lambda: step(step_params, state, x, y, mask))
        if by_kernel:
            log(f"[train step {precision}] profiler: {busy_ms:.4f} ms of "
                f"device time a step ({len(by_kernel)} kernel names), idle "
                f"share {max(0.0, 1 - busy_ms / step_ms):.3f} of the "
                f"{step_ms:.4f} ms step; largest (ms): " + "; ".join(
                    f"{name[:48]} {ms:.4f}" for ms, name in by_kernel[:6]))
        else:
            log(f"[train step {precision}] profiler: no device time recorded")
        results[precision] = {
            "fwd": dict(max_abs_err=err_fwd, ms=k2_ms, plain_ms=k2_plain,
                        library_ms=lib_fwd_ms, bound_ms=b2_ms, bound_by=b2_by),
            "bwd": dict(max_abs_err=err_bwd, ms=k3_ms, plain_ms=k3_plain,
                        library_ms=lib_bwd_ms, bound_ms=b3_ms, bound_by=b3_by),
            "step_ms": step_ms,
        }
        del x, xin, weights, dh, hs, cs, lib, xl, out, step_params, state
        torch.cuda.empty_cache()
    return results


def read_beds(folder: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "mod_pos.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def run_detect(ds: str, out: str, device: str, precision: str,
               model: str = "") -> float:
    from deepmod_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main([
        "detect", "--wrkBase", os.path.join(ds, "pod5"),
        "--Ref", os.path.join(ds, "ref.fa"),
        "--modfile", model or os.path.join(ds, "model.npz"),
        "--basecalls", os.path.join(ds, "calls.bam"),
        "--outFolder", out, "--alignStr", "builtin", "--Base", "C",
        "--precision", precision, "--device", device, "--outLevel", "0",
        "--perRead", "0",
    ])
    wall = time.perf_counter() - t0
    assert rc == 0, f"detect {device}/{precision} exited {rc}"
    assert os.path.exists(out + ".done")
    return wall


def phase_detect(device, workdir: str) -> dict:
    from deepmod_tpu_torch.engine.detect import (
        DetectConfig,
        WindowPredictor,
        _host_options,
    )
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.engine.outputs import build_batch_request
    from deepmod_tpu_torch.models.bilstm import (
        BiLSTMConfig,
        bilstm_logits,
        init_bilstm_params,
    )
    from deepmod_tpu_torch.models.tf_import import load_model, save_bilstm_npz
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )

    ds = os.path.join(workdir, "ds")
    t0 = time.perf_counter()
    _, reads, _ = write_move_dataset_pod5(ds, SynthConfig(
        genome_sizes={"chrS": 200_000}, num_reads=100,
        read_length=(1500, 3000), seed=SEED, fast5_style="move",
        mod_motif="CG", mod_level_shift=0.5,
    ))
    cfg = BiLSTMConfig()
    save_bilstm_npz(os.path.join(ds, "model.npz"),
                    init_bilstm_params(SEED + 1, cfg, device="cpu"), cfg)
    log(f"[detect] dataset: {len(reads)} reads, "
        f"{time.perf_counter() - t0:.2f} s to write")

    # the main path: counts from 0 just before, read just after
    ops.reset_launch_counts()
    walls = {}
    for precision in ("bf16", "fp32"):
        walls[precision] = run_detect(
            ds, os.path.join(workdir, f"gpu_{precision}"), "cuda", precision)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[detect] K1 launches on the main path: {launches}")
    assert launches["bf16"] > 0 and launches["fp32"] > 0, launches

    walls["cpu_fp32"] = run_detect(
        ds, os.path.join(workdir, "cpu_fp32"), "cpu", "fp32")
    beds = {k: read_beds(os.path.join(workdir, k))
            for k in ("gpu_bf16", "gpu_fp32", "cpu_fp32")}
    for k, v in beds.items():
        assert v and all(len(b) > 0 for b in v.values()), f"{k}: empty BEDs"
    beds_equal = beds["gpu_fp32"] == beds["cpu_fp32"]

    # window-level trace of any fp32 GPU/CPU difference: the same host
    # features through both devices
    init_worker(_host_options(DetectConfig(
        wrk_base=os.path.join(ds, "pod5"), ref=os.path.join(ds, "ref.fa"),
        model_path="", out_folder="", align_str="builtin",
        basecalls=os.path.join(ds, "calls.bam"),
    )))
    results, errors = host_process_files(
        sorted(glob.glob(os.path.join(ds, "pod5", "*.pod5"))))
    feats, centers, _, _ = build_batch_request(results)
    params, mcfg = load_model(os.path.join(ds, "model.npz"))
    t0 = time.perf_counter()
    gpu = WindowPredictor(params, mcfg, device=device, precision="fp32")
    p_gpu = gpu.predict_from_features(feats, centers, assume_packable=True)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    cpu = WindowPredictor(params, mcfg, device="cpu", precision="fp32")
    p_cpu = cpu.predict_from_features(feats, centers, assume_packable=True)
    flips = np.flatnonzero(p_gpu != p_cpu)
    n_near_tie = 0
    if len(flips):
        half = mcfg.timesteps // 2
        view = np.lib.stride_tricks.sliding_window_view(feats, mcfg.timesteps, axis=0)
        win = np.ascontiguousarray(
            np.moveaxis(view[centers[flips] - half], 2, 1))
        lg = bilstm_logits(gpu._model, torch.from_numpy(win).to(device),
                           mcfg, "fp32").cpu()
        lc = bilstm_logits(cpu._model, torch.from_numpy(win), mcfg, "fp32")
        margin = (lc[:, 1] - lc[:, 0]).abs()
        diff = (lg - lc).abs().max(dim=1).values
        n_near_tie = int((margin <= 2 * diff).sum())
        assert n_near_tie == len(flips), (
            f"{len(flips) - n_near_tie} fp32 GPU/CPU prediction flips are "
            "not near ties")
    assert beds_equal or len(flips) > 0, "BEDs differ with no window flip"
    log(f"[detect] windows={len(centers)} fp32 GPU/CPU window flips="
        f"{len(flips)} (all near ties: {n_near_tie == len(flips)}), "
        f"BEDs equal={beds_equal}; GPU classify {gpu_s:.3f} s")
    res = {"launches": launches, "walls": walls, "windows": int(len(centers)),
           "flips": int(len(flips)), "beds_equal": beds_equal}
    return res


def run_cli(*args: str) -> float:
    from deepmod_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(list(args))
    assert rc == 0, f"{args[0]} exited {rc}"
    return time.perf_counter() - t0


def _flat_params(path: str) -> np.ndarray:
    from deepmod_tpu_torch.models.tf_import import load_bilstm_npz

    tree, _ = load_bilstm_npz(path)
    return np.concatenate(
        [np.asarray(lp[k]).ravel() for lane in ("fw", "bw")
         for lp in tree[lane] for k in ("kernel", "bias")]
        + [np.asarray(tree["out_w"]).ravel(), np.asarray(tree["out_b"]).ravel()])


def phase_train(device, workdir: str) -> dict:
    """getfeatures -> train (card fp32, card bf16, cpu fp32) -> detect."""
    from deepmod_tpu_torch.models.bilstm import (
        BiLSTMConfig,
        bilstm_loss,
        init_bilstm_params,
    )
    from deepmod_tpu_torch.models.tf_import import load_bilstm_npz, params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused as k1
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )
    from deepmod_tpu_torch.train.loader import (
        find_feature_files,
        iterate_training_batches,
    )

    common = dict(genome_sizes={"chrT": 100_000}, num_reads=TRAIN_READS,
                  read_length=(1500, 3000), seed=SEED + 5, fast5_style="move")
    t0 = time.perf_counter()
    feats = {}
    for name, posneg, shift in (("mod", 1, dict(mod_motif="CG",
                                                mod_level_shift=1.5)),
                                ("ctl", 0, {})):
        ds = os.path.join(workdir, f"train_{name}")
        write_move_dataset_pod5(ds, SynthConfig(**common, **shift))
        feats[name] = os.path.join(workdir, f"feat_{name}")
        run_cli("getfeatures", "--wrkBase", os.path.join(ds, "pod5"),
                "--Ref", os.path.join(ds, "ref.fa"),
                "--basecalls", os.path.join(ds, "calls.bam"),
                "--outFolder", feats[name], "--posneg", str(posneg),
                "--alignStr", "builtin", "--save_format", "npz")
    gf_wall = time.perf_counter() - t0
    groups = [find_feature_files(feats["mod"]), find_feature_files(feats["ctl"])]
    assert groups[0] and groups[1], groups
    minibatches = [mb for step in iterate_training_batches(groups, TRAIN_B)
                   for mb in step if len(mb[1])]
    n_steps = len(minibatches)
    samples = sum(len(mb[1]) for mb in minibatches)
    log(f"[train] getfeatures {gf_wall:.2f} s; {samples} windows in "
        f"{n_steps} minibatches of <= {TRAIN_B} per epoch")
    assert n_steps >= 8, n_steps

    cfg = BiLSTMConfig()
    x0, y0 = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
              for a in minibatches[0]]

    def first_loss(params, precision):
        with torch.no_grad():
            return float(bilstm_loss(params, x0, y0, cfg, precision=precision))

    def train(precision: str, dev: str) -> tuple:
        out = os.path.join(workdir, f"train_out_{dev}_{precision}")
        wall = run_cli("train", "--wrkBase", feats["mod"], "--wrkBase2",
                       feats["ctl"], "--outFolder", out, "--epochs", "1",
                       "--batchsize", str(TRAIN_B),
                       "--trainPrecision", precision, "--device", dev,
                       "--outLevel", "2")
        return os.path.join(out, "1", "mod.npz"), wall

    # the main path: counts from 0 just before, read just after
    tr.reset_launch_counts()
    runs, walls = {}, {}
    for precision in ("fp32", "bf16"):
        runs[precision], walls[precision] = train(precision, "cuda")
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    log(f"[train] K2/K3 launches on the main path: {launches} "
        f"({n_steps} steps an epoch, {cfg.num_layers} layers)")
    for precision in ("fp32", "bf16"):
        assert launches[f"fwd_{precision}"] == n_steps, launches
        assert launches[f"bwd_{precision}"] == cfg.num_layers * n_steps, launches

    init = init_bilstm_params(0, cfg, device=device)  # train's default seed
    losses = {}
    for precision, path in runs.items():
        data = np.load(path)
        assert int(data["adam/count"]) == n_steps, int(data["adam/count"])
        flat = _flat_params(path)
        assert np.isfinite(flat).all(), f"{precision}: non-finite params"
        trained = params_from_numpy(load_bilstm_npz(path)[0], device)
        losses[precision] = (first_loss(init, precision),
                             first_loss(trained, precision))
        assert losses[precision][1] < losses[precision][0], losses
        log(f"[train] {precision}: wall {walls[precision]:.2f} s, "
            f"{samples / walls[precision]:.1f} samples/s end to end; first "
            f"minibatch loss {losses[precision][0]:.5f} -> "
            f"{losses[precision][1]:.5f}")

    cpu_path, walls["cpu_fp32"] = train("fp32", "cpu")
    a, b = _flat_params(runs["fp32"]), _flat_params(cpu_path)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    log(f"[train] cpu fp32: wall {walls['cpu_fp32']:.2f} s; card vs cpu "
        f"params relative L2 {rel:.3e}")
    assert rel <= 1e-3, rel

    k1.reset_launch_counts()
    ds = os.path.join(workdir, "train_mod")
    det_wall = run_detect(ds, os.path.join(workdir, "trained_detect"), "cuda",
                          "fp32", model=runs["fp32"])
    torch.cuda.synchronize()
    beds = read_beds(os.path.join(workdir, "trained_detect"))
    assert beds and all(len(v) > 0 for v in beds.values()), "empty BEDs"
    assert k1.LAUNCHES["fp32"] > 0, k1.LAUNCHES
    log(f"[train] detect with the trained model: {det_wall:.2f} s, "
        f"{len(beds)} BEDs, K1 launches {dict(k1.LAUNCHES)}")
    return {"launches": launches, "walls": walls, "samples": samples,
            "steps": n_steps, "rel_cpu": rel, "losses": losses}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import deepmod_tpu_torch  # noqa: F401  (fails outside a checkout)
    from deepmod_tpu_torch.ops import _build
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    kern = phase_kernel(device)
    tkern = phase_train_kernels(device)
    with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as workdir:
        det = phase_detect(device, workdir)
        trn = phase_train(device, workdir)
    for precision in ("bf16", "fp32"):
        log(f"[detect] {precision}: wall {det['walls'][precision]:.2f} s")
    log(f"[detect] cpu fp32 wall {det['walls']['cpu_fp32']:.2f} s")
    for key, wall in det["walls"].items():
        log(f"[detect] {key}: {det['windows'] / wall:.1f} windows/s end to end")

    def entry(name, precision, source, replaces, launches, k):
        return {
            "name": name, "precision": precision, "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": float(f"{k['max_abs_err']:.3e}"),
            "ms": round(k["ms"], 4), "plain_ms": round(k["plain_ms"], 4),
            "bound_ms": round(k["bound_ms"], 4), "bound_by": k["bound_by"],
            "library_ms": round(k["library_ms"], 4),
        }

    kernels = []
    for precision in ("fp32", "bf16"):
        kernels.append(entry(
            f"k1_center_{precision}", precision, "deepmod_tpu_torch/csrc/"
            "bilstm_fused.cu", "deepmod_tpu/ops/bilstm_fused.py:551",
            det["launches"][precision], kern[precision]))
        for kind, line in (("fwd", 101), ("bwd", 222)):
            kernels.append(entry(
                f"k{2 if kind == 'fwd' else 3}_train_{kind}_{precision}",
                precision, "deepmod_tpu_torch/csrc/bilstm_train.cu",
                f"deepmod_tpu/ops/bilstm_fused_train.py:{line}",
                trn["launches"][f"{kind}_{precision}"], tkern[precision][kind]))
    line = json.dumps({"kernels": kernels}, separators=(",", ":"))
    assert len(line) < 2000, len(line)
    log(line)
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
