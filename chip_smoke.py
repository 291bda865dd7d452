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
5. detect end to end through the CLI over a synthetic pod5 + basecall BAM
   dataset (one 200 kb chromosome, 100 reads of 1.5-3 kb, no h5py) on the
   card at bf16 and fp32, with K1's launch counts read around those runs;
   the fp32 run's BEDs against a --device cpu run's, and the window-level
   predictions of the two devices, where every disagreement must be a
   near tie (|logit margin| below the two devices' logit difference).

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


def read_beds(folder: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "mod_pos.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def run_detect(ds: str, out: str, device: str, precision: str) -> float:
    from deepmod_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main([
        "detect", "--wrkBase", os.path.join(ds, "pod5"),
        "--Ref", os.path.join(ds, "ref.fa"),
        "--modfile", os.path.join(ds, "model.npz"),
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
    with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as workdir:
        det = phase_detect(device, workdir)
    for precision in ("bf16", "fp32"):
        log(f"[detect] {precision}: wall {det['walls'][precision]:.2f} s")
    log(f"[detect] cpu fp32 wall {det['walls']['cpu_fp32']:.2f} s")
    for key, wall in det["walls"].items():
        log(f"[detect] {key}: {det['windows'] / wall:.1f} windows/s end to end")

    kernels = []
    for precision in ("fp32", "bf16"):
        k = kern[precision]
        kernels.append({
            "name": f"bilstm_center_mono_{precision}",
            "precision": precision,
            "route": "cuda",
            "source": "deepmod_tpu_torch/csrc/bilstm_fused.cu",
            "replaces": "deepmod_tpu/ops/bilstm_fused.py:551",
            "launches": det["launches"][precision],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "kernel_ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
