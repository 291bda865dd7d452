#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepmod_tpu_torch) on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --parallel   # phases 7, 24 and 25 (A) only
                                       # (several cards)

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit (``--parallel``: any number of them; phase 24 then takes
every card). Phases (any failure raises, and the script exits non-zero
without printing the result line):

1. the card's name and power limit;
2. build the CUDA kernels from the checkout's sources (nvcc, sm_90a);
   ptxas registers and spills of every kernel (a line each for the
   tensor-core kernels and for K3's); the SASS of every bf16 template of
   K1, K4 and K5a-c (the tensor-core kernels, Hp 8-128) must hold HGMMA
   (wgmma), and no bf16 CUDA-core body of any of them may be left; their
   dynamic shared memory; the fp32 core's templates (K1's, K4's and
   K5a-c's fp32 bodies and K6's, csrc/lstm_f32.cuh) must all be there and
   the old fp32 bodies gone, with their registers and spills (none in K5c
   and K6, asserted);
3. the BiLSTM center kernel (K1) against its plain PyTorch version at
   full width (H=100, 3 layers, T=21, F=7) on 65,536 random windows and
   on the overlapping window view of a 262,144-row feature chunk (the
   shape detect gives it), in fp32 (max abs 2e-5) and bf16 (atol 2e-3 +
   rtol 2e-2, the tolerance of two bf16 schedules of the same contract);
   K1 also against K5a on the same inputs (fp32: the same bits, asserted);
4. kernel, plain and library (cuDNN nn.LSTM over the readout cone) times
   at 262,144 windows, beside the bound the card's peak rates set; K1,
   K5a and cuDNN in turns, the median of 3 rounds; the fp32 core's tile
   sweep (2- and 4-CTA clusters) with the clusters the card holds at
   once;
5. the training kernels K2 (forward with residuals, all layers) and K3
   (BPTT recurrence + weight-gradient product, per layer) against their
   plain versions at full width on 2,048 and 2,083 windows (a ragged last
   block), fp32 (sequences 2e-5 absolute; dx/dW/db rtol 5e-4 / atol 5e-5
   under a mean-scaled cotangent, as the trainer's masked mean gives) and
   bf16 storage (sequences atol 2e-3 + rtol 2e-2, one bf16 step at a
   rounding point; the gradient tree within relative L2 1e-2, cosine
   0.9999); K2 and K3 run twice must give the same bits; K2 also at
   batch 2048, 2083, 37 and 5, T = 21 (the readout cone), 20 (all T
   steps) and 8, hidden 100 and 128 (``K2_CASES``), twice each, and its
   launch sweep (``K2_SWEEP``: split x tile at batch 2048 and 2083, with
   the clusters resident, the clusters needed and the waves);
6. K2, K3 and whole train-step times at 2,048 windows beside their plain
   versions, cuDNN nn.LSTM forward / backward (K2 and the forward, K3 and
   the backward in turns, the median of 3 rounds) and the bound; a
   torch.profiler split of K3 a layer (recurrence, gate, dx and dW
   products) and of the train step's device time by kernel, with its
   idle share;
7. detect end to end through the CLI over a synthetic pod5 + basecall BAM
   dataset (one 200 kb chromosome, 100 reads of 1.5-3 kb over 16 pod5
   files sharing one calls.bam, no h5py) on the card at bf16 and fp32,
   with K1's launch counts read around those runs;
   the fp32 run's BEDs against a --device cpu run's, and the window-level
   predictions of the two devices, where every disagreement must be a
   near tie (|logit margin| below the two devices' logit difference);
8. train end to end through the CLI: getfeatures over a mod and a ctl
   pod5 + BAM dataset (same genome, a CG signal shift on mod only), one
   epoch of train on the card at fp32 and at bf16 with K2/K3's launch
   counts read around those runs, a --device cpu fp32 run whose params
   must end within relative L2 1e-3 of the card's, and detect on the card
   with the trained model;
9. the layered kernel K4 (bf16: the tensor-core kernel, 64 windows a
   block) against its plain version at full width: T=20 and T=31 on
   65,536 random windows and on the window view of a 262,144-row chunk,
   T=64 on 4,096 windows (fp32 2e-5, bf16 atol 2e-3 + rtol 2e-2), K4
   forced at T=21 against K1; kernel, plain and cuDNN times at 262,144
   windows beside the bound of the readout cone's steps, which K4 runs at
   every T, and the all-T bound (the steps the plain version runs at even
   T); the fp32 core's sweep at T=20;
10. the one-direction layer kernel K6 (W_h resident over a cluster)
   against its plain version (T=21, both directions at H=100 and 128, one
   at 170, 1e-5), its main path (the model's two one-direction stacks)
   against K1's center features (2e-5), a split x tile sweep with the
   clusters resident, and its times (the kernel's and the whole call's,
   which packs W_h);
11. the transcendental probe P1 against its plain loop at K=256 (fp32
   rtol 1e-5, bf16 within one ulp), its entry point, its rates at K=256
   and 2048 and the bound from the SASS step loop;
12. detect through the CLI at --windowsize 20 and 31 over 20 reads, on
   the card at bf16 and fp32 (K4 launched, K1 not) and on the cpu, with
   phase 7's BED and window-level checks;
13. train at --windowsize 20 on the card over phase 8's features (K2/K3
   a step, evaluation through K4), then predfeatures and detect with the
   trained model through K4;
14. K1's three other schedules through ``bilstm_center_mono``'s flags:
   K5a (merged [x; h] product; bf16: the tensor-core kernel), K5b
   (pre-projected gates, fp32 and bf16 gate store) and K5c (layer
   wavefront) against their plain versions at full width on phase 3's
   inputs (65,536 random windows and the window view of a 262,144-row
   chunk) in fp32 and bf16 (fp32 max abs 2e-5, bf16 atol 2e-3 + rtol
   2e-2; a bf16 gate store at the bf16 tolerance in both precisions), and
   against K1 on the same input at the same tolerances (fp32 K5a-c, K5b
   with fp32 gates, on the fp32 core: K1's bits, asserted); kernel and
   plain times at 262,144 windows with a tile sweep (the fp32 core's
   tiles for K5a-c fp32, K5c's streamed and a cluster a tile-lane, with
   the 6- and 12-CTA clusters resident; none for the 64-window
   tensor-core kernels: K5a-c in bf16), beside K1's bound and cuDNN
   time; fp32 K5b once over the window view of a 4,194,304-row block (its
   persistent grid's slots and workspace bytes, the same at 262,144
   windows; the first and last 65,536 windows K1's bits); bf16 K5b's
   persistent grid and workspace bytes, and the clusters of K5a and K5c
   the card holds at once (cudaOccupancyMaxActiveClusters);
   K5c's main path on the window view, and the probe tools (probe_mono,
   probe_merged_gemm: K5a's main path, probe_pregemm: K5b's) at 32,768
   windows with the launch counts read around each;
15. hidden 128, 3 layers, 32,768 windows: bf16 (Hp 128: K1, K4, K5a and
   K5c split each layer over a 2-CTA cluster) K4 at T=20 and forced at
   T=21, K1, K5a, K5b (both gate stores) and K5c at T=21; fp32 (the fp32
   core's 4-CTA clusters, K5c's 12-CTA ones) K4 at T=20 and forced at
   T=21, K1 and K5a-c (K5b with both gate stores) at T=21; each against
   its plain version (fp32 2e-5, bf16 atol 2e-3 + rtol 2e-2; bf16 gates
   at the bf16 tolerance), fp32 K5a-c (K5b with fp32 gates) also K1's
   bits on the random windows and a window view, with kernel, plain and
   cuDNN times at that width and the clusters resident.
16. (after the build) the native host library (``deepmod_tpu_torch/native``,
   g++ from the checkout's sources): its build seconds and the functions
   it exports; it must load;
17. (after phase 7) HostPool: detect through the CLI over phase 7's 16
   pod5 files in batches of 2 (8 batches), bf16 on the card, at
   --threads 1 and --threads 4 (spawn workers; the engine process alone
   launches K1, counted around each run), with per-read and index files
   where h5py is present: the two runs' BEDs and index files must be the
   same bytes; walls, windows/s, stage seconds, the host's share of the
   wall and os.cpu_count(); then a --threads 4 run with --trace, whose
   torch.profiler trace gives the card's idle share in detect (a fresh
   pool over 100 reads: start-up weighs heavily);
18. (last) the host tools, each once in its own process: bench_host (the
   host stage's one-thread rate on the numpy twins and on the native
   library, which must give the same feature rows) and bench_e2e (warm
   detect over 400 reads at --threads 1 and 4 with a shared predictor and
   pool, and the card's idle share in a traced warm pass);
19. (after phase 13) the second stage on the card: the bundled cluster
   model (``tests/golden/cluster_weights.npz``) on the golden input with
   TF32 off, within 1e-6 of the TF1 session's output and of the cpu run;
20. the paper's 5mC loop through the CLI (``tools/validate_cluster_loop``'s
   steps) over a clustered pod5 cohort on chrT and chrE: a first-stage
   model trained on the card (K2/K3, counted), detect on the card at bf16
   and fp32 with --mod_cluster 0 and 1 (K1 counted around those four
   runs; walls with and without the rescue) and on the cpu at fp32 (BEDs
   byte-equal, phase 7's near-tie rule), merge, motif, clustertrain on the
   card (the loss must fall), clusterpred on the card and the cpu with the
   chrT-trained and the bundled model (predictions within 1e-5, rewritten
   percentages equal but where p*100 lies within 1e-4 of an integer), and
   chrE's site-level AUC/AP before and after the second stage (against
   the landscape's truth, and by ``ecoli_performance`` against a control
   cohort);
21. clusterpred over a synthesized merged BED of 1,000,000 lines on one
   chromosome: the time split (BED read, features, the MLP on the card by
   CUDA events, write) and sites/s through the CLI, beside the card's name
   and power limit;
22. (after phase 17) the reference's model format on the card: phase 7's
   seeded full-width model written as a TF1 checkpoint by
   ``testing/tf_bundle.py`` (the reference's variable names, Adam slots,
   beta powers, global_step), read back by ``load_model`` (the reader's
   seconds; the .npz's bits), a flipped data byte raising the crc32c
   error, and detect through the CLI with ``--modfile <prefix>`` over
   phase 7's pod5 set at bf16: its BEDs the .npz run's bytes, K1 counted;
23. ``serve`` on the card over phase 7's pod5 files from the TF prefix:
   answers over HTTP (1 file, then 4) equal to the in-process ones, bf16
   and fp32 services at --threads 1 and 4 (the HostPool route) giving the
   same answers, 8 concurrent one-file requests giving the serial answers
   in fewer device calls, the fp32 answers over 2 files equal to a
   --device cpu service's (or every differing window a near tie, phase
   7's rule), K1 counted around those requests; then the latency probe
   (``tools/probe_serve_latency.py``: p50/p95 of 1- and 8-file requests,
   1, 4 and 8 concurrent clients with the coalescer on and off, device
   calls a request) beside the card's name and power limit;
24. (after phase 13) the data-parallel and multi-process paths on the one
   card (``phase_parallel``): a mesh naming it twice; the data-parallel
   WindowPredictor over phase 7's pod5 set at bf16 and fp32 (predictions
   the bits of one shard's, K1 launched on each shard), detect with
   device aggregation on that mesh (BEDs the bytes of phase 7's), the
   data-parallel train step at batch 2,048 against the one-shard step
   over 5 steps (fp32: losses rtol 1e-4, params within relative L2 1e-4;
   bf16 storage: 1e-3 and 1e-3; K2/K3 on each shard; a step's time both
   ways); two
   ``testing/multihost_worker`` ranks on the card over gloo (the count
   reduction and a train step: counts equal to numpy's, the same loss
   and params on both ranks; detect: rank 0's BEDs the bytes of the
   one-process run's), one rank over nccl with the same checks, an epoch
   of ``train`` at full width over phase 8's features (the CLI's
   ``--device cuda`` run against one worker rank over nccl: the same
   params within relative L2 1e-4, the walls), and two nccl ranks on the
   one card, which NCCL refuses. With ``--parallel`` on several cards
   the mesh takes every card, a nccl rank runs a card, the train epoch
   (over 96 reads a cohort) runs on one rank and on a rank a card, and
   ``serve``'s service on ``cuda`` (over every card) answers as one on
   ``cuda:0``;
25. (after phase 24) the rest of the port queue: (A) tensor parallelism
   on a (2, 2) mesh naming the card four times: ``make_sharded_predict(
   model_axis="model")`` (plain torch fp32, as JAX's scan) on phase 7's
   windows against K1 fp32 (every argmax disagreement a near tie; the
   logits' max |difference|), one ``make_sharded_train_step(model_axis=
   "model")`` step against the 1-D step (loss rel 1e-5, params within
   2e-6 where |g| >= 1e-7, the CPU test's bound), both steps' times
   (with ``--parallel`` on several cards: a (1, n) mesh, a card a model
   shard); (B) detect --fnum 57 over phase 7's pod5 set (a batch a file)
   with a seeded fnum-57 model at T=21 (K1) and T=20 (K4): on the card
   in fp32 and bf16 (K1 / K4 counted) and on the cpu in fp32, the card's
   fp32 BEDs against the cpu's as in phase 7, then the histogram pack
   A/B of ``probe_compact_pack --fnum 57``; (C) each of the JAX
   package's remaining scripts as a port tool (``deepmod_tpu_torch/
   tools``) once at its smallest size in this process, each tool's own
   checks holding.

Every process the script starts is stopped and reaped before it exits,
whether it passed or failed: it adopts its descendants' orphans (Linux
PR_SET_CHILD_SUBREAPER), stops multiprocessing's resource tracker (which
the HostPool's queues start and which would otherwise outlive the
script), and then waits for, or kills, every child left; a ``[procs]``
line names each one found.

Prints the ``{"kernels": [...]}`` line (a name ending in ``_tc``: a
tensor-core kernel), the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Every entry of the kernels line has
the same twelve keys: ``name``, ``route``, ``source`` (the CUDA file's
path in the repo), ``replaces`` (file:line of the TPU kernel),
``launches`` (on its main path, counted from 0 just before it),
``shard_launches`` (K1, K2 and K3: the launches of each shard of phase
24's mesh on its main path; null for the others), and ``max_abs_err``,
``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``, ``library_ms`` from this
run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# torch is imported in main(): the detect runs' HostPool workers are spawned
# and re-import this file, and a worker must not load torch
torch = None

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): CUDA-core fp32 for the
# fp32 contract, dense bf16 tensor rate for bf16, HBM3 bandwidth
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
CHECK_B = 65536
TIME_B = 262144
LONG_B = 4096          # windows of the T=64 and T=21 K4 checks
LAYERED_T = (20, 31)   # window sizes the layered kernel (K4) serves
DETECT_T_READS = 20    # reads of the K4 detect dataset
DETECT_FILES = 16      # pod5 files the detect dataset's reads are spread over
POOL_FILES_PER_BATCH = 2   # --files_per_thread of the HostPool runs: 8 batches
POOL_THREADS = 4
E2E_READS = 400        # bench_e2e's reads in phase 18 (its default: 800)
TRAIN_B = 2048
TRAIN_READS = 12
CLUSTER_CHROM = 12_000      # bases of chrT and of chrE in the cluster loop
CLUSTER_TRAIN_READS = 100   # reads of each first-stage training cohort
CLUSTER_READS = 200         # reads of the clustered cohort
CLUSTER_SHIFT = 2.5         # CG signal shift of the loop's cohorts
SCALE_LINES = 1_000_000     # lines of clusterpred's merged BED at scale
SEED = 2024
PARALLEL_SHARDS = 2      # shards of the one card in phase 24's mesh
PARALLEL_STEPS = 5       # train steps compared one shard against the mesh
PARALLEL_TRAIN_READS = 96  # reads a cohort of --parallel's train epochs
# (loss rtol, params relative L2) of the mesh's train step against one
# shard's: fp32 as tests/test_torch_train.py; bf16 storage rounds the
# sequences, so a weight that moved by a reduction-order ulp can flip a
# bf16 rounding point in the next step (phase 5's bf16 reasoning)
PARALLEL_TOL = {"fp32": (1e-4, 1e-4), "bf16": (1e-3, 1e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]



def adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans, so that a
    process whose parent exits first (the resource tracker of a tool run
    in a subprocess) comes back here to be reaped."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        log(f"[procs] prctl(PR_SET_CHILD_SUBREAPER) failed: errno "
            f"{ctypes.get_errno()}")


def _children() -> list:
    """(pid, state, command line) of every child of this process."""
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # after the command's closing parenthesis: state, ppid, ...
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me:
            out.append((int(entry), state, cmd.strip()))
    return out


def stop_children(grace: float = 10.0) -> None:
    """Stop and reap every process this one started or adopted: live
    multiprocessing children, then the resource tracker (it ignores
    SIGTERM and stops when its pipe closes), then any child left, which
    gets ``grace`` seconds, SIGTERM, and SIGKILL 5 s later. The collection
    first lets finished HostPools' semaphores unlink themselves, so the
    tracker has none left to clean up."""
    import gc
    import multiprocessing
    from multiprocessing import resource_tracker

    gc.collect()
    for proc in multiprocessing.active_children():
        log(f"[procs] stopping {proc.name} (pid {proc.pid})")
        proc.terminate()
        proc.join(5.0)
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None
    deadline = time.time() + grace
    sent = {}
    while True:
        kids = _children()
        if not kids:
            return
        for pid, state, cmd in kids:
            if pid not in sent:
                log(f"[procs] child {pid} ({state}) left: {cmd}")
                sent[pid] = None
            if os.waitpid(pid, os.WNOHANG)[0]:
                continue
            now = time.time()
            if now > deadline and sent[pid] is None:
                os.kill(pid, signal.SIGTERM)
                sent[pid] = now
            elif sent[pid] is not None and now > sent[pid] + 5.0:
                os.kill(pid, signal.SIGKILL)
        time.sleep(0.05)


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


def interleaved_ms(calls: dict, rounds: int = 3) -> dict:
    """Each of ``calls`` (name -> fn) timed in turns, ``rounds`` times
    (``time_ms``, 3 repetitions a turn): per name the median over the
    rounds, and under name + "_rounds" the rounds themselves."""
    got = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            got[name].append(time_ms(fn, reps=3))
    out = {name: statistics.median(v) for name, v in got.items()}
    out.update({name + "_rounds": [round(t, 3) for t in v]
                for name, v in got.items()})
    return out


def lane_steps(cfg, layered: bool = False, all_t: bool = False) -> tuple:
    """(fw, bw) steps a layer runs: K1 (odd T) the T//2+1 of the readout
    cone in both lanes; K4 the cone's fw_step+1 and bw_step+1 at every T
    (one fewer in the bw lane at even T); with ``all_t`` the T steps that
    the JAX kernel and the plain version run at even T."""
    from deepmod_tpu_torch.ops.bilstm_fused import cone, readout

    if all_t:
        steps = readout(cfg.timesteps)[0]
        return steps, steps
    if layered:
        _, fw, bw = cone(cfg.timesteps)
        return fw + 1, bw + 1
    steps = readout(cfg.timesteps)[0]
    return steps, steps


def flops_per_window(cfg, layered: bool = False, all_t: bool = False) -> int:
    """Multiply-adds x2 over both lanes and all layers, for the steps each
    layer of a lane runs (``lane_steps``)."""
    h = cfg.num_hidden
    per_step = sum(
        2 * ((cfg.num_input if layer == 0 else h) + h) * 4 * h
        for layer in range(cfg.num_layers)
    )
    return sum(lane_steps(cfg, layered, all_t)) * per_step


def bound_ms(cfg, batch: int, precision: str, weight_bytes: int,
             layered: bool = False, all_t: bool = False) -> tuple:
    """The larger of operations over the peak rate and bytes over HBM
    bandwidth, for the steps the kernel runs (``lane_steps``). The windows
    are read once and the (B, 2H) features written once; the layered
    kernel (K4) also writes and reads back the sequence of every layer but
    the last."""
    size = 4 if precision == "fp32" else 2
    nbytes = (batch * cfg.timesteps * cfg.num_input * size
              + batch * 2 * cfg.num_hidden * 4 + weight_bytes)
    if layered:
        steps = sum(lane_steps(cfg, layered, all_t))
        nbytes += ((cfg.num_layers - 1) * 2 * (steps * batch
                                               * cfg.num_hidden * size))
    t_ops = (flops_per_window(cfg, layered, all_t) * batch
             / PEAK_OPS[precision])
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def cudnn_lstms(params, cfg, precision: str, device, train: bool = False):
    """Two cuDNN nn.LSTM stacks (one per lane) holding the same weights:
    TF i,j,f,o columns mapped to torch's i,f,g,o rows, forget_bias folded
    into the f bias. In eval mode unless ``train`` (training mode keeps
    cuDNN's reserve for a backward: 33 GB at T=20 and 262,144 windows).
    A yardstick only; the port never calls it."""
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
        lstm = lstm.to(dtype).train(train)
        lstm.flatten_parameters()
        lstms.append(lstm)
    return lstms


def cudnn_center(lstms, x, cfg):
    """The center features from the two cuDNN stacks over the readout cone
    (as K1 and K4 run it): the fw lane's steps 0..T//2, the time-reversed
    bw lane's 0..T-1-T//2, read at the last."""
    from deepmod_tpu_torch.ops.bilstm_fused import cone

    _, fw_step, bw_step = cone(cfg.timesteps)
    fw, _ = lstms[0](x[:, :fw_step + 1])
    bw, _ = lstms[1](x.flip(1)[:, :bw_step + 1])
    return torch.cat([fw[:, fw_step], bw[:, bw_step]], dim=1).float()


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
        # K1 against K5a (the same function, one merged product a step) on
        # the same inputs: in fp32 the same fmaf chains on the fp32 core,
        # so the same bits
        vs_k5a, same = 0.0, True
        for inp, mine in ((x, got), (view, got_v)):
            k5a = ops.bilstm_center_mono(packed, inp, cfg, precision,
                                         merged_gemm=True)
            torch.cuda.synchronize()
            vs_k5a = max(vs_k5a, float((mine - k5a).abs().max()))
            same = same and torch.equal(mine, k5a)
            assert _close(mine, k5a, precision), (
                f"{precision} K1 vs K5a: max abs {vs_k5a}")
            assert same or precision == "bf16", (
                f"fp32 K1 vs K5a: not the same bits (max abs {vs_k5a})")
            del k5a
        log(f"[K1 {precision}] vs K5a {precision} on the same inputs (random "
            f"and window view): max abs {vs_k5a:.3e}, same bits {same}")
        del rows, view, got_v, want_v

        xt = x_all.to(dt).contiguous()
        plain_ms = time_ms(
            lambda: ops.bilstm_center_plain(params, xt, cfg, precision))
        # K1, K5a and cuDNN in turns, the median of 3 rounds
        calls = {"k1": lambda: ops.bilstm_center_features(
            packed, xt, cfg, precision),
            "k5a": lambda: ops.bilstm_center_mono(
                packed, xt, cfg, precision, merged_gemm=True),
            "cudnn": lambda: cudnn_center(lib, xt, cfg)}
        with torch.no_grad():
            rounds = interleaved_ms(calls)
        ms, lib_ms = rounds["k1"], rounds["cudnn"]
        log(f"[K1 {precision}] interleaved, 3 rounds (ms): " + "; ".join(
            f"{k} {v:.3f} (rounds {rounds[k + '_rounds']})"
            for k, v in rounds.items() if not k.endswith("_rounds")))
        # the tensor-core kernel takes one tile, 64: no sweep
        if precision == "fp32":
            log(f"[K1 fp32] {f32_sweep_line(cfg, lambda t: ops.bilstm_center_features(packed, xt, cfg, precision, tile_b=t), device)}"
                f"; default {ops.f32_shape(cfg.num_input, cfg.num_hidden)}: "
                f"{ms:.3f} ms")
        w_bytes = packed.w.numel() * packed.w.element_size() + packed.bias.numel() * 4
        b_ms, b_by = bound_ms(cfg, TIME_B, precision, w_bytes)
        log(f"[K1 {precision}] B={TIME_B} kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cudnn {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); {flops_per_window(cfg)} FLOP/window, "
            f"{flops_per_window(cfg) * TIME_B / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        results[precision] = dict(
            max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            argmax_agreement=agree, rounds=rounds,
        )
        del xt, x, got, want, lib, lib_out
        torch.cuda.empty_cache()
    return results


# the fp32 core's tiles the sweep times at H=100: 2-CTA clusters up to 40
# windows, 4-CTA ones at 64 and 80 (``f32_shape``)
F32_SWEEP = (24, 32, 40, 64, 80)


def f32_sweep_line(cfg, launch, device) -> str:
    """The fp32 core (K1 or K4 fp32, ``launch(tile_b)``) timed at each
    tile of F32_SWEEP, with its split, threads, shared memory and the
    clusters the card holds at once."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    got = []
    for tile in F32_SWEEP:
        shape = ops.f32_shape(cfg.num_input, cfg.num_hidden, tile)
        ms = time_ms(lambda: launch(tile), reps=3)
        got.append(f"tile {tile}, split {shape.split} ({shape.threads} "
                   f"threads, {shape.smem} B, "
                   f"{ops.f32_clusters(cfg, shape, device)} clusters): "
                   f"{ms:.3f}")
    return "fp32 core sweep (ms): " + "; ".join(got)


def f32_build_line() -> str:
    """ptxas's registers and spills of the fp32 core's kernels (K1's
    ``bilstm_center_f32_kernel``, K4's ``bilstm_layer_f32_kernel``, K5a's
    ``bilstm_merged_f32_kernel``, K5c's ``bilstm_wavefront_f32_kernel``,
    K6's ``lstm_recurrence_f32_kernel``, one template a split; K5b's
    ``bilstm_pregemm_f32_kernel``, one a split and gate dtype; K2's
    ``train_fwd_kernel``, one a split and storage type). K5c's and K6's
    templates spill nothing (asserted)."""
    import re

    from deepmod_tpu_torch.ops import _build

    lines = _build.build_info["log"].splitlines()
    found = []
    for i, line in enumerate(lines):
        m = re.search(r"(?:bi)?lstm_(center|layer|merged|pregemm|wavefront|"
                      r"recurrence)_f32_kernelILi(\d+)E(f|13__nv_bfloat16)?",
                      line)
        m2 = re.search(r"train_fwd_kernelILi(\d+)E(f|13__nv_bfloat16)E",
                       line)
        if (m or m2) and "Compiling entry" in line:
            props = [t.split("ptxas info    :")[-1].strip()
                     for t in lines[i + 1:i + 4]
                     if "spill" in t or "registers" in t]
            gates = ("" if m is None or m.group(3) is None else
                     ", fp32 gates" if m.group(3) == "f" else ", bf16 gates")
            what = (f"{m.group(1)}<split {m.group(2)}{gates}>" if m else
                    f"k2 {'fp32' if m2.group(2) == 'f' else 'bf16'}"
                    f"<split {m2.group(1)}>")
            found.append(f"{what}: " + "; ".join(props))
            if m and m.group(1) in ("wavefront", "recurrence"):
                spills = [int(n) for t in props
                          for n in re.findall(r"(\d+) bytes spill", t)]
                assert spills and not any(spills), (what, props)
    return " | ".join(found) or "no ptxas log (cached build)"


def tc_build_line(cfg) -> str:
    """ptxas's spills and registers (``-Xptxas -v`` of this run's build)
    of the five tensor-core kernels at the config's padded width, and the
    dynamic shared memory their launchers ask for (nvcc reports only the
    static)."""
    import re

    from deepmod_tpu_torch.ops import _build
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    hp = ops.tc_dims(1, cfg.num_hidden)[0]
    lines = _build.build_info["log"].splitlines()
    found = []
    for i, line in enumerate(lines):
        m = re.search(r"bilstm_(center|merged|layer|pregemm|wavefront)_"
                      r"tc_kernelILi"
                      r"(\d+)E(Lb([01])E)?", line)
        if m and "Compiling entry" in line and int(m.group(2)) == hp:
            props = [t.split("ptxas info    :")[-1].strip()
                     for t in lines[i + 1:i + 4]
                     if "spill" in t or "registers" in t]
            gates = ("" if m.group(3) is None else
                     ", bf16 gates" if m.group(4) == "1" else ", fp32 gates")
            found.append(f"{m.group(1)}<{hp}{gates}>: " + "; ".join(props))
    return (" | ".join(found) or "no ptxas log (cached build)") + (
        f" | dynamic shared memory {ops.tc_smem(cfg)} B a CTA (K1 "
        f"{ops.tc_smem(cfg, 'mono')} B, K5b "
        f"{ops.tc_smem(cfg, 'pregemm')} B), {ops.tc_threads('merged', cfg.num_hidden)}"
        f" threads (K5b {ops.tc_threads('pregemm', cfg.num_hidden)})")


def k3_build_line() -> str:
    """ptxas's registers and spills of K3's kernels: the recurrence (Wh^T
    in shared memory or not, per storage type) and the products
    (gemm_kernel, one instantiation a tile shape and output)."""
    import re

    from deepmod_tpu_torch.ops import _build

    lines = _build.build_info["log"].splitlines()
    found = []
    for i, line in enumerate(lines):
        m = re.search(r"(train_bwd_kernelI(f|13__nv_bfloat16)Lb([01])E"
                      r"|gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E\w*?"
                      r"(Gates|Dx|Dw)Epi(?:I(f|13__nv))?)", line)
        if not (m and "Compiling entry" in line):
            continue
        props = [t.split("ptxas info    :")[-1].strip()
                 for t in lines[i + 1:i + 4] if "spill" in t or "registers" in t]
        if m.group(2):
            name = (f"recurrence<{'fp32' if m.group(2) == 'f' else 'bf16'}, "
                    f"Wh^T {'shared' if m.group(3) == '1' else 'global'}>")
        else:
            kind = ("" if m.group(9) is None else
                    ", fp32" if m.group(9) == "f" else ", bf16")
            name = (f"{m.group(8).lower()}<{m.group(4)}x{m.group(5)}, "
                    f"{m.group(6)}x{m.group(7)}{kind}>")
        found.append(f"{name}: " + "; ".join(props))
    return " | ".join(found) or "no ptxas log (cached build)"


def _close(got, want, precision: str) -> bool:
    if precision == "fp32":
        return float((got - want).abs().max()) <= 2e-5
    return torch.allclose(got, want, rtol=2e-2, atol=2e-3)


def phase_layered(device) -> dict:
    """K4 against its plain version: T=20 and T=31 at full width on
    CHECK_B random windows and on the window view of a TIME_B-row chunk,
    T=64 on LONG_B windows, K4 forced at T=21 against K1; kernel, plain
    and cuDNN times at TIME_B windows beside the bound of the cone's steps
    (which K4 runs) and the all-T bound (the plain version's steps); the
    fp32 core's sweep at T=20."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for precision in ("fp32", "bf16"):
        dt = ops.seq_dtype(precision)
        max_err = 0.0
        times = {}
        for timesteps in LAYERED_T:
            cfg = BiLSTMConfig(timesteps=timesteps)
            params = init_bilstm_params(SEED + timesteps, cfg, device=device)
            packed = ops.pack_bilstm_params(params, cfg, precision)
            rng = np.random.default_rng(SEED + timesteps)
            x_all = torch.from_numpy(rng.standard_normal(
                (TIME_B, timesteps, cfg.num_input), dtype=np.float32)).to(
                    device).to(dt)
            x = x_all[:CHECK_B]
            before = dict(ops.LAUNCHES)
            got = ops.bilstm_center_features(packed, x, cfg, precision)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == before, "K1 ran where K4 should"
            want = ops.bilstm_layered_plain(params, x, cfg, precision)
            assert torch.isfinite(got).all(), f"K4 {precision} T={timesteps}"
            err = float((got - want).abs().max())
            assert _close(got, want, precision), (
                f"K4 {precision} T={timesteps} vs plain: max abs {err}")
            # the detect path's shape: the window view of one row chunk
            rows = x_all[:, 0].contiguous()
            view = rows.as_strided(
                (TIME_B - timesteps + 1, timesteps, cfg.num_input),
                (cfg.num_input, cfg.num_input, 1))
            got_v = ops.bilstm_center_features(packed, view, cfg, precision)
            torch.cuda.synchronize()
            want_v = ops.bilstm_layered_plain(params, view, cfg, precision)
            err_v = float((got_v - want_v).abs().max())
            assert _close(got_v, want_v, precision), (
                f"K4 {precision} T={timesteps} window view: max abs {err_v}")
            max_err = max(max_err, err, err_v)
            lib = cudnn_lstms(params, cfg, precision, device)
            with torch.no_grad():
                lib_err = float((cudnn_center(lib, x, cfg) - want).abs().max())
            log(f"[K4 {precision}] T={timesteps} B={CHECK_B} max_abs_err="
                f"{err:.3e}; window view of {TIME_B} rows {err_v:.3e}; "
                f"cudnn-vs-plain max_abs={lib_err:.3e}")
            del rows, view, got_v, want_v, got, want

            ms = time_ms(lambda: ops.bilstm_center_features(
                packed, x_all, cfg, precision))
            plain_ms = time_ms(lambda: ops.bilstm_layered_plain(
                params, x_all, cfg, precision), reps=3)
            with torch.no_grad():
                lib_ms = time_ms(lambda: cudnn_center(lib, x_all, cfg))
            ms2 = time_ms(lambda: ops.bilstm_center_features(
                packed, x_all, cfg, precision))
            w_bytes = (packed.w.numel() * packed.w.element_size()
                       + packed.bias.numel() * 4)
            # the bound of the steps K4 runs (the cone), and of the all-T
            # steps the JAX kernel and the plain version run at even T
            b_ms, b_by = bound_ms(cfg, TIME_B, precision, w_bytes,
                                  layered=True)
            all_ms, _ = bound_ms(cfg, TIME_B, precision, w_bytes,
                                 layered=True, all_t=True)
            fl = flops_per_window(cfg, layered=True)
            log(f"[K4 {precision}] T={timesteps} B={TIME_B} kernel {ms:.3f} / "
                f"{ms2:.3f} ms, plain {plain_ms:.3f} ms, cudnn {lib_ms:.3f} "
                f"ms (the cone's steps), bound {b_ms:.3f} ms ({b_by}; the "
                f"cone's {lane_steps(cfg, layered=True)} steps a layer), "
                f"all-T bound {all_ms:.3f} ms; {fl} FLOP/window, "
                f"{fl * TIME_B / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
            if precision == "fp32" and timesteps == LAYERED_T[0]:
                log(f"[K4 fp32] T={timesteps} {f32_sweep_line(cfg, lambda t: ops.bilstm_center_features(packed, x_all, cfg, precision, tile_b=t), device)}")
            times[timesteps] = dict(ms=ms, ms_repeat=ms2, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=b_by, all_t_bound_ms=all_ms)
            del x_all, x, lib
            torch.cuda.empty_cache()

        # the step loop past 32 steps, and K4 forced where K1 runs
        cfg = BiLSTMConfig(timesteps=64)
        params = init_bilstm_params(SEED + 64, cfg, device=device)
        x = torch.from_numpy(np.random.default_rng(SEED + 64).standard_normal(
            (LONG_B, 64, cfg.num_input), dtype=np.float32)).to(device).to(dt)
        got = ops.bilstm_center_features(params, x, cfg, precision)
        torch.cuda.synchronize()
        want = ops.bilstm_layered_plain(params, x, cfg, precision)
        err64 = float((got - want).abs().max())
        assert _close(got, want, precision), f"K4 {precision} T=64: {err64}"
        cfg = BiLSTMConfig()
        params = init_bilstm_params(SEED, cfg, device=device)
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (LONG_B, 21, cfg.num_input), dtype=np.float32)).to(device).to(dt)
        k4 = ops.bilstm_center_features(params, x, cfg, precision, mono=False)
        k1 = ops.bilstm_center_features(params, x, cfg, precision)
        torch.cuda.synchronize()
        err21 = float((k4 - k1).abs().max())
        assert _close(k4, k1, precision), f"K4 vs K1 {precision} T=21: {err21}"
        log(f"[K4 {precision}] T=64 B={LONG_B} max_abs_err={err64:.3e}; "
            f"mono=False vs K1 at T=21: max abs {err21:.3e}")
        results[precision] = dict(times[LAYERED_T[0]],
                                  max_abs_err=max(max_err, err64))
    return results


# K6's launches timed at TIME_B windows, H=100: (split, tile)
K6_SWEEP = ((1, 8), (1, 16), (2, 16), (2, 24), (2, 32), (2, 40), (4, 32),
            (4, 48), (4, 64), (4, 80))
# K6's checks against its plain version: (hidden, directions)
K6_WIDTHS = ((100, (False, True)), (128, (False, True)), (170, (False,)))


def _k6_layer(hidden: int, seed: int, device):
    """The fw lane's first layer of a seeded model at this width, biases
    0.1 x N(0, 1) (the initializer's are zero)."""
    from deepmod_tpu_torch.models import bilstm as model

    cfg = model.BiLSTMConfig(num_hidden=hidden)
    params = model.init_bilstm_params(seed, cfg, device=device)
    gen = torch.Generator().manual_seed(seed)
    for lane in ("fw", "bw"):
        for lp in params[lane]:
            lp["bias"] = (0.1 * torch.randn(lp["bias"].shape,
                                            generator=gen)).to(device)
    return cfg, params


def phase_lstm_layer(device) -> dict:
    """K6 against its plain version at T=21 on CHECK_B windows, both
    directions at H=100 and 128 and one at H=170; its main path, the
    model's one-direction stacks (``_stack_direction``), against K1's
    center features; at TIME_B windows and H=100 a split x tile sweep with
    the clusters resident, and the kernel's time beside the whole call's
    (the packing of W_h included), the plain version's and a one-layer
    cuDNN LSTM's."""
    from deepmod_tpu_torch.models import bilstm as model
    from deepmod_tpu_torch.ops import bilstm_fused as k1
    from deepmod_tpu_torch.ops import lstm_layer as k6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _k6_layer(100, SEED + 6, device)
    x = torch.from_numpy(np.random.default_rng(SEED + 6).standard_normal(
        (TIME_B, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(device)
    fb = cfg.forget_bias
    err = 0.0
    for hidden, directions in K6_WIDTHS:
        _, wparams = ((cfg, params) if hidden == 100 else
                      _k6_layer(hidden, SEED + hidden, device))
        lp = wparams["fw"][0]
        w_h = lp["kernel"][cfg.num_input:].contiguous()
        xp = k6.project(lp["kernel"], lp["bias"], x[:CHECK_B])
        for reverse in directions:
            got = k6.lstm_recurrence(xp, w_h, fb, reverse)
            torch.cuda.synchronize()
            want = k6.lstm_recurrence_plain(xp, w_h, fb, reverse)
            e = float((got - want).abs().max())
            assert torch.isfinite(got).all() and e <= 1e-5, (
                f"K6 H={hidden} reverse={reverse} vs plain: max abs {e}")
            err = max(err, e)
            log(f"[K6] H={hidden} reverse={reverse} B={CHECK_B} at "
                f"{k6.lstm_layer_shape(hidden)}: max_abs_err {e:.3e}")
        del xp, got, want
    torch.cuda.empty_cache()

    # the main path: counts from 0 just before, read just after
    k6.reset_launch_counts()
    xm = x[:CHECK_B]
    fw = model._stack_direction(params["fw"], xm, fb, False)
    bw = model._stack_direction(params["bw"], xm, fb, True)
    torch.cuda.synchronize()
    launches = k6.LAUNCHES["fp32"]
    assert launches == 2 * cfg.num_layers, launches
    c = cfg.center
    feats = torch.cat([fw[:, c], bw[:, c]], dim=1)
    ref = k1.bilstm_center_features(params, xm, cfg, "fp32")
    torch.cuda.synchronize()
    e_model = float((feats - ref).abs().max())
    assert e_model <= 2e-5, f"stacks through K6 vs K1: max abs {e_model}"
    log(f"[K6] T={cfg.timesteps} B={CHECK_B} max_abs_err={err:.3e} (both "
        f"directions at H=100 and 128, fw at 170); main path: {launches} "
        f"launches, stacks vs K1 center features max abs {e_model:.3e}")
    del fw, bw, feats, ref

    lp = params["fw"][0]
    w_h = lp["kernel"][cfg.num_input:].contiguous()
    xp = k6.project(lp["kernel"], lp["bias"], x)
    wp = k6.pack_wh(w_h)
    h = cfg.num_hidden
    swept = []
    for split, tile in K6_SWEEP:
        shape = k6.lstm_layer_shape(h, tile, split)
        t_ms = time_ms(lambda: k6.recurrence_packed(xp, wp, fb, False, shape),
                       reps=3)
        swept.append(f"split {split} tile {tile} ({shape.threads} threads, "
                     f"{shape.smem} B, "
                     f"{k6.lstm_layer_clusters(h, shape, device)} clusters): "
                     f"{t_ms:.3f}")
    log(f"[K6] H={h} B={TIME_B} sweep (ms): " + "; ".join(swept))
    shape = k6.lstm_layer_shape(h)
    ms = time_ms(lambda: k6.recurrence_packed(xp, wp, fb, False, shape))
    call_ms = time_ms(lambda: k6.lstm_recurrence(xp, w_h, fb, False))
    plain_ms = time_ms(lambda: k6.lstm_recurrence_plain(xp, w_h, fb, False))
    lstm = torch.nn.LSTM(cfg.num_input, cfg.num_hidden, 1,
                         batch_first=True).to(device).eval()
    with torch.no_grad():
        lib_ms = time_ms(lambda: lstm(x))
    ms2 = time_ms(lambda: k6.recurrence_packed(xp, wp, fb, False, shape))
    flops = 2 * h * 4 * h * cfg.timesteps * TIME_B
    nbytes = _nbytes(xp, w_h) + TIME_B * cfg.timesteps * h * 4
    b_ms, b_by = train_bound_ms(flops, nbytes)
    log(f"[K6] B={TIME_B} at {shape}: kernel {ms:.3f} / {ms2:.3f} ms, the "
        f"call (W_h packed) {call_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"cudnn 1-layer LSTM (projection included) {lib_ms:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}; ops "
        f"{flops / PEAK_OPS['fp32'] * 1e3:.3f} ms, bytes "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms)")
    return dict(max_abs_err=max(err, e_model), ms=ms, ms_repeat=ms2,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, launches=launches)


def _sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def probe_loop_counts(lib_path: str) -> dict:
    """Per probe kernel (mangled name), the SASS instructions of its step
    loop and how many of them are MUFU (special-function unit) ops, from
    ``cuobjdump -sass`` of the built library: the span from the target of
    the last backward branch to that branch."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "probe_kernel" not in name:
            continue
        instr = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                instr.append((int(m.group(1), 16), m.group(2).strip()))
        loop = None
        for addr, text in instr:
            m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)?", text)
            if "BRA" in text and m and m.group(1):
                target = int(m.group(1), 16)
                if target < addr:
                    loop = (target, addr)
        if loop is None:
            continue
        body = [t for a, t in instr if loop[0] <= a <= loop[1]]
        counts[name] = (len(body), sum("MUFU" in t for t in body))
    return counts


# K1, K5a, K4, K5b, K5c
TC_KINDS = ("center", "merged", "layer", "pregemm", "wavefront")
TC_HP = tuple(range(8, 129, 8))  # the padded widths instantiated


def tensor_core_sass(lib_path: str) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each bf16 kernel of K1, K4
    and K5a-c (``cuobjdump -sass`` of the built library), by mangled name;
    every template (Hp 8-128) of the tensor-core kernels must issue them
    and no bf16 CUDA-core body of any of them may be left. K1's, K4's,
    K5a's and K5c's fp32 bodies and K6's are the fp32 core's three
    templates each (split 1, 2, 4), K5b's six (a split and gate dtype),
    and their old CUDA-core bodies are gone."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"bilstm_(center|merged|layer|pregemm|wavefront)_"
                      r"(tc_kernelILi\d+E(?:Lb[01]E)?|(?:mono_)?kernelI13__nv)",
                      name)
        if m:
            counts[m.group(1) + "_" + m.group(2)] = block.count("HGMMA")
    old = [k for k in counts if "kernelI13__nv" in k]
    assert not old, f"bf16 CUDA-core bodies left: {old}"
    for kind in ("bilstm_center", "bilstm_layer", "bilstm_merged",
                 "bilstm_wavefront", "lstm_recurrence"):
        for split in (1, 2, 4):
            name = f"{kind}_f32_kernelILi{split}E"
            assert name in sass, f"the fp32 core's {name} is missing"
    for split in (1, 2, 4):
        for gates in ("f", "13__nv_bfloat16"):
            name = f"bilstm_pregemm_f32_kernelILi{split}E{gates}E"
            assert name in sass, f"the fp32 core's {name} is missing"
    for old_body in ("bilstm_center_mono_kernel", "bilstm_layer_kernelI",
                     "bilstm_merged_kernelI", "bilstm_pregemm_kernelI",
                     "bilstm_wavefront_kernelI", "lstm_layer_kernel"):
        assert old_body not in sass, f"the old fp32 body {old_body} is left"
    for kind in TC_KINDS:
        tc = {k: v for k, v in counts.items() if k.startswith(kind + "_tc")}
        # K5b: one template a gate dtype (Lb0E fp32, Lb1E bf16)
        flags = ("Lb0E", "Lb1E") if kind == "pregemm" else ("",)
        want = {f"{kind}_tc_kernelILi{hp}E{f}" for hp in TC_HP for f in flags}
        assert set(tc) == want and all(v > 0 for v in tc.values()), (
            kind, counts)
    return counts


def phase_probe(device, lib_path: str) -> dict:
    """P1 against its plain version at K=256 (fp32 rtol 1e-5, bf16 within
    one bf16 ulp of the value); the probe's entry point as the main path;
    tanh at K=2048 timed beside the plain loop and the bound that the
    loop's SASS instruction count sets at the card's issue rates."""
    from deepmod_tpu_torch.tools import probe_transcendental as p1

    errs = {}
    for precision in ("fp32", "bf16"):
        errs[precision] = 0.0
        for op in p1.OPS:
            x = p1.probe_input(precision, device)
            got = p1.probe(x, op, 256).float()
            torch.cuda.synchronize()
            want = p1.probe_plain(x, op, 256).float()
            assert torch.isfinite(got).all(), (op, precision)
            if precision == "fp32":
                assert torch.allclose(got, want, rtol=1e-5, atol=0), (
                    op, float((got - want).abs().max()))
            else:
                ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
                assert bool(((got - want).abs() <= ulp).all()), (
                    op, float((got - want).abs().max()))
            errs[precision] = max(errs[precision],
                                  float((got - want).abs().max()))
    log("[P1] kernel vs plain at K=256: all ops, fp32 rtol 1e-5, bf16 "
        "within 1 ulp")

    # the main path: the probe's entry point, counts from 0 around it
    p1.reset_launch_counts()
    assert p1.main(["--reps", "5"]) == 0
    torch.cuda.synchronize()
    launches = dict(p1.LAUNCHES)
    assert launches["fp32"] > 0 and launches["bf16"] > 0, launches
    log(f"[P1] entry point launches: {launches}")

    counts = probe_loop_counts(lib_path)
    clock = _sm_clock_hz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"[P1] SASS step loops (instructions, MUFU): {counts}; "
        f"{sms} SMs at {clock / 1e6:.0f} MHz max")
    results = {}
    n = p1.SHAPE[0] * p1.SHAPE[1]
    for precision in ("fp32", "bf16"):
        rates = {op: {k: p1.rate(op, precision, k, device, reps=10)
                      ["ops_per_s"] for k in p1.ITERS} for op in p1.OPS}
        x = p1.probe_input(precision, device)
        k = p1.ITERS[-1]
        ms = time_ms(lambda: p1.probe(x, "tanh", k))
        plain_ms = time_ms(lambda: p1.probe_plain(x, "tanh", k), reps=3)
        code = "f" if precision == "fp32" else "13__nv_bfloat16"
        key = next((name for name in counts
                    if f"probe_kernelI{code}Li0E" in name), None)
        assert key is not None, f"no tanh loop found in the SASS: {counts}"
        n_instr, n_mufu = counts[key]
        # issue: 4 warp-instructions a clock an SM (128 thread ops); MUFU:
        # 16 lanes a clock an SM
        cycles = max(n_instr / 128, n_mufu / 16)
        b_ops = n * k * cycles / (sms * clock) * 1e3
        b_bytes = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        log(f"[P1 {precision}] rates (Gop/s): " + "; ".join(
            f"{op} " + " ".join(f"K={kk}: {r / 1e9:.2f}" for kk, r in rk.items())
            for op, rk in rates.items())
            + f"; tanh K={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(b_ops, b_bytes):.4f} ms ({n_instr} instructions, "
            f"{n_mufu} MUFU a step; bound rate {n * k / b_ops / 1e6:.2f} "
            "Gop/s)")
        results[precision] = dict(
            max_abs_err=errs[precision], ms=ms, plain_ms=plain_ms,
            library_ms=None,
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes")
    for precision in ("fp32", "bf16"):
        results[precision]["launches"] = launches[precision]
    return results


# K5a-c through bilstm_center_mono's flags: (label, flags)
SCHEDULE_CASES = (
    ("merged", dict(merged_gemm=True)),
    ("pregemm", dict(pregemm=True)),
    ("pregemm bf16 gates", dict(pregemm=True, gate_store="bf16")),
    ("wavefront", dict(wavefront=True)),
)
PROBE_B = 32768  # --batch of the probe tools' runs
BIG_ROWS = 4194304  # rows of the feature block fp32 K5b runs over once


def same_bits_as_k1(label: str, precision: str) -> bool:
    """fp32 K5a-c (K5b with fp32 gates): K1 fp32's chains on the fp32
    core, so K1's bits."""
    return precision == "fp32" and label in ("merged", "pregemm",
                                             "wavefront")


def sweep_tiles(schedule: str, precision: str) -> tuple:
    """The tiles phase 14 times a schedule at: none for a tensor-core
    kernel (64 only), the fp32 core's F32_SWEEP for K5a and K5b in fp32;
    K5c fp32's sweep is ``wavefront_f32_line``'s (both grids)."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    if ops.tensor_core(schedule, precision) or schedule == "wavefront":
        return ()
    return F32_SWEEP


def wavefront_f32_line(cfg, packed, x, device) -> str:
    """fp32 K5c at each tile of F32_SWEEP in both forms, in turns: the
    streamed grid (``f32_slots``: the clusters resident) and a
    cluster a tile-lane (one an item); the clusters of
    num_layers x split CTAs the card holds at once, here and at H=128
    (12 CTAs with 3 layers)."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    got = []
    batch = x.shape[0]
    for tile in F32_SWEEP:
        shape = ops.f32_schedule_shape(cfg.num_input, cfg.num_hidden,
                                       "wavefront", tile)
        resident = ops.wavefront_f32_clusters(cfg, shape, device)
        items = 2 * -(-batch // shape.tile)
        forms = {}
        for name, slots in (("streamed", None), ("per item", items)):
            forms[name] = time_ms(lambda: ops._launch_mono_f32(
                packed, x, cfg, tile, "wavefront", slots=slots), reps=3)
        got.append(
            f"tile {tile}, split {shape.split} ({cfg.num_layers * shape.split}"
            f"-CTA clusters, {resident} resident, "
            f"{ops.f32_slots(batch, shape.tile, resident)} slots): "
            f"streamed {forms['streamed']:.3f}, a cluster a tile-lane "
            f"{forms['per item']:.3f}")
    wide = BiLSTMConfig(num_hidden=128, num_layers=cfg.num_layers)
    wshape = ops.f32_schedule_shape(wide.num_input, 128, "wavefront")
    return (f"fp32 K5c at H={cfg.num_hidden} B={batch} (ms): "
            + "; ".join(got) + f" | H=128 at {wshape}: "
            f"{wide.num_layers * wshape.split}-CTA clusters, "
            f"{ops.wavefront_f32_clusters(wide, wshape, device)} resident")


def pregemm_f32_line(cfg, batch: int, device) -> str:
    """fp32 K5b's persistent grid at ``batch`` windows: its shape, the
    clusters the card holds at once, the slots and the workspace bytes
    (both gate stores)."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    shape = ops.f32_schedule_shape(cfg.num_input, cfg.num_hidden, "pregemm",
                                   ops.SCHEDULE_TILE_B["pregemm"]["fp32"])
    got = []
    for gates in ("fp32", "bf16"):
        resident = ops.pregemm_f32_clusters(cfg, shape, gates, device)
        slots = ops.f32_slots(batch, shape.tile, resident)
        got.append(f"{gates} gates: {resident} clusters resident, {slots} "
                   f"slots, workspace "
                   f"{ops.pregemm_f32_bytes(cfg, shape, slots, gates)} B")
    return (f"fp32 K5b at H={cfg.num_hidden} B={batch}, {shape}: "
            + "; ".join(got))


def phase_schedules(device, k1: dict) -> dict:
    """K5a, K5b (fp32 and bf16 gates) and K5c against their plain versions
    at full width on CHECK_B random windows and on the window view of a
    TIME_B-row chunk (phase 3's inputs), each against K1 on the same input;
    kernel and plain times at TIME_B windows with a tile sweep, beside K1's
    bound and cuDNN time (the same function); the main paths: K5c through
    bilstm_center_mono(wavefront=True) on the window view, K5a and K5b
    through their probe tools' main at PROBE_B windows."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.tools import probe_merged_gemm, probe_mono, probe_pregemm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BiLSTMConfig()
    params = init_bilstm_params(SEED, cfg, device=device)
    x_all = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (TIME_B, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(device)
    results = {}
    for precision in ("fp32", "bf16"):
        dt = ops.seq_dtype(precision)
        packed = ops.pack_bilstm_params(params, cfg, precision)
        rows = x_all[:, 0].to(dt).contiguous()
        inputs = {
            "random": x_all[:CHECK_B].to(dt).contiguous(),
            "view": rows.as_strided(
                (TIME_B - cfg.timesteps + 1, cfg.timesteps, cfg.num_input),
                (cfg.num_input, cfg.num_input, 1)),
        }
        k1_out = {k: ops.bilstm_center_features(packed, v, cfg, precision)
                  for k, v in inputs.items()}
        wants = {}
        res = results[precision] = {}
        for label, flags in SCHEDULE_CASES:
            gates = flags.get("gate_store", "fp32")
            tol = "bf16" if gates == "bf16" else precision
            err = vs_k1 = 0.0
            for which, inp in inputs.items():
                got = ops.bilstm_center_mono(packed, inp, cfg, precision, **flags)
                torch.cuda.synchronize()
                if (which, gates) not in wants:
                    wants[which, gates] = ops.bilstm_center_plain(
                        params, inp, cfg, precision, gate_store=gates)
                want = wants[which, gates]
                assert torch.isfinite(got).all(), f"{label} {precision}"
                e = float((got - want).abs().max())
                assert _close(got, want, tol), (
                    f"{label} {precision} {which} vs plain: max abs {e}")
                err = max(err, e)
                vs_k1 = max(vs_k1, float((got - k1_out[which]).abs().max()))
                assert _close(got, k1_out[which], tol), (
                    f"{label} {precision} {which} vs K1: max abs {vs_k1}")
                # fp32 K5a-c (K5b with fp32 gates) run K1's fmaf chains on
                # the fp32 core: K1's bits
                if same_bits_as_k1(label, precision):
                    assert torch.equal(got, k1_out[which]), (
                        f"{label} fp32 {which}: not K1 fp32's bits "
                        f"(max abs {vs_k1})")
                del got
            res[label] = dict(max_abs_err=err, vs_k1=vs_k1)
            log(f"[K5 {precision}] {label}: max_abs_err vs plain {err:.3e} "
                f"({tol} tolerance) on {CHECK_B} random windows and the "
                f"window view of {TIME_B} rows; max abs vs K1 {vs_k1:.3e}"
                + ("; K1's bits (torch.equal) on both"
                   if same_bits_as_k1(label, precision) else ""))
        del wants, k1_out

        # the main path of K5c: its public entry point on the detect shape
        ops.reset_launch_counts()
        wave = ops.bilstm_center_mono(packed, inputs["view"], cfg, precision,
                                      wavefront=True)
        pred = torch.argmax(wave @ params["out_w"] + params["out_b"], dim=1)
        torch.cuda.synchronize()
        res["wavefront"]["launches"] = ops.MONO_SCHEDULE_LAUNCHES["wavefront"][precision]
        assert res["wavefront"]["launches"] == 1, ops.MONO_SCHEDULE_LAUNCHES
        assert pred.shape == (TIME_B - cfg.timesteps + 1,)
        del inputs, rows, wave, pred
        if precision == "bf16":
            log(f"[K5 bf16] {tc_shape_line(cfg, TIME_B, device)}")

        xt = x_all.to(dt).contiguous()
        plain = {g: time_ms(lambda: ops.bilstm_center_plain(
            params, xt, cfg, precision, gate_store=g), reps=3)
            for g in ("fp32", "bf16")}
        w_bytes = packed.w.numel() * packed.w.element_size() + packed.bias.numel() * 4
        b_ms, b_by = bound_ms(cfg, TIME_B, precision, w_bytes)
        if precision == "fp32":
            log(f"[K5 fp32] {wavefront_f32_line(cfg, packed, xt, device)}")
        for label, flags in SCHEDULE_CASES:
            schedule = ops.mono_schedule(cfg, **flags)
            ms = time_ms(lambda: ops.bilstm_center_mono(
                packed, xt, cfg, precision, **flags))
            tiles = {}
            # the tensor-core kernel takes one tile, 64: no sweep; the fp32
            # core's schedules sweep its tiles (2- and 4-CTA clusters)
            for tile in sweep_tiles(schedule, precision):
                threads, most, smem = ops.mono_block(cfg, schedule, tile, precision)
                if threads <= most and smem <= ops.MAX_SMEM:
                    tiles[tile] = round(time_ms(lambda: ops.bilstm_center_mono(
                        packed, xt, cfg, precision, tile_b=tile, **flags)), 3)
            plain_ms = plain[flags.get("gate_store", "fp32")]
            res[label].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=k1[precision]["library_ms"])
            log(f"[K5 {precision}] {label} B={TIME_B} kernel {ms:.3f} ms at "
                f"tile {ops.SCHEDULE_TILE_B[schedule][precision]}, sweep (ms) "
                f"{tiles}; plain "
                f"{plain_ms:.3f} ms; K1 {k1[precision]['ms']:.3f} ms; bound "
                f"{b_ms:.3f} ms ({b_by}) and cudnn "
                f"{k1[precision]['library_ms']:.3f} ms are K1's (same function, "
                f"cudnn from phase 3); "
                f"{flops_per_window(cfg) * TIME_B / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        del xt
        torch.cuda.empty_cache()
        if precision == "fp32":
            res["big_view"] = phase_big_view(cfg, params, packed, device)

    # the main paths of K5a and K5b: their probe tools, counts from 0 just
    # before each, read just after
    for tool, schedule in ((probe_merged_gemm, "merged"),
                           (probe_pregemm, "pregemm"), (probe_mono, None)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        assert tool.main(["--batch", str(PROBE_B)]) == 0
        torch.cuda.synchronize()
        counts = dict(ops.MONO_SCHEDULE_LAUNCHES[schedule]) if schedule else {
            "K1": dict(ops.LAUNCHES), "K4": dict(ops.LAYERED_LAUNCHES)}
        log(f"[K5] {tool.__name__.rsplit('.', 1)[1]} --batch {PROBE_B}: "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        if schedule is None:
            assert all(counts["K1"].values()) and all(counts["K4"].values()), counts
            continue
        assert all(counts.values()), counts
        for label, flags in SCHEDULE_CASES:
            if ops.mono_schedule(cfg, **flags) == schedule:
                for precision in ("fp32", "bf16"):
                    results[precision][label]["launches"] = counts[precision]
    return results


def phase_big_view(cfg, params, packed, device) -> dict:
    """fp32 K5b (fp32 gates) once over the window view of a BIG_ROWS-row
    feature block (117 MB of fp32 rows): its workspace is the card's, not
    the batch's; finite output whose first and last CHECK_B windows hold
    K1 fp32's bits on the same windows."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    rows = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (BIG_ROWS, cfg.num_input), dtype=np.float32)).to(device)
    n = BIG_ROWS - cfg.timesteps + 1
    view = rows.as_strided((n, cfg.timesteps, cfg.num_input),
                           (cfg.num_input, cfg.num_input, 1))
    for batch in (TIME_B, n):
        log(f"[K5 fp32] {pregemm_f32_line(cfg, batch, device)}")
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = ops.bilstm_center_mono(packed, view, cfg, "fp32", pregemm=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(device) - base
    assert got.shape == (n, 2 * cfg.num_hidden)
    assert torch.isfinite(got).all(), "fp32 K5b over the big view"
    for part in (slice(0, CHECK_B), slice(n - CHECK_B, n)):
        k1 = ops.bilstm_center_features(packed, view[part], cfg, "fp32")
        torch.cuda.synchronize()
        assert torch.equal(got[part], k1), (
            f"fp32 K5b over {BIG_ROWS} rows vs K1 on windows {part}")
    log(f"[K5 fp32] pregemm over the window view of {BIG_ROWS} rows "
        f"({BIG_ROWS * cfg.num_input * 4} B of rows, {n} windows): "
        f"{ms:.3f} ms; device memory beyond the inputs {peak} B (the (B, 2H) "
        f"output {got.numel() * 4} B); the first and last {CHECK_B} windows "
        f"K1's bits")
    del rows, view, got
    torch.cuda.empty_cache()
    return dict(ms=ms, windows=n, peak_bytes=peak)


def tc_shape_line(cfg, batch: int, device) -> str:
    """bf16 K5b's persistent grid and its workspace bytes at ``batch``
    windows (gate buffer in fp32 and in bf16, the inter-layer rows), and
    cudaOccupancyMaxActiveClusters of bf16 K5a and K5c at ``cfg``."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    hp = ops.tc_dims(1, cfg.num_hidden)[0]
    steps = cfg.timesteps // 2 + 1
    slots = ops.pregemm_slots(batch, cfg.num_input, cfg.num_hidden, "fp32",
                              device)
    assert slots == ops.pregemm_slots(batch, cfg.num_input, cfg.num_hidden,
                                      "bf16", device)
    gates = slots * steps * ops.TC_THREADS * hp
    rows = slots * steps * ops.TC_TILE_B * hp * 2
    split = ops.tc_split(cfg.num_hidden)
    return (f"H={cfg.num_hidden} B={batch}: K5b grid {slots} slots, gate "
            f"workspace {gates * 4} B fp32 / {gates * 2} B bf16, rows "
            f"{rows} B; clusters resident: K5a ({split} CTA a cluster) "
            f"{ops.tc_clusters('merged', cfg, device)}, K5c "
            f"({split * cfg.num_layers} CTAs a cluster) "
            f"{ops.tc_clusters('wavefront', cfg, device)}")


WIDE_B = 32768  # windows of the hidden-128 check


def phase_hidden_128(device) -> dict:
    """Hidden 128, 3 layers, WIDE_B windows, each kernel against its plain
    version: bf16 (Hp 128: K1, K4, K5a and K5c split each layer-lane over
    a 2-CTA cluster; K5b keeps one weight resident) K4 at T=20 and forced
    at T=21, K1, K5a, K5b (both gate stores) and K5c at T=21; fp32 (the
    fp32 core's 4-CTA clusters; K5c's 12-CTA ones) K4 at T=20 and forced
    at T=21, and K1, K5a-c (K5b with both gate stores) at T=21, K5a-c
    (fp32 gates) also K1's bits on the random windows and a window view;
    kernel, plain and cuDNN times at that width beside the bound."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for timesteps in (21, 20):
        cfg = BiLSTMConfig(num_hidden=128, timesteps=timesteps)
        params = init_bilstm_params(SEED + 128 + timesteps, cfg, device=device)
        for precision in ("bf16", "fp32"):
            packed = ops.pack_bilstm_params(params, cfg, precision)
            x = torch.from_numpy(np.random.default_rng(SEED + timesteps)
                                 .standard_normal((WIDE_B, timesteps,
                                                   cfg.num_input),
                                                  dtype=np.float32)).to(
                device).to(ops.seq_dtype(precision))
            lib = cudnn_lstms(params, cfg, precision, device)
            with torch.no_grad():
                lib_ms = time_ms(lambda: cudnn_center(lib, x, cfg))
            w_bytes = (packed.w.numel() * packed.w.element_size()
                       + packed.bias.numel() * 4)
            cases = [("K4", lambda: ops.bilstm_center_features(
                packed, x, cfg, precision, mono=False),
                lambda: ops.bilstm_layered_plain(params, x, cfg, precision),
                True)]
            if timesteps % 2 == 1:
                cases.append(("K1", lambda: ops.bilstm_center_features(
                    packed, x, cfg, precision),
                    lambda: ops.bilstm_center_plain(params, x, cfg, precision),
                    False))
            if timesteps % 2 == 1:
                # K5a-c (fp32: the fp32 core's 4-CTA clusters, K5c's of 12)
                for label, flags in SCHEDULE_CASES:
                    cases.append((label, lambda f=flags: ops.bilstm_center_mono(
                        packed, x, cfg, precision, **f),
                        lambda f=flags: ops.bilstm_center_plain(
                            params, x, cfg, precision,
                            gate_store=f.get("gate_store", "fp32")), False))
            for label, kernel, plain, layered in cases:
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                assert torch.isfinite(got).all(), (
                    f"{label} {precision} H=128 T={timesteps}")
                err = float((got - want).abs().max())
                tol = "bf16" if "bf16 gates" in label else precision
                assert _close(got, want, tol), (
                    f"{label} {precision} H=128 T={timesteps} vs plain: "
                    f"max abs {err}")
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, reps=3)
                b_ms, b_by = bound_ms(cfg, WIDE_B, precision, w_bytes,
                                      layered=layered)
                log(f"[H128 {precision}] {label} T={timesteps} B={WIDE_B}: "
                    f"max_abs_err {err:.3e}; kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, cudnn {lib_ms:.3f} ms, bound "
                    f"{b_ms:.3f} ms ({b_by})")
                results[label, precision, timesteps] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms)
            if timesteps == 21 and precision == "bf16":
                log(f"[H128 bf16] {tc_shape_line(cfg, WIDE_B, device)}")
            if timesteps == 21 and precision == "fp32":
                shape = ops.f32_shape(cfg.num_input, cfg.num_hidden)
                assert shape.split == 4, shape
                log(f"[H128 fp32] the fp32 core at {shape}: "
                    f"{ops.f32_clusters(cfg, shape, device)} clusters of "
                    f"{shape.split} CTAs resident; "
                    f"{pregemm_f32_line(cfg, WIDE_B, device)}")
                wshape = ops.f32_schedule_shape(cfg.num_input, 128,
                                                "wavefront")
                log(f"[H128 fp32] K5c: {cfg.num_layers * wshape.split}-CTA "
                    f"clusters, {ops.wavefront_f32_clusters(cfg, wshape, device)}"
                    f" resident")
                # K5a-c (K5b with fp32 gates): K1 fp32's bits, on the random
                # windows and on the window view of a row block
                rows = x[:, 0].contiguous()
                view = rows.as_strided(
                    (WIDE_B - timesteps + 1, timesteps, cfg.num_input),
                    (cfg.num_input, cfg.num_input, 1))
                for inp in (x, view):
                    k1 = ops.bilstm_center_features(packed, inp, cfg, "fp32")
                    for label, flags in SCHEDULE_CASES:
                        if not same_bits_as_k1(label, "fp32"):
                            continue
                        got = ops.bilstm_center_mono(packed, inp, cfg, "fp32",
                                                     **flags)
                        torch.cuda.synchronize()
                        assert torch.equal(got, k1), (
                            f"H=128 fp32 {label}: not K1 fp32's bits")
                log("[H128 fp32] K5a-c (K5b with fp32 gates): K1's bits "
                    "(torch.equal) on the random windows and on the window "
                    "view")
                del rows, view, k1, got
            del x, lib
            torch.cuda.empty_cache()
    return results


def train_cost_per_window(cfg) -> tuple:
    """(K2, K3) FLOP per window: multiply-adds x2 over both lanes and the
    steps each layer runs. K3 counts the gate recompute, the dh/dx
    products and the [x; h; 1] x da weight-gradient product."""
    from deepmod_tpu_torch.ops.bilstm_fused import readout

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


# K2's extra checks beside the train batch's: (batch, T, hidden); odd T
# runs the readout cone, even T all T steps
K2_CASES = ((2048, 20, 100), (37, 8, 100), (5, 21, 100), (5, 8, 100),
            (2048, 21, 128), (2083, 20, 128), (37, 8, 128))
# K2's launches the sweep times at H=100: (split, tile)
K2_SWEEP = ((2, 16), (2, 24), (2, 32), (2, 40), (4, 32), (4, 48), (4, 64),
            (4, 80))


def _train_params(cfg, seed, device):
    """Random weights from ``seed`` with a random bias (the init's bias
    is zero but for nothing)."""
    from deepmod_tpu_torch.models.bilstm import init_bilstm_params

    params = init_bilstm_params(seed, cfg, device=device)
    gen = torch.Generator().manual_seed(seed)
    for lane in ("fw", "bw"):
        for lp in params[lane]:
            lp["bias"] = (0.1 * torch.randn(lp["bias"].shape,
                                            generator=gen)).to(device)
    return params


def _k2_check(xin, weights, fb, precision: str, what: str) -> float:
    """K2 against its plain version on the same inputs (fp32 max abs
    2e-5; bf16 atol 2e-3 + rtol 2e-2), and a second run with the same
    bits; returns the max abs error."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    hs, cs = tr.train_fwd(xin, weights, fb)
    hs2, cs2 = tr.train_fwd(xin, weights, fb)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2), (
        f"K2 {precision} {what}: two runs differ")
    hs_p, cs_p = tr.train_fwd_plain(xin, weights, fb)
    err = 0.0
    for got, want in ((hs, hs_p), (cs, cs_p)):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"K2 {precision} {what}: non-finite"
        err = max(err, float((got - want).abs().max()))
        if precision == "fp32":
            assert err <= 2e-5, f"K2 fp32 {what}: max abs {err}"
        else:
            assert torch.allclose(got, want, rtol=2e-2, atol=2e-3), (
                f"K2 bf16 {what}: max abs {err}")
    return err


def k2_cases_line(precision: str, device) -> tuple:
    """K2 at each of K2_CASES against its plain version, twice with the
    same bits: (max abs error, log line)."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    worst, parts = 0.0, []
    for batch, timesteps, hidden in K2_CASES:
        cfg = BiLSTMConfig(num_hidden=hidden, timesteps=timesteps)
        params = _train_params(cfg, SEED + hidden + timesteps, device)
        _, xin, weights, _ = _train_inputs(cfg, params, batch, precision,
                                           device)
        shape = tr.fwd_shape(cfg.num_input, hidden)
        err = _k2_check(xin, weights, cfg.forget_bias, precision,
                        f"B={batch} T={timesteps} H={hidden}")
        worst = max(worst, err)
        parts.append(f"B={batch} T={timesteps} H={hidden} (split "
                     f"{shape.split}, tile {shape.tile}) {err:.3e}")
    return worst, (f"[K2 {precision}] vs plain, twice the same bits: "
                   + "; ".join(parts))


def k2_sweep_line(cfg, params, precision: str, device) -> str:
    """K2 at each launch of K2_SWEEP at batch 2048 and 2083 (H=100): its
    threads, shared memory, the clusters the card holds at once, the
    clusters the batch needs and the waves they make, and the time."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    out = []
    for batch in (TRAIN_B, TRAIN_B + 35):
        _, xin, weights, _ = _train_inputs(cfg, params, batch, precision,
                                           device)
        got = []
        for split, tile in K2_SWEEP:
            shape = tr.fwd_shape(cfg.num_input, cfg.num_hidden, tile, split)
            resident = tr.fwd_clusters(cfg.num_input, cfg.num_hidden, shape,
                                       device)
            need = 2 * -(-batch // tile)
            ms = time_ms(lambda: tr.train_fwd(xin, weights, cfg.forget_bias,
                                              tile, split))
            got.append(f"split {split} tile {tile} ({shape.threads} "
                       f"threads, {shape.smem} B, {resident} resident, "
                       f"{need} needed, {need / resident:.2f} waves): "
                       f"{ms:.4f}")
        out.append(f"B={batch}: " + "; ".join(got))
    return (f"[K2 {precision}] shape sweep (ms; default "
            f"{tr.fwd_shape(cfg.num_input, cfg.num_hidden)}): "
            + " | ".join(out))


def phase_train_kernels(device) -> dict:
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BiLSTMConfig()
    params = _train_params(cfg, SEED + 3, device)
    fb = cfg.forget_bias
    results = {}
    for precision in ("fp32", "bf16"):
        err_fwd = err_bwd = 0.0
        for batch in (TRAIN_B, TRAIN_B + 35):
            _, xin, weights, dh = _train_inputs(cfg, params, batch, precision,
                                                device)
            err_fwd = max(err_fwd, _k2_check(xin, weights, fb, precision,
                                             f"B={batch}"))
            hs, cs = tr.train_fwd(xin, weights, fb)
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
                f"cos={cos:.8f}; K2 and K3 twice: same bits")
            del hs, cs, got, again, want
        err_cases, line = k2_cases_line(precision, device)
        err_fwd = max(err_fwd, err_cases)
        log(line)
        log(k2_sweep_line(cfg, params, precision, device))

        # times at the train batch
        x, xin, weights, dh = _train_inputs(cfg, params, TRAIN_B, precision,
                                            device)
        hs, cs = tr.train_fwd(xin, weights, fb)
        k2_plain = time_ms(lambda: tr.train_fwd_plain(xin, weights, fb))
        k3_plain = time_ms(lambda: _bwd_all(tr.train_bwd_plain, xin, hs, cs,
                                            dh, weights, fb))
        lib = cudnn_lstms(params, cfg, precision, device, train=True)
        xl = x.to(lib[0].weight_ih_l0.dtype).requires_grad_(True)
        # K2 and cuDNN's forward (training mode, over the readout cone) in
        # turns, the median of 3 rounds
        rounds = interleaved_ms({
            "k2": lambda: tr.train_fwd(xin, weights, fb),
            "cudnn_fwd": lambda: cudnn_center(lib, xl, cfg)})
        k2_ms, lib_fwd_ms = rounds["k2"], rounds["cudnn_fwd"]
        log(f"[K2 {precision}] interleaved, 3 rounds (ms): K2 {k2_ms:.4f} "
            f"{rounds['k2_rounds']}, cudnn fwd {lib_fwd_ms:.4f} "
            f"{rounds['cudnn_fwd_rounds']}")
        out = cudnn_center(lib, xl, cfg)
        gout = torch.randn_like(out) / TRAIN_B
        # K3 (3 layers) and cuDNN's backward in turns, the median of 3
        # rounds
        rounds = interleaved_ms({
            "k3": lambda: _bwd_all(tr.train_bwd, xin, hs, cs, dh, weights,
                                   fb),
            "cudnn_bwd": lambda: torch.autograd.backward(
                out, gout, retain_graph=True)})
        k3_ms, lib_bwd_ms = rounds["k3"], rounds["cudnn_bwd"]
        log(f"[K3 {precision}] interleaved, 3 rounds (ms): K3 {k3_ms:.4f} "
            f"{rounds['k3_rounds']}, cudnn bwd {lib_bwd_ms:.4f} "
            f"{rounds['cudnn_bwd_rounds']}")
        # where K3's device time goes, a layer at a time
        parts = (("rows", "rows_kernel"), ("gates", "GatesEpi"),
                 ("recurrence", "train_bwd_kernel"), ("dx", "DxEpi"),
                 ("dW", "DwEpi"), ("dW sum", "sum_splits"))
        for layer, (w, b) in enumerate(weights):
            layer_in = xin if layer == 0 else hs[layer - 1]
            by_kernel, busy = device_time_by_kernel(lambda: tr.train_bwd(
                layer_in, hs[layer], cs[layer], dh, w, b, fb))
            split = {label: sum(ms for ms, name in by_kernel if key in name)
                     for label, key in parts}
            log(f"[K3 {precision}] layer {layer} profiler: {busy:.4f} ms "
                f"of device time; " + "; ".join(
                    f"{k} {v:.4f}" for k, v in split.items()))

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


def read_beds(folder: str, prefix: str = "mod_pos") -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, f"{prefix}.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def run_detect(ds: str, out: str, device: str, precision: str,
               model: str = "", windowsize: int = 21,
               extra: tuple = ()) -> float:
    return run_detect_logged(ds, out, device, precision, model, windowsize,
                             extra)[0]


def run_detect_logged(ds: str, out: str, device: str, precision: str,
                      model: str = "", windowsize: int = 21,
                      extra: tuple = ()) -> tuple:
    """detect through the CLI; (wall seconds, what it printed)."""
    import contextlib
    import io

    from deepmod_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([
            "detect", "--wrkBase", os.path.join(ds, "pod5"),
            "--Ref", os.path.join(ds, "ref.fa"),
            "--modfile", model or os.path.join(ds, "model.npz"),
            "--basecalls", os.path.join(ds, "calls.bam"),
            "--outFolder", out, "--alignStr", "builtin", "--Base", "C",
            "--precision", precision, "--device", device, "--outLevel", "0",
            "--perRead", "0", "--windowsize", str(windowsize), *extra,
        ])
    wall = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    assert rc == 0, f"detect {device}/{precision} {extra} exited {rc}"
    assert os.path.exists(out + ".done")
    return wall, buf.getvalue()


def phase_detect(device, workdir: str) -> dict:
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
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
    ), n_files=DETECT_FILES)
    cfg = BiLSTMConfig()
    save_bilstm_npz(os.path.join(ds, "model.npz"),
                    init_bilstm_params(SEED + 1, cfg, device="cpu"), cfg)
    log(f"[detect] dataset: {len(reads)} reads over "
        f"{len({r.path for r in reads})} pod5 files, "
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
    assert not any(ops.LAYERED_LAUNCHES.values()), ops.LAYERED_LAUNCHES

    walls["cpu_fp32"] = run_detect(
        ds, os.path.join(workdir, "cpu_fp32"), "cpu", "fp32")
    res = compare_devices(device, ds, workdir, "", 21)
    return dict(res, launches=launches, walls=walls)


def compare_devices(device, ds: str, workdir: str, prefix: str,
                    windowsize: int, model: str = "", fnum: int = 7) -> dict:
    """The fp32 card run's BEDs against the cpu run's, with a window-level
    trace of any difference: the same host features through both devices,
    where every flipped prediction must be a near tie (|logit margin| at
    most twice the two devices' logit difference). ``model`` defaults to
    the dataset's ``model.npz``."""
    from deepmod_tpu_torch.engine.detect import WindowPredictor
    from deepmod_tpu_torch.models.tf_import import load_model

    beds = {k: read_beds(os.path.join(workdir, prefix + k))
            for k in ("gpu_bf16", "gpu_fp32", "cpu_fp32")}
    for k, v in beds.items():
        assert v and all(len(b) > 0 for b in v.values()), f"{k}: empty BEDs"
    beds_equal = beds["gpu_fp32"] == beds["cpu_fp32"]

    feats, centers = _features_of(
        ds, sorted(glob.glob(os.path.join(ds, "pod5", "*.pod5"))),
        windowsize, fnum)
    params, mcfg = load_model(model or os.path.join(ds, "model.npz"))
    mcfg = dataclasses.replace(mcfg, timesteps=windowsize)
    t0 = time.perf_counter()
    gpu = WindowPredictor(params, mcfg, device=device, precision="fp32")
    p_gpu = gpu.predict_from_features(feats, centers, windowsize)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    cpu = WindowPredictor(params, mcfg, device="cpu", precision="fp32")
    flips, n_near_tie = near_tie_flips(gpu, cpu, feats, centers, p_gpu)
    assert beds_equal or len(flips) > 0, "BEDs differ with no window flip"
    log(f"[detect T={windowsize}] windows={len(centers)} fp32 GPU/CPU window "
        f"flips={len(flips)} (all near ties: {n_near_tie == len(flips)}), "
        f"BEDs equal={beds_equal}; GPU classify {gpu_s:.3f} s")
    return {"windows": int(len(centers)), "flips": int(len(flips)),
            "beds_equal": beds_equal}


def near_tie_flips(gpu, cpu, feats, centers, p_gpu) -> tuple:
    """The fp32 card predictor's window predictions ``p_gpu`` against the
    cpu predictor's on the same host features: (indices of the flipped
    windows, how many are near ties). Every flip must be a near tie:
    |logit margin| at most twice the two devices' logit difference."""
    from deepmod_tpu_torch.models.bilstm import bilstm_logits

    mcfg = gpu.config
    windowsize = mcfg.timesteps
    p_cpu = cpu.predict_from_features(feats, centers, windowsize)
    flips = np.flatnonzero(p_gpu != p_cpu)
    n_near_tie = 0
    if len(flips):
        half = windowsize // 2
        view = np.lib.stride_tricks.sliding_window_view(feats, windowsize, axis=0)
        win = np.ascontiguousarray(
            np.moveaxis(view[centers[flips] - half], 2, 1))
        lg = bilstm_logits(gpu._model, torch.from_numpy(win).to(gpu.device),
                           mcfg, "fp32").cpu()
        lc = bilstm_logits(cpu._model, torch.from_numpy(win), mcfg, "fp32")
        margin = (lc[:, 1] - lc[:, 0]).abs()
        diff = (lg - lc).abs().max(dim=1).values
        n_near_tie = int((margin <= 2 * diff).sum())
        assert n_near_tie == len(flips), (
            f"{len(flips) - n_near_tie} fp32 GPU/CPU prediction flips are "
            "not near ties")
    return flips, n_near_tie


def phase_detect_layered(device, workdir: str) -> dict:
    """detect through the CLI at the window sizes K4 serves, over a
    DETECT_T_READS-read subset of the detect dataset: on the card in bf16
    and fp32 with K4 launched and K1 not, and on the cpu in fp32."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )

    ds = os.path.join(workdir, "ds_k4")
    write_move_dataset_pod5(ds, SynthConfig(
        genome_sizes={"chrS": 200_000}, num_reads=DETECT_T_READS,
        read_length=(1500, 3000), seed=SEED, fast5_style="move",
        mod_motif="CG", mod_level_shift=0.5,
    ))
    cfg = BiLSTMConfig()
    save_bilstm_npz(os.path.join(ds, "model.npz"),
                    init_bilstm_params(SEED + 1, cfg, device="cpu"), cfg)
    out = {}
    for windowsize in LAYERED_T:
        prefix = f"w{windowsize}_"
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        walls = {}
        for precision in ("bf16", "fp32"):
            walls[precision] = run_detect(
                ds, os.path.join(workdir, prefix + f"gpu_{precision}"),
                "cuda", precision, windowsize=windowsize)
        torch.cuda.synchronize()
        launches = dict(ops.LAYERED_LAUNCHES)
        log(f"[detect T={windowsize}] K4 launches {launches}, K1 launches "
            f"{dict(ops.LAUNCHES)}")
        assert launches["bf16"] > 0 and launches["fp32"] > 0, launches
        assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
        walls["cpu_fp32"] = run_detect(
            ds, os.path.join(workdir, prefix + "cpu_fp32"), "cpu", "fp32",
            windowsize=windowsize)
        res = compare_devices(device, ds, workdir, prefix, windowsize)
        for key, wall in walls.items():
            log(f"[detect T={windowsize}] {key}: wall {wall:.2f} s, "
                f"{res['windows'] / wall:.1f} windows/s end to end")
        out[windowsize] = dict(res, launches=launches, walls=walls)
    return out


def phase_tf_checkpoint(workdir: str) -> dict:
    """The reference's model format on the card: phase 7's seeded
    full-width model written as a TF1 checkpoint (the reference's variable
    names, Adam slots, beta powers and global_step) by the port's writer,
    read back by ``load_model`` with the reader's seconds, the same bits
    as the .npz; a flipped data byte must raise the crc error; detect
    through the CLI with ``--modfile <prefix>`` over phase 7's pod5 set at
    bf16 must give the .npz run's BEDs, with K1 counted around it."""
    from deepmod_tpu_torch.models import tf_bundle
    from deepmod_tpu_torch.models.tf_import import (
        RNN_KERNEL,
        _flatten,
        load_model,
    )
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.testing.tf_bundle import write_reference_bilstm

    ds = os.path.join(workdir, "ds")
    params, cfg = load_model(os.path.join(ds, "model.npz"))
    prefix = os.path.join(ds, "tf", "mod_train")
    os.makedirs(os.path.dirname(prefix))
    write_reference_bilstm(prefix, params)
    reader = tf_bundle.CheckpointReader(prefix)
    names = reader.get_variable_to_shape_map()
    assert "global_step" in names and sum(
        k.endswith("/Adam") for k in names) == 14, sorted(names)
    t0 = time.perf_counter()
    got, got_cfg = load_model(prefix)
    reader_s = time.perf_counter() - t0
    want = _flatten(params)
    flat = _flatten(got)
    assert sorted(flat) == sorted(want) and got_cfg == cfg, (got_cfg, cfg)
    assert all(flat[k].tobytes() == want[k].tobytes() for k in want)
    size = os.path.getsize(prefix + ".data-00000-of-00001")
    log(f"[tf] {len(names)} variables, .data {size} B, .index "
        f"{os.path.getsize(prefix + '.index')} B; load_model read the 14 "
        f"model tensors ({sum(v.nbytes for v in want.values())} B) in "
        f"{reader_s:.4f} s, the .npz's bits")

    bad = os.path.join(ds, "tf_bad", "mod_train")
    shutil.copytree(os.path.dirname(prefix), os.path.dirname(bad))
    kernel = RNN_KERNEL.format(d="bw", l=2)
    at = reader._entries[kernel].offset + 4321
    with open(bad + ".data-00000-of-00001", "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 0x01]))
    try:
        load_model(bad)
        raise AssertionError("a flipped data byte loaded")
    except ValueError as exc:
        error = str(exc)
    assert f"'{kernel}': crc32c mismatch" in error, error
    log(f"[tf] a flipped data byte raises: {error}")

    out = os.path.join(workdir, "tf_gpu_bf16")
    ops.reset_launch_counts()
    wall = run_detect(ds, out, "cuda", "bf16", model=prefix)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    assert launches["bf16"] > 0, launches
    beds = read_beds(out)
    assert beds and beds == read_beds(os.path.join(workdir, "gpu_bf16"))
    log(f"[tf] detect --modfile <TF prefix> bf16: wall {wall:.2f} s, K1 "
        f"launches {launches}, BEDs the .npz run's bytes ({len(beds)} files)")
    return {"prefix": prefix, "reader_s": reader_s, "launches": launches}


def phase_serve(device, workdir: str, prefix: str) -> dict:
    """``serve`` on the card over phase 7's pod5 files (through
    --basecalls), the model read from phase 22's TF prefix: services at
    bf16 and fp32 with --threads 1 and 4; answers over HTTP (1 file, then
    4) equal the in-process ones; --threads 4 answers equal --threads 1's;
    8 concurrent one-file requests give the serial answers in fewer device
    calls; the fp32 answers over 2 files equal a --device cpu service's, or
    every differing window is a near tie (phase 7's rule). K1 is counted
    around the services' requests; then the latency probe's table."""
    import threading
    import urllib.request

    from deepmod_tpu_torch.engine.host_worker import host_process_files
    from deepmod_tpu_torch.engine.outputs import build_batch_request
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.serve import DetectService, serve
    from deepmod_tpu_torch.tools import probe_serve_latency

    ds = os.path.join(workdir, "ds")
    ref, bam = os.path.join(ds, "ref.fa"), os.path.join(ds, "calls.bam")
    files = sorted(glob.glob(os.path.join(ds, "pod5", "*.pod5")))
    requests = [files[:1], files[:4]]

    def service(precision, threads=1, dev="cuda"):
        return DetectService(ref, prefix, align_str="builtin",
                             precision=precision, threads=threads,
                             basecalls=bam, device=dev)

    def post(url, paths):
        req = urllib.request.Request(
            url + "/detect", data=json.dumps({"fast5": paths}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            return json.loads(resp.read())

    ops.reset_launch_counts()
    answers = {}
    httpd = serve(ref, prefix, port=0, precision="bf16", basecalls=bam)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["backend"] == "cuda", health
        svc = httpd.dmt_service
        for paths in requests:
            t0 = time.perf_counter()
            body = post(url, paths)
            wall = time.perf_counter() - t0
            local = json.loads(json.dumps(svc.detect(paths)))
            assert body == local and body["reads"], body["errors"]
            answers[("bf16", len(paths))] = body
            log(f"[serve] HTTP {len(paths)} file(s): {len(body['reads'])} "
                f"reads, {len(body['positions'])} positions, errors "
                f"{ {k: len(v) for k, v in body['errors'].items()} }, "
                f"{wall:.3f} s, the in-process answer")
        serial = {p: svc.detect([p]) for p in files[:8]}
        # the host stage is single-flight and K1 is quick, so requests
        # seldom meet at the dispatcher (the probe below counts how
        # seldom): hold its first device call until all 8 requests have
        # reached it, so that those not in that call must go as one
        coalescer = svc._coalescer
        predict, put = coalescer._predict, coalescer._q.put
        arrived = threading.Semaphore(0)

        def counted_put(item):
            put(item)
            arrived.release()

        def held_first(results):
            if coalescer._predict is held_first:
                coalescer._predict = predict
                for _ in range(8):
                    assert arrived.acquire(timeout=120), "a request is lost"
            return predict(results)

        coalescer._q.put = counted_put
        coalescer._predict = held_first
        calls0 = coalescer.device_calls
        got, errs = {}, []

        def hit(p):
            try:
                got[p] = svc.detect([p])
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        threads = [threading.Thread(target=hit, args=(p,)) for p in files[:8]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        del coalescer._q.put
        calls = coalescer.device_calls - calls0
        assert not errs and got == serial, errs
        assert 1 <= calls < len(threads), calls
        log(f"[serve] 8 concurrent one-file requests, the first device call "
            f"held until all 8 reached the dispatcher: the serial answers in "
            f"{calls} device calls; health {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.dmt_service.close()
        thread.join(timeout=10)
    for precision in ("fp32", "bf16"):
        for threads in (1, 4):
            if (precision, threads) == ("bf16", 1):
                continue  # the HTTP service above
            svc = service(precision, threads)
            try:
                for paths in requests:
                    answers[(precision, len(paths), threads)] = svc.detect(
                        paths)
            finally:
                svc.close()
    def by_read(answer):
        # the pool orders reads by file, the in-process stage by read id
        return dict(answer, reads=sorted(answer["reads"],
                                         key=lambda r: r["read_id"]))

    for paths in requests:
        n = len(paths)
        assert by_read(answers[("bf16", n, 4)]) == by_read(
            answers[("bf16", n)])
        assert by_read(answers[("fp32", n, 4)]) == by_read(
            answers[("fp32", n, 1)])
    log("[serve] --threads 4 answers equal --threads 1's (reads in read-id "
        "order), bf16 and fp32")

    two = files[:2]
    gpu = service("fp32")
    cpu = service("fp32", dev="cpu")
    try:
        a_gpu, a_cpu = gpu.detect(two), cpu.detect(two)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        assert launches["bf16"] > 0 and launches["fp32"] > 0, launches
        n_flips = 0
        if a_gpu != a_cpu:
            results, _ = host_process_files(two)
            feats, centers, _, _ = build_batch_request(results)
            p_gpu = gpu.predictor.predict_from_features(feats, centers, 21)
            flips, _ = near_tie_flips(gpu.predictor, cpu.predictor, feats,
                                      centers, p_gpu)
            assert len(flips) > 0, "answers differ with no window flip"
            n_flips = len(flips)
    finally:
        gpu.close()
        cpu.close()
    log(f"[serve] fp32 card answers over 2 files equal the cpu service's: "
        f"{a_gpu == a_cpu} ({n_flips} flipped windows, all near ties); K1 "
        f"launches on serve's path {launches}")

    t0 = time.perf_counter()
    probe = probe_serve_latency.run(ds, prefix, requests=20,
                                    precision="bf16", device="cuda")
    log(f"[serve] latency probe ({time.perf_counter() - t0:.2f} s), "
        f"{nvidia_smi_line()}:")
    for row in probe["rows"]:
        log(f"[serve]   {row['files_per_request']} file(s), "
            f"{row['reads_per_request']} reads, {row['windows_per_request']} "
            f"windows a request: p50 {row['p50_ms']:.3f} ms, p95 "
            f"{row['p95_ms']:.3f} ms, best {row['best_ms']:.3f} ms, "
            f"{row['device_calls_per_request']:.3f} device calls a request")
    for row in probe["concurrent"]:
        log(f"[serve]   {row['concurrent_clients']} concurrent clients, "
            f"coalescer {'on' if row['coalesce'] else 'off'}: p50 "
            f"{row['p50_ms']:.3f} ms, p95 {row['p95_ms']:.3f} ms, "
            f"{row['device_calls_per_request']:.3f} device calls a request")
    return {"launches": launches, "probe": probe}


def phase_native() -> dict:
    """Build the native host library from the checkout's sources (g++) and
    list the functions it exports; fails where it does not load."""
    from deepmod_tpu_torch.native import lib
    from deepmod_tpu_torch.native.fast5_native import native_fast5_available

    t0 = time.perf_counter()
    ok = lib.native_available()
    secs = time.perf_counter() - t0
    info = lib.build_info
    assert ok, f"the native host library did not load: {info['error']}"
    funcs = lib.loaded_functions()
    log(f"[native] built in {secs:.2f} s (g++ {info['seconds']:.2f} s, "
        f"cached {info['cached']}) at {os.path.relpath(info['path'], REPO)}")
    log(f"[native] functions loaded: "
        f"{sorted(k for k, v in funcs.items() if v)}; missing: "
        f"{sorted(k for k, v in funcs.items() if not v)}; fast5 reader "
        f"(needs h5py's libhdf5): {native_fast5_available()}")
    assert all(funcs.values()), funcs
    return {"seconds": secs, "functions": funcs}


def _stages(printed: str) -> dict:
    """The CLI's ``stage NAME: SECONDSs`` lines (--outLevel 0)."""
    out = {}
    for line in printed.splitlines():
        line = line.strip()
        if line.startswith("stage ") and line.endswith("s"):
            name, _, secs = line[len("stage "):].rpartition(": ")
            out[name] = float(secs[:-1])
    return out


def _run_files(folder: str) -> dict:
    """The BEDs and index files of a detect run, by name; an index file's
    header names its run's output folder, written here as <out>."""
    out = read_beds(folder)
    own = os.path.abspath(folder).encode()
    for path in sorted(glob.glob(os.path.join(folder, "mod", "rnn.pred.ind.*"))):
        with open(path, "rb") as fh:
            out["mod/" + os.path.basename(path)] = fh.read().replace(
                own, b"<out>")
    return out


def phase_pool(workdir: str, windows: int) -> dict:
    """detect through the CLI over the detect dataset's DETECT_FILES pod5
    files in batches of POOL_FILES_PER_BATCH: --threads 1 (the engine's
    prefetch thread) and --threads POOL_THREADS (HostPool spawn workers;
    the engine process alone launches K1), bf16 on the card. Their BEDs
    and index files (where h5py writes the per-read files) must be the
    same bytes; then a --trace run of the pooled path gives the card's
    idle share in detect."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.tools._host_bench import trace_idle_share
    from deepmod_tpu_torch.tools.bench_e2e import HOST_WAIT_STAGES

    ds = os.path.join(workdir, "ds")
    try:
        import h5py  # noqa: F401
        per_read = ("--perRead", "1")
    except ImportError:
        per_read = ()  # the predetail writer (and index files) need h5py
    n_batches = -(-DETECT_FILES // POOL_FILES_PER_BATCH)
    assert n_batches >= 4, n_batches
    res = {"cpu_count": os.cpu_count(), "batches": n_batches,
           "index_files": bool(per_read)}
    log(f"[pool] os.cpu_count()={os.cpu_count()}; {DETECT_FILES} pod5 files "
        f"in {n_batches} batches; per-read files and index files: "
        f"{bool(per_read)}")
    files = {}
    for threads in (1, POOL_THREADS):
        out = os.path.join(workdir, f"pool_t{threads}")
        ops.reset_launch_counts()
        wall, printed = run_detect_logged(
            ds, out, "cuda", "bf16",
            extra=("--threads", str(threads), "--files_per_thread",
                   str(POOL_FILES_PER_BATCH), *per_read))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        assert launches["bf16"] > 0, launches
        stages = _stages(printed)
        wait = sum(stages.get(k, 0.0) for k in HOST_WAIT_STAGES)
        if threads > 1:
            assert "wait_for_host_workers" in stages, stages
        res[threads] = {"wall": wall, "windows_per_s": windows / wall,
                        "host_share": wait / wall, "stages": stages,
                        "k1_launches": launches["bf16"]}
        log(f"[pool] --threads {threads}: wall {wall:.3f} s, "
            f"{windows / wall:.1f} windows/s, host wait {wait:.3f} s "
            f"({100 * wait / wall:.1f}% of the wall), K1 launches in the "
            f"engine {launches['bf16']}, stage_seconds {stages}")
        files[threads] = _run_files(out)
    assert files[1] and files[1] == files[POOL_THREADS], (
        sorted(files[1]), sorted(files[POOL_THREADS]))
    assert any(k.startswith("mod/") for k in files[1]) == bool(per_read)
    log(f"[pool] --threads {POOL_THREADS} gives --threads 1's bytes: "
        f"{sorted(files[1])}")

    trace = os.path.join(workdir, "pool_trace")
    ops.reset_launch_counts()
    wall = run_detect(
        ds, os.path.join(workdir, "pool_traced"), "cuda", "bf16",
        extra=("--threads", str(POOL_THREADS), "--files_per_thread",
               str(POOL_FILES_PER_BATCH), "--trace", trace))
    busy, span, idle = trace_idle_share(os.path.join(trace, "detect.json"))
    assert ops.LAUNCHES["bf16"] > 0 and busy > 0, (ops.LAUNCHES, busy)
    res["trace"] = {"wall": wall, "busy_s": busy, "span_s": span,
                    "idle_share": idle}
    log(f"[pool] traced --threads {POOL_THREADS} run: wall {wall:.3f} s, "
        f"card busy {busy:.4f} s of the trace's {span:.3f} s: idle share "
        f"{idle:.4f}")
    return res


def phase_host_tools() -> dict:
    """bench_host (the host stage's one-thread rate, numpy twins against
    the native library) and bench_e2e (warm detect wall over E2E_READS
    reads at 1 and POOL_THREADS threads, and the card's idle share in a
    traced warm pass), each once in its own process."""
    out = {}
    for tool, args, limit in (
            ("bench_host", ("--repeats", "1"), 300),
            ("bench_e2e", ("--threads", f"1,{POOL_THREADS}", "--reads",
                           str(E2E_READS)), 300)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"deepmod_tpu_torch.tools.{tool}", *args],
            capture_output=True, text=True, timeout=limit, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO),
        )
        for line in proc.stdout.splitlines():
            log(f"[{tool}] {line}")
        assert proc.returncode == 0, f"{tool} exited {proc.returncode}:\n" \
            + proc.stderr[-3000:]
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        assert rows, proc.stdout
        if tool == "bench_host":
            assert all(r["rows_equal"] for r in rows), rows
        else:
            assert all(r["traced"]["busy_s"] > 0 for r in rows), rows
        log(f"[{tool}] {time.perf_counter() - t0:.1f} s")
        out[tool] = rows
    return out


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


def train_features(workdir: str, reads: int) -> tuple:
    """getfeatures over a modified and a control pod5 cohort of ``reads``
    reads each, into ``<workdir>/feat_mod`` and ``feat_ctl``; the folders,
    the wall, and an epoch's minibatches of <= TRAIN_B windows."""
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )
    from deepmod_tpu_torch.train.loader import (
        find_feature_files,
        iterate_training_batches,
    )

    common = dict(genome_sizes={"chrT": 100_000}, num_reads=reads,
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
    return feats, gf_wall, minibatches


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

    feats, gf_wall, minibatches = train_features(workdir, TRAIN_READS)
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
            "steps": n_steps, "rel_cpu": rel, "losses": losses,
            "feats": feats}


def phase_train_layered(device, workdir: str, feats: dict) -> dict:
    """train at the first of LAYERED_T on the card in fp32 over phase
    train's feature files (they hold rows; the loader cuts the windows):
    K2/K3 once a step, the periodic evaluation through K4; then
    predfeatures and detect with the trained model through K4, K1 never
    launched."""
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.train.loader import (
        find_feature_files,
        iterate_training_batches,
    )

    windowsize = LAYERED_T[0]
    groups = [find_feature_files(feats["mod"]), find_feature_files(feats["ctl"])]
    n_steps = sum(1 for step in iterate_training_batches(
        groups, TRAIN_B, window_size=windowsize)
        for mb in step if len(mb[1]))
    out = os.path.join(workdir, f"train_out_w{windowsize}")
    # the main path: counts from 0 just before, read just after
    ops.reset_launch_counts()
    tr.reset_launch_counts()
    wall = run_cli("train", "--wrkBase", feats["mod"], "--wrkBase2",
                   feats["ctl"], "--outFolder", out, "--epochs", "1",
                   "--batchsize", str(TRAIN_B), "--trainPrecision", "fp32",
                   "--device", "cuda", "--outLevel", "2",
                   "--windowsize", str(windowsize))
    torch.cuda.synchronize()
    train_k4 = ops.LAYERED_LAUNCHES["fp32"]
    log(f"[train T={windowsize}] wall {wall:.2f} s; K2/K3 launches "
        f"{dict(tr.LAUNCHES)} ({n_steps} steps); evaluation K4 launches "
        f"{dict(ops.LAYERED_LAUNCHES)}, K1 {dict(ops.LAUNCHES)}")
    assert tr.LAUNCHES["fwd_fp32"] == n_steps, tr.LAUNCHES
    assert tr.LAUNCHES["bwd_fp32"] == 3 * n_steps, tr.LAUNCHES
    assert train_k4 > 0 and not any(ops.LAUNCHES.values()), (
        ops.LAYERED_LAUNCHES, ops.LAUNCHES)
    model = os.path.join(out, "1", "mod.npz")
    assert np.isfinite(_flat_params(model)).all(), "non-finite params"

    run_cli("predfeatures", "--wrkBase", feats["mod"], "--modfile", model,
            "--outFolder", os.path.join(workdir, f"pred_w{windowsize}"),
            "--windowsize", str(windowsize), "--device", "cuda")
    det_dir = os.path.join(workdir, f"trained_detect_w{windowsize}")
    det_wall = run_detect(os.path.join(workdir, "train_mod"), det_dir, "cuda",
                          "fp32", model=model, windowsize=windowsize)
    torch.cuda.synchronize()
    beds = read_beds(det_dir)
    assert beds and all(len(v) > 0 for v in beds.values()), "empty BEDs"
    launches = ops.LAYERED_LAUNCHES["fp32"]
    assert launches > train_k4 and not any(ops.LAUNCHES.values()), (
        ops.LAYERED_LAUNCHES, ops.LAUNCHES)
    log(f"[train T={windowsize}] predfeatures + detect with the trained "
        f"model: detect {det_wall:.2f} s, {len(beds)} BEDs; K4 launches "
        f"{train_k4} in train, {launches} with predfeatures and detect")
    return {"launches": launches, "train_launches": train_k4, "wall": wall,
            "steps": n_steps}


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _wall(fn) -> tuple:
    """(fn's result, seconds on the host clock, every card synchronized)."""
    _sync_all()
    t0 = time.perf_counter()
    out = fn()
    _sync_all()
    return out, time.perf_counter() - t0


def _rel_l2(a: dict, b: dict) -> float:
    from deepmod_tpu_torch.train.trainer import param_leaves

    fa = torch.cat([t.reshape(-1) for t in param_leaves(a)])
    fb = torch.cat([t.reshape(-1) for t in param_leaves(b)])
    return float((fa - fb).norm() / fb.norm())


def phase_parallel(device, workdir: str, shards: list,
                   train_feats: dict) -> dict:
    """The data-parallel and multi-process paths: a mesh over ``shards``
    (on one card: the card named PARALLEL_SHARDS times; with several,
    every card) and ranks of the multihost worker.

    (a) the data-parallel WindowPredictor over phase 7's pod5 set at bf16
    and fp32: predictions the bits of the one-shard predictor's, K1
    launched on each shard; (b) detect with device aggregation on that
    mesh: BEDs the bytes of phase 7's; (c) the data-parallel train step at
    batch TRAIN_B on that mesh against the one-shard step, PARALLEL_STEPS
    steps (``PARALLEL_TOL``: in fp32 losses rtol 1e-4 and params within
    relative L2 1e-4, as tests/test_torch_train.py holds them; in bf16
    storage 1e-3 and 1e-3), K2/K3 on each shard, and a
    step's time both ways; (d) two multihost_worker ranks on the card over
    gloo: the primitives (counts equal to numpy's, the same loss and
    params on both ranks) and detect over phase 7's pod5 set (rank 0's
    BEDs the bytes of the one-process run's); (e) a rank a card over nccl
    (world size 1 on one card), the same checks; and, on one card, two
    nccl ranks on it, which NCCL refuses; (f) ``phase_parallel_train``
    over ``train_feats`` (getfeatures' folders); (g) with several cards,
    ``phase_parallel_serve``."""
    from deepmod_tpu_torch.engine.detect import (
        DetectConfig,
        WindowPredictor,
        _host_options,
        detect_run,
    )
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.engine.outputs import build_batch_request
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig
    from deepmod_tpu_torch.models.tf_import import load_model, params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.parallel.mesh import make_mesh
    from deepmod_tpu_torch.testing.multihost_worker import (
        _RulePredictor,
        run_ranks,
    )
    from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

    ds = os.path.join(workdir, "ds")
    n_shards = len(shards)
    n_cards = torch.cuda.device_count()
    mesh = make_mesh(devices=shards)
    common = dict(
        wrk_base=os.path.join(ds, "pod5"), ref=os.path.join(ds, "ref.fa"),
        model_path=os.path.join(ds, "model.npz"), align_str="builtin",
        base="C", basecalls=os.path.join(ds, "calls.bam"),
        write_per_read=False, device=str(device),
    )
    init_worker(_host_options(DetectConfig(out_folder="", **common)))
    results, _ = host_process_files(
        sorted(glob.glob(os.path.join(ds, "pod5", "*.pod5"))))
    feats, centers, _, _ = build_batch_request(results)
    params, mcfg = load_model(common["model_path"])
    out = {"launches": {}, "shard_launches": {}, "train_launches": {},
           "train_shard_launches": {}}

    for precision in ("bf16", "fp32"):
        # (a) predictions: one shard against the mesh
        one = WindowPredictor(params, mcfg, device=device, precision=precision)
        multi = WindowPredictor(params, mcfg, devices=shards,
                                precision=precision)
        assert multi.n_shards == n_shards
        for pred in (one, multi):  # warm-up
            pred.predict_from_features(feats, centers, 21)
        walls = {id(one): [], id(multi): []}
        for _ in range(3):  # in turns
            for pred in (one, multi):
                got, sec = _wall(lambda: pred.predict_from_features(
                    feats, centers, 21))
                walls[id(pred)].append(sec)
                if pred is one:
                    p_one = got
                else:
                    p_multi = got
        s_one = statistics.median(walls[id(one)])
        s_multi = statistics.median(walls[id(multi)])
        same = bool(np.array_equal(p_one, p_multi))
        log(f"[parallel {precision}] (a) {len(centers)} windows: "
            f"{n_shards}-shard predictions equal to one shard's: "
            f"{same}; one shard {s_one:.4f} s, {n_shards} shards "
            f"{s_multi:.4f} s (host clock, warm, median of 3 in turns: "
            f"{[round(t, 4) for t in walls[id(one)]]} / "
            f"{[round(t, 4) for t in walls[id(multi)]]}); K1 launches a "
            f"shard so far {multi.shard_launches}")
        assert same, f"{precision}: sharded predictions differ"
        assert all(n > 0 for n in multi.shard_launches), multi.shard_launches

        # (b) detect with device aggregation over the shards: the main
        # path, counts from 0 just before, read just after
        before = list(multi.shard_launches)
        ops.reset_launch_counts()
        res, wall = _wall(lambda: detect_run(DetectConfig(
            out_folder=os.path.join(workdir, f"dp_{precision}"),
            precision=precision, device_aggregation=True, **common),
            predictor=multi))
        launches = ops.LAUNCHES[precision]
        per_shard = [a - b for a, b in zip(multi.shard_launches, before)]
        beds = read_beds(os.path.join(workdir, f"dp_{precision}"))
        log(f"[parallel {precision}] (b) detect --device_aggregation 1 on "
            f"{n_shards} shards: wall {wall:.3f} s, {res.num_reads} "
            f"reads, K1 launches {launches} ({per_shard} a shard), stages "
            f"{ {k: round(v, 4) for k, v in res.stage_seconds.items()} }")
        assert launches > 0 and all(n > 0 for n in per_shard), per_shard
        assert sum(per_shard) == launches, (per_shard, launches)
        assert res.stage_seconds.get("device_aggregation", 0) > 0
        assert beds and beds == read_beds(
            os.path.join(workdir, f"gpu_{precision}")), (
            f"{precision}: device-aggregation BEDs differ from phase 7's")
        out["launches"][precision] = launches
        out["shard_launches"][precision] = per_shard
        del one, multi

        # (c) the train step at TRAIN_B: one shard against the mesh
        cfg = BiLSTMConfig()
        init = _train_params(cfg, SEED + 24, device)
        gen = torch.Generator().manual_seed(SEED + 24)
        x = torch.randn(TRAIN_B, 21, 7, generator=gen).to(device)
        labels = (x[:, 10, 4] > 0).long()
        y = torch.nn.functional.one_hot(labels, 2).float()
        mask = torch.ones(TRAIN_B, device=device)
        p1, p2 = (params_from_numpy(init, device) for _ in range(2))
        st1, st2 = adam_init(p1), adam_init(p2)
        step1 = make_train_step(cfg, False, precision)
        step2 = make_train_step(cfg, False, precision, mesh=mesh)
        tr.reset_launch_counts()
        losses = []
        loss_rtol, params_rel = PARALLEL_TOL[precision]
        for _ in range(PARALLEL_STEPS):
            l1 = float(step1(p1, st1, x, y, mask))
            l2 = float(step2(p2, st2, x, y, mask))
            losses.append((l1, l2))
            assert abs(l2 - l1) <= loss_rtol * abs(l1), (precision, losses)
        rel = _rel_l2(p2, p1)
        assert rel <= params_rel, (precision, rel)
        train_launches = dict(tr.LAUNCHES)
        shard_train = [dict(d) for d in step2.shard_launches]
        for d in shard_train:
            assert d[f"fwd_{precision}"] == PARALLEL_STEPS, shard_train
            assert d[f"bwd_{precision}"] == 3 * PARALLEL_STEPS, shard_train
        ms1 = time_ms(lambda: step1(p1, st1, x, y, mask))
        ms2 = time_ms(lambda: step2(p2, st2, x, y, mask))
        log(f"[parallel {precision}] (c) train step B={TRAIN_B}: losses "
            f"(one shard, {n_shards} shards) "
            f"{[(round(a, 6), round(b, 6)) for a, b in losses]}; params "
            f"relative L2 {rel:.3e} after {PARALLEL_STEPS} steps; step "
            f"{ms1:.4f} ms on one shard, {ms2:.4f} ms on {n_shards} "
            f"(CUDA events, median of 5); K2/K3 launches {train_launches} "
            f"({shard_train} a shard); {nvidia_smi_line()}")
        out["train_launches"][precision] = train_launches
        out["train_shard_launches"][precision] = shard_train
        out[f"step_ms_{precision}"] = (ms1, ms2)
        del p1, p2, st1, st2, x, y, mask
        torch.cuda.empty_cache()

    # (d) and (e): ranks of testing/multihost_worker sharing the card; the
    # one-process reference run with the same rule predictor and shards
    solo = os.path.join(workdir, "rule_solo")
    solo_res = detect_run(DetectConfig(out_folder=solo,
                                       device_aggregation=True, **common),
                          predictor=_RulePredictor(mesh))
    solo_beds = read_beds(solo)
    assert solo_beds, "the rule predictor's one-process run wrote no BEDs"
    bam = ("--basecalls", common["basecalls"])
    for backend, nproc in (("gloo", 2), ("nccl", n_cards)):
        tag = f"{backend} x{nproc}"
        args = ("--device", device.type, "--backend", backend)
        prim, wall = _wall(lambda: run_ranks(
            nproc, os.path.join(workdir, f"ranks_{backend}"), args,
            timeout=300))
        for r in prim:
            assert f"backend {backend}" in r["log"], r["log"]
            assert r["counts_ok"], f"{tag}: counts differ from numpy's"
            assert np.isfinite(r["loss"]), r
        assert len({r["loss"] for r in prim}) == 1, prim
        assert len({r["checksum"] for r in prim}) == 1, prim
        log(f"[parallel] ({'d' if backend == 'gloo' else 'e'}) primitives "
            f"over {tag}: counts_ok, loss {prim[0]['loss']:.6f} and "
            f"checksum {prim[0]['checksum']:.6f} on every rank; wall "
            f"{wall:.2f} s (each rank a fresh interpreter)")
        det_out = os.path.join(workdir, f"rule_{backend}")
        ranks, wall = _wall(lambda: run_ranks(
            nproc, os.path.join(workdir, f"ranks_det_{backend}"),
            ("detect", ds, det_out, *args, *bam), timeout=300))
        beds = read_beds(det_out)
        assert ranks[0]["beds"] and all(not r["beds"] for r in ranks[1:])
        assert sum(r["num_reads"] for r in ranks) == solo_res.num_reads, (
            ranks, solo_res.num_reads)
        assert beds == solo_beds, f"{tag}: rank 0's BEDs differ"
        log(f"[parallel] ({'d' if backend == 'gloo' else 'e'}) detect over "
            f"{tag}: "
            f"rank 0's {len(beds)} BEDs equal to the one-process run's; "
            f"wall {wall:.2f} s; reads a rank "
            f"{[r['num_reads'] for r in ranks]}; stages a rank "
            f"{[r['stage_seconds'] for r in ranks]}")
    phase_parallel_train(workdir, train_feats, n_cards, out)
    if n_cards > 1:
        phase_parallel_serve(common, n_cards)
        return out
    # NCCL takes one rank a card: two ranks on this one are refused
    try:
        run_ranks(2, os.path.join(workdir, "ranks_nccl2"),
                  ("--device", device.type, "--backend", "nccl"), timeout=120)
        log("[parallel] two nccl ranks on one card: accepted")
    except (RuntimeError, subprocess.TimeoutExpired) as exc:
        lines = [line for line in str(exc).splitlines()
                 if "Duplicate" in line or "Error" in line]
        log(f"[parallel] two nccl ranks on one card: refused "
            f"({type(exc).__name__}): {lines[:2]}")
    return out


def phase_parallel_train(workdir: str, feats: dict, n_cards: int,
                         out: dict) -> None:
    """(f) an epoch of ``train`` at full width over ``feats``: the CLI's
    ``--device cuda`` run (one card, also on a machine with several: K2
    once a minibatch) against ranks of the multihost worker, a card a
    rank over nccl (one rank, then every card): every rank the same
    params, rank 0's checkpoint within PARALLEL_TOL's fp32 params bound of
    the CLI's; the walls (the ranks': ``train_run`` after a barrier)."""
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.testing.multihost_worker import run_ranks
    from deepmod_tpu_torch.train.loader import (
        find_feature_files,
        iterate_training_batches,
    )

    groups = [find_feature_files(feats["mod"]), find_feature_files(feats["ctl"])]
    n_steps = sum(1 for step in iterate_training_batches(groups, TRAIN_B)
                  for mb in step if len(mb[1]))
    cli_out = os.path.join(workdir, "par_train_cli")
    tr.reset_launch_counts()
    cli_wall = run_cli("train", "--wrkBase", feats["mod"], "--wrkBase2",
                       feats["ctl"], "--outFolder", cli_out, "--epochs", "1",
                       "--batchsize", str(TRAIN_B), "--device", "cuda")
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    assert launches["fwd_fp32"] == n_steps, (launches, n_steps)
    want = _flat_params(os.path.join(cli_out, "1", "mod.npz"))
    log(f"[parallel] (f) train --device cuda, one epoch of {n_steps} "
        f"minibatches: wall {cli_wall:.3f} s (in this process), K2 "
        f"launches {launches['fwd_fp32']} (one card of {n_cards})")
    out["train_walls"] = {"cli": cli_wall}
    for nproc in sorted({1, n_cards}):
        rk_out = os.path.join(workdir, f"par_train_{nproc}")
        ranks, wall = _wall(lambda: run_ranks(
            nproc, os.path.join(workdir, f"ranks_train_{nproc}"),
            ("train", feats["mod"], feats["ctl"], rk_out, "--device", "cuda",
             "--backend", "nccl", "--full_width"), timeout=300))
        assert len({r["checksum"] for r in ranks}) == 1, ranks
        got = _flat_params(os.path.join(rk_out, "1", "mod.npz"))
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert np.isfinite(got).all() and rel <= PARALLEL_TOL["fp32"][1], rel
        train_s = [round(r["train_s"], 4) for r in ranks]
        log(f"[parallel] (f) train over nccl x{nproc} (a card a rank): "
            f"every rank the same params, rank 0's vs the CLI run's relative "
            f"L2 {rel:.3e}; train_run {max(train_s):.3f} s (ranks "
            f"{train_s}); launcher wall {wall:.2f} s; {nvidia_smi_line()}")
        out["train_walls"][f"ranks_{nproc}"] = max(train_s)


def phase_parallel_serve(common: dict, n_cards: int) -> None:
    """(g) with several cards: ``serve``'s DetectService on ``cuda`` (its
    predictor over every card) gives the answers of one on ``cuda:0``
    over four of phase 7's files, bf16 and fp32, K1 launched on each
    card; the first request's wall and the median of 3 after it."""
    from deepmod_tpu_torch.serve import DetectService

    files = sorted(glob.glob(os.path.join(common["wrk_base"], "*.pod5")))[:4]
    for precision in ("bf16", "fp32"):
        got = {}
        for dev in ("cuda", "cuda:0"):
            svc = DetectService(common["ref"], common["model_path"],
                                align_str="builtin", precision=precision,
                                basecalls=common["basecalls"], device=dev)
            try:
                answer, first = _wall(lambda: svc.detect(files))
                warm = [_wall(lambda: svc.detect(files))[1] for _ in range(3)]
                got[dev] = (answer, svc.predictor.n_shards,
                            list(svc.predictor.shard_launches), first,
                            statistics.median(warm))
            finally:
                svc.close()
        assert got["cuda"][1] == n_cards and got["cuda:0"][1] == 1, got
        assert all(n > 0 for n in got["cuda"][2]), got["cuda"][2]
        assert got["cuda"][0] == got["cuda:0"][0] and got["cuda"][0]["reads"]
        log(f"[parallel {precision}] (g) serve over {len(files)} files: the "
            f"{n_cards}-card service's answer equals cuda:0's; K1 launches a "
            f"card {got['cuda'][2]}; first request {got['cuda'][3]:.4f} / "
            f"{got['cuda:0'][3]:.4f} s, then the median of 3 "
            f"{got['cuda'][4]:.4f} / {got['cuda:0'][4]:.4f} s ({n_cards} "
            f"cards / one)")


TP_SHARDS = 4          # the one card named this often in phase 25's mesh
TP_ATOL = 2e-6         # params: the TP step against the 1-D step
PACK57_T = (21, 20)    # phase 25's fnum-57 window sizes: K1, then K4


def _features_of(ds: str, files: list, windowsize: int = 21,
                 fnum: int = 7) -> tuple:
    """The host features and window centers of a pod5 dataset's ``files``
    (detect's host stage, one batch)."""
    from deepmod_tpu_torch.engine.detect import DetectConfig, _host_options
    from deepmod_tpu_torch.engine.host_worker import (
        host_process_files,
        init_worker,
    )
    from deepmod_tpu_torch.engine.outputs import build_batch_request

    init_worker(_host_options(DetectConfig(
        wrk_base=os.path.join(ds, "pod5"), ref=os.path.join(ds, "ref.fa"),
        model_path="", out_folder="", align_str="builtin", fnum=fnum,
        basecalls=os.path.join(ds, "calls.bam"), window_size=windowsize)))
    results, _ = host_process_files(files)
    feats, centers, _, _ = build_batch_request(results, window=windowsize)
    return feats, centers


def _windows_of(ds: str, windowsize: int = 21, fnum: int = 7) -> tuple:
    """The host features and centers of a pod5 dataset's reads, and their
    materialized (n, T, F) windows."""
    feats, centers = _features_of(
        ds, sorted(glob.glob(os.path.join(ds, "pod5", "*.pod5"))),
        windowsize, fnum)
    half = windowsize // 2
    view = np.lib.stride_tricks.sliding_window_view(feats, windowsize, axis=0)
    return feats, centers, np.ascontiguousarray(
        np.moveaxis(view[centers - half], 2, 1), np.float32)


def phase_tensor_parallel(device, workdir: str, devices: list) -> dict:
    """(25 A) tensor parallelism on a (data, model) mesh over ``devices``
    (one card: the card named TP_SHARDS times as (2, 2); several: a (1, n)
    mesh, a card a model shard): ``make_sharded_predict(model_axis=
    "model")`` on phase 7's windows against K1 fp32 (every disagreement a
    near tie: |logit margin| at most twice the two logits' difference),
    and one ``make_sharded_train_step(model_axis="model")`` step at batch
    TRAIN_B against the 1-D step (K2/K3): loss within rel 1e-5, params
    within TP_ATOL where |g| >= 1e-7 and within the learning rate
    everywhere (the CPU test's bound); both steps' times."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, bilstm_logits
    from deepmod_tpu_torch.models.tf_import import load_model, params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.parallel import (
        make_2d_mesh,
        make_sharded_predict,
        make_sharded_train_step,
    )
    from deepmod_tpu_torch.train.trainer import (
        adam_init,
        make_train_step,
        param_leaves,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (2, len(devices) // 2) if len(set(devices)) == 1 else (
        1, len(devices))
    mesh = make_2d_mesh(*shape, devices=devices)
    tag = f"[tp {shape[0]}x{shape[1]}]"
    ds = os.path.join(workdir, "ds")
    _, _, windows = _windows_of(ds)
    windows = windows[: len(windows) // shape[0] * shape[0]]
    params, mcfg = load_model(os.path.join(ds, "model.npz"))
    tparams = params_from_numpy(params, device)
    x = torch.from_numpy(windows).to(device)
    fn = make_sharded_predict(mcfg, mesh, model_axis="model")
    tp_logits, tp_s = _wall(lambda: fn.logits(tparams, x))
    ops.reset_launch_counts()
    k1_logits, k1_s = _wall(lambda: bilstm_logits(tparams, x, mcfg, "fp32"))
    assert ops.LAUNCHES["fp32"] > 0, ops.LAUNCHES
    diff = (tp_logits - k1_logits).abs()
    flips = torch.nonzero(tp_logits.argmax(1) != k1_logits.argmax(1))[:, 0]
    margin = (k1_logits[:, 1] - k1_logits[:, 0]).abs()
    near = int((margin[flips] <= 2 * diff[flips].max(dim=1).values).sum())
    log(f"{tag} predict over {len(windows)} windows of phase 7's set: "
        f"{len(flips)} argmax flips against K1 fp32 (near ties: {near}); "
        f"logits max |d| {float(diff.max()):.3e}; TP (plain torch fp32, "
        f"{len(devices)} shards) {tp_s:.3f} s, K1 fp32 {k1_s:.3f} s (host "
        f"clock, first call)")
    assert near == len(flips), f"{len(flips) - near} flips are not near ties"

    cfg = BiLSTMConfig()
    init = _train_params(cfg, SEED + 25, device)
    gen = torch.Generator().manual_seed(SEED + 25)
    xt = torch.randn(TRAIN_B, 21, 7, generator=gen).to(device)
    y = torch.nn.functional.one_hot((xt[:, 10, 4] > 0).long(), 2).float()
    mask = torch.ones(TRAIN_B, device=device)
    p1, p2 = (params_from_numpy(init, device) for _ in range(2))
    st1, st2 = adam_init(p1), adam_init(p2)
    step1 = make_train_step(cfg, False, "fp32")
    step2 = make_sharded_train_step(cfg, 1e-3, mesh, model_axis="model")
    l1 = float(step1(p1, st1, xt, y, mask))
    l2 = float(step2(p2, st2, xt, y, mask))
    assert abs(l2 - l1) <= 1e-5 * abs(l1), (l1, l2)
    # the CPU test's bound (tests/test_torch_tensor_parallel.py): where
    # |g| >= 1e-7 (Adam's first moment 0.1 g), within TP_ATOL; everywhere
    # within the learning rate (Adam's first step turns float noise of a
    # gradient near its 1e-8 epsilon into up to ~1e-5 of the parameter)
    d = 0.0
    for a, b, mu in zip(param_leaves(p2), param_leaves(p1),
                        param_leaves(st1["mu"])):
        gap = (a - b).abs()
        assert float(gap.max()) <= 1e-3, float(gap.max())
        steady = mu.abs() >= 1e-8
        assert float(steady.float().mean()) > 0.9
        d = max(d, float(gap[steady].max()))
    assert d <= TP_ATOL, d
    ms1 = time_ms(lambda: step1(p1, st1, xt, y, mask))
    ms2 = time_ms(lambda: step2(p2, st2, xt, y, mask))
    log(f"{tag} train step B={TRAIN_B}: loss {l1:.7f} (1-D) / {l2:.7f} "
        f"(TP); params max |d| after one step (|g| >= 1e-7) {d:.3e}; step "
        f"{ms1:.4f} ms "
        f"1-D (K2/K3), {ms2:.4f} ms TP (CUDA events, median of 5); "
        f"{nvidia_smi_line()}")
    return {"predict_s": (tp_s, k1_s), "step_ms": (ms1, ms2),
            "max_dlogit": float(diff.max()), "flips": int(len(flips))}


def phase_pack57(device, workdir: str) -> dict:
    """(25 B) detect --fnum 57 over phase 7's pod5 set, a batch a file
    (16), with a seeded fnum-57 model, at T=21 (K1) and T=20 (K4), through
    the one compact path: on the card in fp32 and bf16, K1 / K4 counted
    around those runs, and on the cpu in fp32; the card's fp32 BEDs
    against the cpu's, any difference traced to near-tie window flips
    (``compare_devices``). Then the JAX package's histogram pack against
    the compact path: ``probe_compact_pack --fnum 57`` (predictions equal,
    the bytes a row and the walls of both)."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    ds = os.path.join(workdir, "ds")
    cfg = BiLSTMConfig(num_input=57)
    params = init_bilstm_params(SEED + 57, cfg, device="cpu")
    model = os.path.join(workdir, "model57.npz")
    save_bilstm_npz(model, params, cfg)
    out = {"launches": {}, "flips": {}}
    extra = ("--fnum", "57", "--threads", "1", "--files_per_thread", "1")
    for windowsize in PACK57_T:
        prefix = f"p57_w{windowsize}_"
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        for precision in ("fp32", "bf16"):
            run_detect(ds, os.path.join(workdir, f"{prefix}gpu_{precision}"),
                       "cuda", precision, model, windowsize, extra)
        torch.cuda.synchronize()
        k1 = windowsize % 2 == 1
        counts = dict(ops.LAUNCHES if k1 else ops.LAYERED_LAUNCHES)
        log(f"[pack57 T={windowsize}] {'K1' if k1 else 'K4'} launches "
            f"{counts} over 2 runs")
        assert counts["fp32"] > 0 and counts["bf16"] > 0, counts
        out["launches"][windowsize] = counts
        run_detect(ds, os.path.join(workdir, f"{prefix}cpu_fp32"), "cpu",
                   "fp32", model, windowsize, extra)
        res = compare_devices(device, ds, workdir, prefix, windowsize,
                              model=model, fnum=57)
        out["flips"][windowsize] = res["flips"]
    last = run_tool("probe_compact_pack", "--rows", "262144", "--passes",
                    "1", "--fnum", "57")[-1]
    assert last["identical"], last
    return out


def run_tool(name: str, *args: str) -> list:
    """A port tool's ``main`` in this process; its JSON lines. A tool's own
    check that fails (SystemExit) fails the phase."""
    import contextlib
    import importlib
    import io

    module = importlib.import_module(f"deepmod_tpu_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main(list(args))
    except SystemExit as exc:
        raise AssertionError(f"{name}: {exc}\n{buf.getvalue()[-3000:]}")
    for line in buf.getvalue().splitlines():
        log(f"[{name}] {line}")
    assert rc == 0, f"{name} returned {rc}"
    log(f"[{name}] {time.perf_counter() - t0:.1f} s")
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def phase_tools(workdir: str) -> None:
    """(25 C) the JAX package's remaining scripts, each port tool once at
    its smallest size on the card, in this process; each tool's own
    checks (it exits non-zero when one fails) and its result lines."""
    scale = os.path.join(workdir, "scale")
    last = run_tool("probe_compact_pack", "--rows", "262144", "--passes",
                    "1", "--fnum", "7")[-1]
    assert last["identical"], last
    rows = run_tool("probe_device_agg", "--reps", "1", "--cases",
                    "1000000:4600000")[-1]["rows"]
    assert all(r["counts_equal"] for r in rows), rows
    last = run_tool("bench_scale_multiproc", "--reads", "12", "--genome-bp",
                    "50000", "--nprocs", "1,2", "--workdir",
                    os.path.join(workdir, "scale_mp"))[-1]
    assert last["beds_identical"], last
    for tool, extra in (("validate_full_loop", ()),
                        ("coverage_scaling", ())):
        last = run_tool(tool, "--small", "--epochs", "1", "--threads", "1",
                        "--out", os.path.join(workdir, tool), *extra)[-1]
        log(f"[{tool}] {last}")
    last = run_tool("bench_scale", "--dataset", scale, "--reads", "50",
                    "--genome-mbp", "0.2", "--threads", "2", "--runs", "2")
    assert all(r["windows"] > 0 for r in last), last
    run_tool("probe_bf16_flips", "--windows", "65536", "--reads", "20")
    run_tool("probe_train_bf16", "--batches", "2048", "--iters", "5")
    run_tool("probe_tile", "--batch", "32768")
    run_tool("probe_lookahead", "--rows", "1048576", "--passes", "1")
    last = run_tool("probe_target_only", "--dataset", scale, "--reads", "50",
                    "--genome-mbp", "0.2", "--threads", "2")[-1]
    assert last["beds_identical"], last
    run_tool("probe_sigmoid", "--batches", "65536", "--iters", "4")


def phase_cluster_golden(device) -> dict:
    """The bundled cluster model (the reference's TF1 checkpoint, converted)
    on the golden input, TF32 off: within 1e-6 of the TF1 session's output
    and of the port's CPU run."""
    from deepmod_tpu_torch.models.cluster_mlp import (
        cluster_forward,
        cluster_params_from_numpy,
    )
    from deepmod_tpu_torch.tools.cluster_predict import load_cluster_model

    torch.backends.cuda.matmul.allow_tf32 = False
    golden = os.path.join(REPO, "tests", "golden")
    x = np.load(os.path.join(golden, "cluster_parity_x.npy"))
    want = np.load(os.path.join(golden, "cluster_parity_y.npy")).ravel()
    params = load_cluster_model(os.path.join(golden, "cluster_weights.npz"))
    got = {}
    for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
        p = cluster_params_from_numpy(params, dev)
        with torch.no_grad():
            got[tag] = cluster_forward(
                p, torch.from_numpy(x).to(dev)).cpu().numpy()
    err = float(np.abs(got["card"] - want).max())
    err_cpu = float(np.abs(got["card"] - got["cpu"]).max())
    log(f"[cluster golden] {len(x)} sites on the card: max abs difference "
        f"{err:.3e} from the TF1 session's output, {err_cpu:.3e} from the "
        f"port's cpu run (both must be <= 1e-6) | {nvidia_smi_line()}")
    assert err <= 1e-6 and err_cpu <= 1e-6, (err, err_cpu)
    return {"err": err, "err_cpu": err_cpu}


def _refined_bed(det_beds: list, rewritten: str, out: str) -> str:
    """detect's BED lines with the percentage column replaced by the second
    stage's where it rewrote the site (what ecoli_performance scores)."""
    new = {}
    if os.path.isfile(rewritten):  # none where merge kept no site
        with open(rewritten) as fh:
            for line in fh:
                p = line.split()
                new[(p[5], int(p[1]))] = p[-1]
    with open(out, "w") as fh:
        for path in filter(os.path.isfile, det_beds):
            with open(path) as src:
                for line in src:
                    p = line.split()
                    if (p[5], int(p[1])) in new:
                        p[10] = new[(p[5], int(p[1]))]
                    fh.write(" ".join(p) + "\n")
    return out


def _mod_total(beds: dict) -> int:
    return sum(int(line.split()[11]) for b in beds.values()
               for line in b.decode().splitlines())


def phase_cluster(device, workdir: str) -> dict:
    """The paper's 5mC loop through the CLI (tools/validate_cluster_loop's
    steps): a clustered pod5 cohort over chrT and chrE, a first-stage model
    trained on the card, detect on the card at bf16 and fp32 with
    --mod_cluster 0 and 1 (K1's launches counted around those four runs)
    and on the cpu at fp32 (BEDs byte-equal, phase 7's near-tie rule),
    merge, motif, clustertrain on the card (the loss must fall),
    clusterpred on the card and the cpu with the chrT-trained and the
    bundled model (predictions within 1e-5; percentages equal but where
    p*100 is within 1e-4 of an integer), and chrE's site-level AUC/AP
    before and after the second stage."""
    from deepmod_tpu_torch.models.cluster_mlp import cluster_params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr
    from deepmod_tpu_torch.tools import cluster_predict as cp
    from deepmod_tpu_torch.tools import validate_cluster_loop as loop
    from deepmod_tpu_torch.tools.evaluate import ecoli_performance

    cfg = loop.LoopConfig(
        out=os.path.join(workdir, "cluster"), device="cuda",
        chrom_size=CLUSTER_CHROM, n_train=CLUSTER_TRAIN_READS,
        n_cohort=CLUSTER_READS, shift=CLUSTER_SHIFT, threads=POOL_THREADS)
    os.makedirs(cfg.out)
    t0 = time.perf_counter()
    landscape = loop.synth_cohorts(cfg)
    log(f"[cluster] cohorts (chrT + chrE, {CLUSTER_CHROM} bases each): "
        f"{CLUSTER_READS} clustered reads, {CLUSTER_TRAIN_READS} + "
        f"{CLUSTER_TRAIN_READS} training reads (CG shift "
        f"{CLUSTER_SHIFT}), {time.perf_counter() - t0:.2f} s to write")

    # the first stage is trained here: phase 8's one-epoch model calls no
    # window methylated (its log: p=0.000 r=0.000); K2/K3 on this path
    tr.reset_launch_counts()
    t0 = time.perf_counter()
    model = loop.train_first_stage(cfg)
    torch.cuda.synchronize()
    train_launches = dict(tr.LAUNCHES)
    log(f"[cluster] first stage: getfeatures + {loop.EPOCHS} + {loop.EPOCHS} "
        f"epochs on the card in {time.perf_counter() - t0:.2f} s; K2/K3 "
        f"launches {train_launches}")
    assert train_launches["fwd_fp32"] > 0 and train_launches["bwd_fp32"] > 0
    ds = os.path.join(cfg.out, "clustered")
    shutil.copy(model, os.path.join(ds, "model.npz"))  # compare_devices's

    # the main path: counts from 0 just before, read just after
    ops.reset_launch_counts()
    walls = {}
    for mc in (0, 1):
        for precision in ("bf16", "fp32"):
            walls[f"mc{mc}_gpu_{precision}"] = loop.detect(
                cfg, "clustered", model,
                os.path.join(cfg.out, f"mc{mc}_gpu_{precision}"), precision,
                mc)[0]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[cluster] K1 launches on the main path: {launches}")
    assert launches["bf16"] > 0 and launches["fp32"] > 0, launches
    assert not any(ops.LAYERED_LAUNCHES.values()), ops.LAYERED_LAUNCHES
    for mc in (0, 1):
        walls[f"mc{mc}_cpu_fp32"] = loop.detect(
            cfg, "clustered", model,
            os.path.join(cfg.out, f"mc{mc}_cpu_fp32"), "fp32", mc,
            device="cpu")[0]
    cmp = compare_devices(device, ds, cfg.out, "mc0_", 21)
    mc1 = {k: read_beds(os.path.join(cfg.out, f"mc1_{k}"), "cluster_mod_pos")
           for k in ("gpu_bf16", "gpu_fp32", "cpu_fp32")}
    assert all(mc1.values()), {k: sorted(v) for k, v in mc1.items()}
    mc1_equal = mc1["gpu_fp32"] == mc1["cpu_fp32"]
    assert mc1_equal or cmp["flips"] > 0, "--mod_cluster 1 BEDs differ"
    plain = read_beds(os.path.join(cfg.out, "mc0_gpu_bf16"))
    rescued = _mod_total(mc1["gpu_bf16"])
    assert rescued > _mod_total(plain), (rescued, _mod_total(plain))
    log(f"[cluster] --mod_cluster 1: fp32 card BEDs equal the cpu's: "
        f"{mc1_equal}; bf16 methylated calls {_mod_total(plain)} -> "
        f"{rescued} with the rescue")
    for key, wall in walls.items():
        log(f"[cluster] detect {key}: wall {wall:.2f} s, "
            f"{cmp['windows'] / wall:.1f} windows/s end to end")

    # merge + motif over the card's default run (bf16, no rescue)
    det = os.path.join(cfg.out, "runs", "det")
    os.makedirs(det)
    for name in plain:
        shutil.copy(os.path.join(cfg.out, "mc0_gpu_bf16", name), det)
    t0 = time.perf_counter()
    prefix = loop.merge_and_motif(cfg, os.path.join(cfg.out, "runs"))
    merged = {c: sum(1 for _ in open(f"{prefix}.{c}.C.bed"))
              for c in loop.CHROMS}
    log(f"[cluster] merge + motif {time.perf_counter() - t0:.2f} s; merged "
        f"sites {merged}")
    assert min(merged.values()) >= 20, merged

    cluster_model = os.path.join(cfg.out, "cluster.npz")
    t0 = time.perf_counter()
    printed = loop.cluster_train(cfg, prefix, loop.write_truth(cfg, landscape),
                                 cluster_model, "cuda")
    wall = time.perf_counter() - t0
    first, last = (float(v) for v in
                   printed.split("loss ")[1].split(";")[0].split(" -> "))
    log(f"[cluster] clustertrain on the card ({loop.CLUSTER_EPOCHS} epochs): "
        f"{wall:.2f} s; {printed.strip()}")
    assert last < first, (first, last)

    bundled_prefix = os.path.join(cfg.out, "runs", "pred_bundled")
    for c in loop.CHROMS:
        shutil.copy(f"{prefix}.{c}.C.bed", f"{bundled_prefix}.{c}.C.bed")
    pred_err = {}
    for tag, pre, mdl in (("trained", prefix, cluster_model),
                          ("bundled", bundled_prefix, loop.BUNDLED_MODEL)):
        loop.cluster_pred(cfg, pre, mdl, "cpu")
        for c in loop.CHROMS:
            os.replace(f"{pre}_clusterCpG.{c}.C.bed",
                       f"{pre}_cpu_clusterCpG.{c}.C.bed")
        t0 = time.perf_counter()
        loop.cluster_pred(cfg, pre, mdl, "cuda")
        wall = time.perf_counter() - t0
        params = {dev: cluster_params_from_numpy(cp.load_cluster_model(mdl),
                                                 dev)
                  for dev in (device, "cpu")}
        n_diff = n_sites = 0
        pred_err[tag] = 0.0
        for c in loop.CHROMS:
            cg = cp._read_motif_positions(
                os.path.join(cfg.out, "motif", f"motif_{c}_C.bed"))
            keys, frac, _ = cp._read_pred_bed(f"{pre}.{c}.C.bed", cg)
            feats = cp.build_cluster_features(keys, frac)
            p_gpu = cp.predict_sites(params[device], feats)
            p_cpu = cp.predict_sites(params["cpu"], feats)
            pred_err[tag] = max(pred_err[tag],
                                float(np.abs(p_gpu - p_cpu).max()))
            with open(f"{pre}_clusterCpG.{c}.C.bed") as a, \
                    open(f"{pre}_cpu_clusterCpG.{c}.C.bed") as b:
                rows = list(zip(a.read().splitlines(), b.read().splitlines()))
            assert len(rows) == len(keys) > 0, (len(rows), len(keys))
            for (ga, gb), p in zip(rows, p_cpu):
                if ga != gb:
                    n_diff += 1
                    assert ga.rsplit(" ", 1)[0] == gb.rsplit(" ", 1)[0]
                    assert abs(p * 100 - round(p * 100)) < 1e-4, (ga, gb, p)
            n_sites += len(keys)
        log(f"[cluster] clusterpred {tag} model on the card: {wall:.2f} s, "
            f"{n_sites} sites; card vs cpu predictions max abs "
            f"{pred_err[tag]:.3e} (<= 1e-5), rewritten percentages that "
            f"differ {n_diff} (each a near-integer p*100) | "
            f"{nvidia_smi_line()}")
        assert pred_err[tag] <= 1e-5, pred_err

    report = loop.score(landscape, det, prefix, bundled_prefix)
    for tag, m in report.items():
        log(f"[cluster] {tag}: {m} | {nvidia_smi_line()}")
    assert report["chrE_cov5_trained"] is not None, report

    # ecoli_performance: the clustered cohort against the unmethylated
    # training cohort as control, CpG motif sites positive, on chrE
    ctl_runs = os.path.join(cfg.out, "ctl_runs")
    ctl_det = os.path.join(ctl_runs, "det")
    loop.detect(cfg, "train_ctl", model, ctl_det)
    ctl_prefix = loop.merge_and_motif(cfg, ctl_runs)
    loop.cluster_pred(cfg, ctl_prefix, cluster_model, "cuda")
    ref = loop.ref_path(cfg)
    mod_beds = [os.path.join(det, f"mod_pos.chrE{s}.C.bed") for s in "+-"]
    ctl_beds = [os.path.join(ctl_det, f"mod_pos.chrE{s}.C.bed") for s in "+-"]
    ecoli = {"before": ecoli_performance(mod_beds, ctl_beds, ref,
                                         chrom="chrE", make_plots=False)}
    ecoli["after"] = ecoli_performance(
        [_refined_bed(mod_beds, f"{prefix}_clusterCpG.chrE.C.bed",
                      os.path.join(cfg.out, "after_mod.bed"))],
        [_refined_bed(ctl_beds, f"{ctl_prefix}_clusterCpG.chrE.C.bed",
                      os.path.join(cfg.out, "after_ctl.bed"))],
        ref, chrom="chrE", make_plots=False)
    for when, m in ecoli.items():
        log(f"[cluster] ecoli_performance chrE {when} the second stage: "
            + ", ".join(f"{k} {m[k]:.4f}" for k in
                        ("auc_cov1", "ap_cov1", "auc_cov5", "ap_cov5"))
            + f", {int(m['num_sites'])} sites | {nvidia_smi_line()}")
        assert np.isfinite(m["auc_cov1"]), m
    return {"launches": launches, "train_launches": train_launches,
            "walls": walls, "report": report, "ecoli": ecoli,
            "pred_err": pred_err}


def phase_cluster_scale(device, workdir: str) -> dict:
    """clusterpred over a synthesized merged BED of SCALE_LINES lines on one
    chromosome (a human chromosome averages ~2.4 M strand CpG sites), with
    the bundled model: the time split (read, features, the MLP on the card
    by CUDA events, write) and sites/s through the CLI."""
    from deepmod_tpu_torch.models.cluster_mlp import (
        cluster_forward,
        cluster_params_from_numpy,
    )
    from deepmod_tpu_torch.tools import cluster_predict as cp
    from deepmod_tpu_torch.tools.validate_cluster_loop import BUNDLED_MODEL

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 11)
    root = os.path.join(workdir, "cluster_scale")
    os.makedirs(os.path.join(root, "motif"))
    t0 = time.perf_counter()
    n_dyads = SCALE_LINES  # a dyad is two strand sites; rows with mod 0 go
    dyad = np.cumsum(2 + rng.geometric(1 / 48, n_dyads))
    tile_meth = rng.random(int(dyad[-1]) // 250 + 1) < 0.5
    prob = np.where(tile_meth[dyad // 250], rng.uniform(0.7, 0.95, n_dyads),
                    rng.uniform(0.02, 0.15, n_dyads))
    pos = np.stack([dyad, dyad + 1], 1).ravel()
    cov = rng.integers(1, 40, 2 * n_dyads)
    mod = rng.binomial(cov, np.repeat(prob, 2))
    keep = np.flatnonzero(mod > 0)[:SCALE_LINES]  # merge drops mod 0
    assert len(keep) == SCALE_LINES, len(keep)
    with open(os.path.join(root, "motif", "motif_chr1_C.bed"), "w") as fh:
        fh.write("".join(f"chr1\t{p}\t+\nchr1\t{p + 1}\t-\n" for p in dyad))
    prefix = os.path.join(root, "pred")
    with open(f"{prefix}.chr1.C.bed", "w") as fh:
        fh.write("".join(
            "chr1 %d %d C %d %s  %d %d 0,0,0 %d %d %d\n" % (
                p, p + 1, min(c, 1000), "+-"[i % 2], p, p + 1, c,
                int(m * 100 / c), m)
            for i, p, c, m in zip(keep.tolist(), pos[keep].tolist(),
                                  cov[keep].tolist(), mod[keep].tolist())))
    log(f"[cluster scale] merged BED of {SCALE_LINES} lines on chr1 "
        f"({n_dyads} dyads over {int(dyad[-1])} bases): "
        f"{time.perf_counter() - t0:.2f} s to write")

    split = {}
    t0 = time.perf_counter()
    cg = cp._read_motif_positions(os.path.join(root, "motif",
                                               "motif_chr1_C.bed"))
    keys, frac, lines = cp._read_pred_bed(f"{prefix}.chr1.C.bed", cg)
    split["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = cp.build_cluster_features(keys, frac)
    split["features_s"] = time.perf_counter() - t0
    params = cluster_params_from_numpy(cp.load_cluster_model(BUNDLED_MODEL),
                                       device)
    x = torch.as_tensor(feats, device=device)

    def mlp():
        with torch.no_grad():
            return torch.cat([cluster_forward(params, x[lo : lo + cp.BATCH_SIZE])
                              for lo in range(0, len(x), cp.BATCH_SIZE)])

    mlp()
    torch.cuda.synchronize()
    split["mlp_ms"] = time_ms(mlp, reps=3)
    t0 = time.perf_counter()
    pred = cp.predict_sites(params, feats)
    split["h2d_mlp_d2h_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_cpu = cp.predict_sites(cluster_params_from_numpy(
        cp.load_cluster_model(BUNDLED_MODEL), "cpu"), feats)
    split["cpu_mlp_s"] = time.perf_counter() - t0
    err = float(np.abs(pred - pred_cpu).max())
    assert err <= 1e-5 and pred.shape == (len(keys),), (err, pred.shape)
    assert np.isfinite(pred).all() and ((pred >= 0) & (pred <= 1)).all()
    t0 = time.perf_counter()
    cp.write_rewritten(os.path.join(root, "split_out.bed"), lines, pred)
    split["write_s"] = time.perf_counter() - t0
    cli_wall = run_cli("clusterpred", prefix, os.path.join(root, "motif"),
                       "--model", BUNDLED_MODEL, "--chrs", "chr1",
                       "--device", "cuda")
    with open(f"{prefix}_clusterCpG.chr1.C.bed") as a, \
            open(os.path.join(root, "split_out.bed")) as b:
        assert a.read() == b.read()
    # 2 * (14*100 + 100*20 + 20*1) operations a site; features in, p out
    bound = max(len(keys) * 6840 / PEAK_OPS["fp32"],
                len(keys) * (14 + 1) * 4 / PEAK_BYTES) * 1e3
    log(f"[cluster scale] {len(keys)} sites: read {split['read_s']:.2f} s, "
        f"features {split['features_s']:.2f} s, MLP on the card "
        f"{split['mlp_ms']:.3f} ms (CUDA events; "
        f"{-(-len(keys) // cp.BATCH_SIZE)} calls of {cp.BATCH_SIZE} rows; "
        f"bound {bound:.4f} ms), H2D + MLP + D2H {split['h2d_mlp_d2h_s']:.3f}"
        f" s, the MLP on the cpu {split['cpu_mlp_s']:.3f} s (card vs cpu max "
        f"abs {err:.2e}), write {split['write_s']:.2f} s; clusterpred "
        f"through the CLI {cli_wall:.2f} s = {len(keys) / cli_wall:.1f} "
        f"sites/s end to end, the MLP alone "
        f"{len(keys) / split['mlp_ms'] * 1e3:.1f} sites/s | "
        f"{nvidia_smi_line()}")
    return dict(split, sites=len(keys), cli_wall=cli_wall, err=err)


def parallel_shards() -> list:
    """Phase 24's mesh: the one card PARALLEL_SHARDS times, or every card."""
    n = torch.cuda.device_count()
    if n == 1:
        return [torch.device("cuda", 0)] * PARALLEL_SHARDS
    return [torch.device("cuda", i) for i in range(n)]


def parallel_only() -> str:
    """``--parallel``: phase 7's detect runs (the one-card reference) and
    phase 24 alone, for a machine with several cards."""
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} x {torch.cuda.device_count()} | nvidia-smi: "
        f"{nvidia_smi_line()} | torch {torch.__version__}")
    with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as workdir:
        phase_detect(device, workdir)
        t_par = time.perf_counter()
        feats, gf_wall, minibatches = train_features(workdir,
                                                     PARALLEL_TRAIN_READS)
        log(f"[parallel] getfeatures {gf_wall:.2f} s: "
            f"{sum(len(mb[1]) for mb in minibatches)} windows in "
            f"{len(minibatches)} minibatches of <= {TRAIN_B}")
        par = phase_parallel(device, workdir, parallel_shards(), feats)
        log(f"[parallel] phase 24: {time.perf_counter() - t_par:.2f} s")
        n = torch.cuda.device_count()
        if n > 1:
            par["tp"] = phase_tensor_parallel(
                device, workdir, [torch.device("cuda", i) for i in range(n)])
    log(json.dumps({"parallel": par}))
    return name


def main(argv=None) -> int:
    global torch
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parallel", action="store_true",
                    help="phases 7, 24 and 25 (A) only (for several cards)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import deepmod_tpu_torch  # noqa: F401  (fails outside a checkout)

    adopt_orphans()
    try:
        kind = parallel_only() if args.parallel else smoke()
    finally:
        stop_children()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def smoke() -> str:
    """Every phase; the card's name."""
    from deepmod_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = _build.library()._name
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s)")
    build_log = _build.build_info["log"].splitlines()
    for line in build_log:
        if "Used " in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    injected = sum("C7519" in line for line in build_log)
    log(f"[build] ptxas injected a warpgroup.arrive into a wgmma chain "
        f"(C7519) {injected} times")
    hgmma = tensor_core_sass(lib_path)
    log(f"[build] HGMMA instructions in the SASS of the bf16 K1 / K4 / "
        f"K5a-c kernels (one template a padded width): {hgmma}")
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig

    for hidden in (100, 128):
        log(f"[build] the bf16 K1 / K4 / K5a-c tensor-core kernels at "
            f"H={hidden}: {tc_build_line(BiLSTMConfig(num_hidden=hidden))}")
    log(f"[build] K3's kernels: {k3_build_line()}")
    log(f"[build] the fp32 core (K1, K4, K5a-c fp32, K2, K6): "
        f"{f32_build_line()}")
    phase_native()

    kern = phase_kernel(device)
    tkern = phase_train_kernels(device)
    layered = phase_layered(device)
    k6 = phase_lstm_layer(device)
    probe = phase_probe(device, lib_path)
    t_k5 = time.perf_counter()
    sched = phase_schedules(device, kern)
    log(f"[K5] phase: {time.perf_counter() - t_k5:.2f} s")
    t_wide = time.perf_counter()
    phase_hidden_128(device)
    log(f"[H128] phase: {time.perf_counter() - t_wide:.2f} s")
    with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as workdir:
        det = phase_detect(device, workdir)
        t_pool = time.perf_counter()
        phase_pool(workdir, det["windows"])
        log(f"[pool] phase: {time.perf_counter() - t_pool:.2f} s")
        t_serve = time.perf_counter()
        tfk = phase_tf_checkpoint(workdir)
        srv = phase_serve(device, workdir, tfk["prefix"])
        log(f"[serve] phases 22-23: {time.perf_counter() - t_serve:.2f} s")
        det_k4 = phase_detect_layered(device, workdir)
        trn = phase_train(device, workdir)
        trn_k4 = phase_train_layered(device, workdir, trn["feats"])
        t_par = time.perf_counter()
        par = phase_parallel(device, workdir, parallel_shards(), trn["feats"])
        log(f"[parallel] phase 24: {time.perf_counter() - t_par:.2f} s")
        t_slice = time.perf_counter()
        phase_tensor_parallel(device, workdir, [device] * TP_SHARDS)
        p57 = phase_pack57(device, workdir)
        phase_tools(workdir)
        log(f"[phase 25] {time.perf_counter() - t_slice:.2f} s")
        t_cluster = time.perf_counter()
        phase_cluster_golden(device)
        clu = phase_cluster(device, workdir)
        phase_cluster_scale(device, workdir)
        log(f"[cluster] phase: {time.perf_counter() - t_cluster:.2f} s")
    t_tools = time.perf_counter()
    phase_host_tools()
    log(f"[host tools] phase: {time.perf_counter() - t_tools:.2f} s")
    for key, wall in det["walls"].items():
        log(f"[detect] {key}: wall {wall:.2f} s, "
            f"{det['windows'] / wall:.1f} windows/s end to end")

    def entry(name, source, replaces, launches, k, shard_launches=None):
        lib = k["library_ms"]
        return {
            "name": name, "route": "cuda",
            "source": "deepmod_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "shard_launches": shard_launches,
            "max_abs_err": float(f"{k['max_abs_err']:.2e}"),
            "ms": round(k["ms"], 3), "plain_ms": round(k["plain_ms"], 3),
            "bound_ms": round(k["bound_ms"], 3), "bound_by": k["bound_by"],
            "library_ms": None if lib is None else round(lib, 3),
        }

    # K1's main paths: detect (phase 7), detect from the TF prefix and
    # serve (phases 22-23), the cluster loop's detect runs and detect
    # --fnum 57 at T=21 (phase 25); K2/K3's: train (phase 8) and the
    # loop's first stage. K4's main path: detect at every LAYERED_T
    # window size and --fnum 57 at T=20
    k4_launches = {p: sum(r["launches"][p] for r in det_k4.values())
                   + p57["launches"][20][p] for p in ("fp32", "bf16")}
    kernels = []
    for precision in ("fp32", "bf16"):
        # a name ending in "_tc": a tensor-core (wgmma) kernel
        kernels.append(entry(
            f"k1_center_{precision}" + ("_tc" if precision == "bf16" else ""),
            "bilstm_fused.cu",
            "deepmod_tpu/ops/bilstm_fused.py:551",
            det["launches"][precision] + clu["launches"][precision]
            + tfk["launches"][precision] + srv["launches"][precision]
            + par["launches"][precision] + p57["launches"][21][precision],
            kern[precision], par["shard_launches"][precision]))
        for kind, line in (("fwd", 101), ("bwd", 222)):
            key = f"{kind}_{precision}"
            shards = [d[key] for d in par["train_shard_launches"][precision]]
            kernels.append(entry(
                f"k{2 if kind == 'fwd' else 3}_train_{kind}_{precision}",
                "bilstm_train.cu", f"deepmod_tpu/ops/bilstm_fused_train.py:{line}",
                trn["launches"][key] + clu["train_launches"][key]
                + sum(shards),
                tkern[precision][kind], shards))
        kernels.append(entry(
            f"k4_layer_{precision}" + ("_tc" if precision == "bf16" else ""),
            "bilstm_layer.cu",
            "deepmod_tpu/ops/bilstm_fused.py:197", k4_launches[precision],
            layered[precision]))
    kernels.append(entry("k6_lstm_layer_fp32", "lstm_layer.cu",
                         "deepmod_tpu/ops/lstm_pallas.py:74", k6["launches"], k6))
    for precision in ("fp32", "bf16"):
        kernels.append(entry(
            f"p1_probe_{precision}", "probe_transcendental.cu",
            "scripts/probe_transcendental.py:50",
            probe[precision]["launches"], probe[precision]))
    for precision in ("fp32", "bf16"):
        k5 = sched[precision]
        # K5b's error covers both gate stores; its times are fp32 gates'
        k5b = dict(k5["pregemm"], max_abs_err=max(
            k5["pregemm"]["max_abs_err"],
            k5["pregemm bf16 gates"]["max_abs_err"]))
        for kid, schedule, src_line, k in (
                ("k5a", "merged", 317, k5["merged"]),
                ("k5b", "pregemm", 392, k5b),
                ("k5c", "wavefront", 480, k5["wavefront"])):
            tc = "_tc" if precision == "bf16" else ""
            kernels.append(entry(
                f"{kid}_{schedule}_{precision}{tc}", f"bilstm_mono_{schedule}.cu",
                f"deepmod_tpu/ops/bilstm_fused.py:{src_line}", k["launches"],
                k))
    line = json.dumps({"kernels": kernels}, separators=(",", ":"))
    # seventeen entries with all twelve keys: about 5,100 characters on an
    # H100
    assert len(kernels) == 17 and len(line) < 6000, (len(kernels), len(line))
    log(line)
    log(smi)
    return name


if __name__ == "__main__":
    sys.exit(main())
