"""Probe: where a recurrent kernel's step time goes, in SM clock cycles.

    python -m deepmod_tpu_torch.tools.stamp_steps k1 [--out DIR]
    python -m deepmod_tpu_torch.tools.stamp_steps k3 [--out DIR]
    python -m deepmod_tpu_torch.tools.stamp_steps k1f32 | k4f32 [--out DIR]
    python -m deepmod_tpu_torch.tools.stamp_steps k2 [--out DIR]

Copies the package into ``DIR`` (default ``build/stamp_steps``, ignored by
git), inserts ``clock64()`` stamps at fixed points of one kernel's step
loop for one watched thread (block 0, lane 0, thread 0), builds that copy
with nvcc in a build directory of its own and runs it in a child process:

- ``k1``: bf16 K1 (``csrc/bilstm_fused.cu::run_layer_k1``) at H=100, T=21
  on 262,144 windows, layers 1-2 of the watched tile; stamps after the two
  chains' wait, after the cell, after the barrier. Prints K1's and K5a's
  times in turns (median of 3 rounds) from the stamped build;
- ``k3``: K3's recurrence (``csrc/bilstm_train.cu::train_bwd_kernel``) at
  H=100, batch 2,048, layer 1 fp32; stamps after the cell's backward,
  the first barrier, the dh product, the reduce-scatter, the second
  barrier;
- ``k1f32`` / ``k4f32``: the fp32 core's step (``csrc/lstm_f32.cuh::
  run_layer``), in K1 fp32 at H=100, T=21 or in K4 fp32 at T=20, on
  262,144 windows, layers 1-2 of the watched tile-lane (CTA 0 of its
  cluster); stamps after the operand issue (x_{t+1}), the product, the
  cell, the h exchange through distributed shared memory with x_{t+1}
  completed and the cluster barrier's arrive, the step's global stores,
  the barrier's wait. The core is a header that K1's and K4's sources
  both include: the stamps are compiled only into the watched kernel's
  source (``DMT_STAMP`` defined there). Prints the kernel's time;
- ``k2``: the same core's step in K2 (``csrc/bilstm_train.cu``, the
  training forward) at its default launch (``fwd_shape``) at H=100, T=21
  on the trainer's 2,048 windows, layers 1-2 of the watched tile-lane in
  fp32; the global stores are K2's residuals (h and c of every window,
  and the rounded h row for the next layer). Prints K2's time in fp32
  and bf16, and the digests of its outputs at a few shapes
  (``k2_digests``: two builds that print the same digests give the same
  bits).

Prints the cycles of each span for steps 1-10 and their mean. Needs a
CUDA GPU and nvcc. The stamps cost a few instructions a step, so the
times it prints are those of the stamped build.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)

DECL = '''
__device__ long long dmt_stamps[16][8];
extern "C" int dmt_read_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, dmt_stamps,
                                               sizeof(dmt_stamps)));
}
namespace {
'''


def _st(k: int, step: str, indent: str = "    ") -> str:
    return (f"{indent}if (watch && {step} < 16) "
            f"dmt_stamps[{step}][{k}] = clock64();\n")


# per kernel: (source, start of the patched span, end of it, watched-thread
# condition, the step variable, [(anchor, stamp index, where)], the spans'
# names); a stamp goes before or after its anchor, or "inside" it, after
# the anchor's first line
KERNELS = {
    "k1": ("bilstm_fused.cu",
           "__device__ __forceinline__ void run_layer_k1(",
           "// one lane of one 64-window tile, every layer",
           "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && "
           "L.in_dim == L.hidden", "t",
           [("  for (int t = 0; t < L.steps; ++t) {\n", 0, "after"),
            ("    tc::fence_acc(acc);\n\n    // the cell", 1, "inside"),
            ("    if (t + 1 < L.steps) tc::x_complete<kT>", 2, "before"),
            ("    tc::step_barrier<kCluster>();\n  }\n\n  if (io.seq_out", 3,
             "inside")],
           ["two chains + wait", "cell", "x complete + barrier"]),
    "k3": ("bilstm_train.cu",
           "train_bwd_kernel(const float* __restrict__ gates",
           "// ------------------------------------------- K3's products",
           "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0", "t",
           [("  for (int t = steps - 1; t >= 0; --t) {\n", 0, "after"),
            ("    __syncthreads();\n\n    // this lane's quarter", 1, "before"),
            ("    // this lane's quarter", 2, "before"),
            ("    // reduce-scatter over the 4 threads", 3, "before"),
            ("    // the next step overwrites da\n", 4, "before"),
            ("    // the next step overwrites da\n    __syncthreads();\n", 5,
             "after")],
           ["loads + cell backward + da stores", "barrier 1", "dh product",
            "reduce-scatter", "barrier 2"]),
}


# the fp32 core's step (csrc/lstm_f32.cuh::run_layer), which K1 and K4
# share: (anchor, stamp index, where) as above
F32_ANCHORS = [
    ("  for (int t = 0; t < L.steps; ++t) {\n", 0, "after"),
    ("    float acc[4][kR];\n", 1, "before"),
    ("    float h[kR];\n", 2, "before"),
    ("    const int at = ", 3, "before"),
    ("    // the step's global stores, while the barrier settles\n", 4,
     "before"),
    ("    if constexpr (kCluster) {\n      tc::cluster_wait();", 5, "before"),
    ("      tc::cluster_wait();\n    } else {\n      __syncthreads();\n"
     "    }\n", 6, "after"),
]
for _name, _host in (("k1f32", "bilstm_fused.cu"),
                     ("k4f32", "bilstm_layer.cu"), ("k2", "bilstm_train.cu")):
    # an eighth field: the source that includes the header and watches
    KERNELS[_name] = (
        "lstm_f32.cuh",
        "__device__ __forceinline__ void run_layer(const Smem& sm",
        "// runtime split -> F(kSplit)",
        "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && "
        "L.in_dim == L.hidden", "t", F32_ANCHORS,
        ["operand issue", "product", "cell",
         "h exchange + x complete + arrive",
         "residual stores" if _name == "k2" else "global stores",
         "barrier wait"], _host)


def patch(kernel: str, text: str) -> str:
    """The source ``text`` of ``kernel`` with the stamps inserted; raises
    if an anchor is missing or not unique (the source changed). In a
    header (the fp32 core) the stamps and their buffer compile only where
    ``DMT_STAMP`` is defined."""
    _, start, end, cond, step, anchors = KERNELS[kernel][:6]
    header = KERNELS[kernel][0].endswith(".cuh")
    if header:
        text = text.replace(
            "#pragma once\n", "#pragma once\n#ifdef DMT_STAMP"
            + DECL.replace("namespace {\n", "") + "#endif\n", 1)
    else:
        text = text.replace("namespace {\n", DECL, 1)
    i, j = text.index(start), text.index(end)
    body = text[i:j]
    first = anchors[0][0]
    watch = f"  const bool watch = {cond};\n"
    if header:
        watch = f"#ifdef DMT_STAMP\n{watch}#endif\n"
    body = body.replace(first, watch + first, 1)
    for anchor, k, where in anchors:
        if body.count(anchor) != 1:
            raise ValueError(f"{kernel}: anchor not found once: {anchor!r}")
        stamp = _st(k, step)
        if header:
            stamp = f"#ifdef DMT_STAMP\n{stamp}#endif\n"
        if where == "after":
            new = anchor + stamp
        elif where == "before":
            new = stamp + anchor
        else:  # after the first line of the anchor
            head, rest = anchor.split("\n", 1)
            new = head + "\n" + stamp + rest
        body = body.replace(anchor, new, 1)
    return text[:i] + body + text[j:]


def make_copy(kernel: str, out: str) -> str:
    """Copy the package into ``out`` with ``kernel``'s stamps; returns the
    copy's root (to put on PYTHONPATH)."""
    dst = os.path.join(out, "deepmod_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "csrc", KERNELS[kernel][0])
    with open(src) as fh:
        text = fh.read()
    with open(src, "w") as fh:
        fh.write(patch(kernel, text))
    if len(KERNELS[kernel]) > 7:  # the source that watches the header
        host = os.path.join(dst, "csrc", KERNELS[kernel][7])
        with open(host) as fh:
            text = fh.read()
        with open(host, "w") as fh:
            fh.write("#define DMT_STAMP 1\n" + text)
    return out


# K2's digest shapes: (hidden, batch, T)
DIGEST_CASES = ((100, 2083, 21), (100, 37, 8), (100, 2048, 20), (128, 2083, 21))


def k2_digests(device) -> list:
    """One line per shape of DIGEST_CASES and precision: the sha-256 of
    the (hs, cs) bytes ``train_fwd`` returns on inputs made from a seed,
    to compare two builds' bits."""
    import hashlib

    import numpy as np
    import torch

    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import bilstm_fused_train as tr

    lines = []
    for hidden, batch, timesteps in DIGEST_CASES:
        cfg = BiLSTMConfig(num_hidden=hidden, timesteps=timesteps)
        params = init_bilstm_params(7 + batch, cfg, device=device)
        gen = torch.Generator().manual_seed(batch)
        for lane in ("fw", "bw"):
            for lp in params[lane]:
                lp["bias"] = (0.1 * torch.randn(lp["bias"].shape,
                                                generator=gen)).to(device)
        weights = tr.stack_lanes(params)
        x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
            (batch, timesteps, 7), dtype=np.float32)).to(device)
        for precision in tr.PRECISIONS:
            xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)),
                                  tr.readout(timesteps)[0])
            hs, cs = tr.train_fwd(xin, weights, cfg.forget_bias)
            raw = b"".join(t.cpu().contiguous().view(torch.uint8).numpy()
                           .tobytes() for t in (hs, cs))
            lines.append(f"k2 digest H={hidden} B={batch} T={timesteps} "
                         f"{precision}: {hashlib.sha256(raw).hexdigest()[:20]}")
    return lines


def _run_child(kernel: str) -> None:
    """In the stamped copy: run the kernel, print times and stamps."""
    import ctypes
    import statistics

    import numpy as np
    import torch

    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import _build

    lib = _build.library()
    dev = torch.device("cuda", 0)
    cfg = BiLSTMConfig()
    params = init_bilstm_params(2024, cfg, device=dev)

    def time_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    if kernel == "k2":
        from deepmod_tpu_torch.ops import bilstm_fused_train as tr

        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            (2048, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(dev)
        weights = tr.stack_lanes(params)
        steps = tr.readout(cfg.timesteps)[0]
        shape = tr.fwd_shape(cfg.num_input, cfg.num_hidden)
        for precision in ("bf16", "fp32"):  # fp32's stamps are read
            xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)), steps)
            ms = time_ms(lambda: tr.train_fwd(xin, weights, cfg.forget_bias),
                         reps=5)
            print(f"K2 {precision} T={cfg.timesteps} B=2048 at {shape}: "
                  f"{ms:.4f} ms")
        for line in k2_digests(dev):
            print(line)
        tr.train_fwd(xin, weights, cfg.forget_bias)
        steps = range(1, 10)
    elif kernel in ("k1f32", "k4f32"):
        from deepmod_tpu_torch.ops import bilstm_fused as ops

        cfg = BiLSTMConfig(timesteps=21 if kernel == "k1f32" else 20)
        params = init_bilstm_params(2024, cfg, device=dev)
        packed = ops.pack_bilstm_params(params, cfg, "fp32")
        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            (262144, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(dev)
        mono = None if kernel == "k1f32" else False
        ms = time_ms(lambda: ops.bilstm_center_features(
            packed, x, cfg, "fp32", mono=mono))
        print(f"{kernel[:2].upper()} fp32 T={cfg.timesteps} B=262144 at "
              f"{ops.f32_shape(cfg.num_input, cfg.num_hidden)}: {ms:.3f} ms")
        ops.bilstm_center_features(packed, x, cfg, "fp32", mono=mono)
        steps = range(1, 10)
    elif kernel == "k1":
        from deepmod_tpu_torch.ops import bilstm_fused as ops

        packed = ops.pack_bilstm_params(params, cfg, "bf16")
        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            (262144, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(
                dev).bfloat16()
        rounds = {"K1": [], "K5a": []}
        for _ in range(3):
            rounds["K1"].append(time_ms(lambda: ops.bilstm_center_features(
                packed, x, cfg, "bf16")))
            rounds["K5a"].append(time_ms(lambda: ops.bilstm_center_mono(
                packed, x, cfg, "bf16", merged_gemm=True)))
        for name, r in rounds.items():
            print(f"{name} bf16 B=262144: {statistics.median(r):.3f} ms "
                  f"(rounds {[round(v, 3) for v in r]})")
        ops.bilstm_center_features(packed, x, cfg, "bf16")
        steps = range(1, 11)
    else:
        from deepmod_tpu_torch.ops import bilstm_fused_train as tr

        xin = tr.layer_inputs(torch.from_numpy(
            np.random.default_rng(2024).standard_normal(
                (2048, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(
                    dev), tr.readout(cfg.timesteps)[0])
        weights = tr.stack_lanes(params)
        hs, cs = tr.train_fwd(xin, weights, cfg.forget_bias)
        dh = torch.randn_like(hs[0]) / 2048
        args = (hs[0], hs[1], cs[1], dh, *weights[1], cfg.forget_bias)
        print(f"K3 layer 1 fp32 B=2048: {time_ms(lambda: tr.train_bwd(*args)):.4f}"
              " ms")
        tr.train_bwd(*args)
        steps = range(9, -1, -1)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 128)()
    lib.dmt_read_stamps.argtypes = [ctypes.c_void_p]
    if lib.dmt_read_stamps(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the stamps failed")
    st = np.array(buf[:], dtype=np.int64).reshape(16, 8)
    names = KERNELS[kernel][6]
    n = len(names)
    spans = np.array([np.diff(st[t, :n + 1]) for t in steps])
    for t, d in zip(steps, spans):
        print(f"step {t}: " + "; ".join(f"{a} {v}" for a, v in zip(names, d))
              + f"; total {int(d.sum())}")
    print("mean: " + "; ".join(f"{a} {v:.0f}" for a, v in
                               zip(names, spans.mean(0)))
          + f"; total {spans.sum(1).mean():.0f} cycles")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.stamp_steps",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("kernel", choices=sorted(KERNELS))
    parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                      "stamp_steps"))
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        _run_child(args.kernel)
        return 0
    root = make_copy(args.kernel, os.path.abspath(args.out))
    env = dict(os.environ, PYTHONPATH=root,
               DMT_TORCH_BUILD_DIR=os.path.join(root, "kernels"))
    return subprocess.run(
        [sys.executable, "-m", "deepmod_tpu_torch.tools.stamp_steps",
         args.kernel, "--child"], env=env, cwd=root, check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
