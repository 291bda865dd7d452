"""Probe: where the CUDA-core fp32 bodies that the fp32 core replaced spent
a step, and whether their weight reads from L2 bounded them.

    git archive 2fe4907 deepmod_tpu_torch | tar -x -C build/old_fp32
    python -m deepmod_tpu_torch.tools.stamp_old_fp32 --tree build/old_fp32
    git archive b13ad67 deepmod_tpu_torch | tar -x -C build/old_k2
    python -m deepmod_tpu_torch.tools.stamp_old_fp32 --tree build/old_k2 \
        --kernels k2

``--tree`` is a checkout of the port that still holds the bodies named by
``--kernels``: ``k4`` (``csrc/bilstm_layer.cu::bilstm_layer_kernel``) and
``k1`` (``csrc/bilstm_fused.cu::bilstm_center_mono_kernel``), the default,
up to commit 2fe4907; ``k2`` (``csrc/bilstm_train.cu::train_fwd_kernel``,
the training forward that reads the TF kernels from L2 on every step) up
to b13ad67. The tool copies that package twice into ``--out`` (default
``build/stamp_old_fp32``), inserts ``clock64()`` stamps into the step
loops for one watched thread (block 0, thread 0, a layer after the first)
and, in the second copy, folds every weight row the products read into
rows 0-7 (``k & 7`` in the products' weight address: 12.8 KB at H=100,
which stays in L1; the same instructions, wrong results). Each copy is
built in its own build directory and run in a child process at H=100: K4
fp32 at T=20 and K1 fp32 at T=21 on 262,144 windows, K2 at T=21 on the
trainer's 2,048 windows in fp32 and bf16. Prints each kernel's time and
the cycles of each span of steps 1-10 and their mean; for K2 also the
digests of its outputs at a few shapes (``k2_digests``, which
``stamp_steps.py k2`` prints for the current K2: equal digests, equal
bits). Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SPANS = {
    "k4": ["stage x_t + barrier", "x product", "h product", "barrier",
           "cell + stores"],
    "k1": ["x product", "h product", "barrier", "cell + store", "barrier"],
    "k2": ["x product", "h product", "barrier", "cell", "stores", "barrier"],
}


def _decl(tag: str) -> str:
    return (f"\n__device__ long long dmt_st_{tag}[16][8];\n"
            f'extern "C" int dmt_read_{tag}(long long* out) {{\n'
            f"  return static_cast<int>(cudaMemcpyFromSymbol(out, "
            f"dmt_st_{tag}, sizeof(dmt_st_{tag})));\n}}\nnamespace {{\n")


def _st(tag: str, k: int, indent: str) -> str:
    return f"{indent}if (watch && t < 16) dmt_st_{tag}[t][{k}] = clock64();\n"


def _rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"anchor not found once (not the old body?): {old!r}")
    return text.replace(old, new, 1)


def patch_k4(text: str) -> str:
    """bilstm_layer.cu's ``bilstm_layer_kernel`` with its stamps."""
    text = text.replace("namespace {\n", _decl("k4"), 1)
    loop = "  for (int t = 0; t < steps; ++t) {\n"
    text = _rep(text, loop, "  const bool watch = blockIdx.x == 0 && "
                "blockIdx.y == 0 && threadIdx.x == 0 && in_dim == hidden;\n"
                + loop + _st("k4", 0, "    "))
    text = _rep(text, "    __syncthreads();\n    float acc[4][kR];\n",
                "    __syncthreads();\n" + _st("k4", 1, "    ")
                + "    float acc[4][kR];\n")
    h = "    if (t > 0) {  // h_{-1} = 0 contributes nothing\n      accumulate(hs"
    text = _rep(text, h, _st("k4", 2, "    ") + h)
    bar = ("    // every thread has read x_t and h_{t-1} before either is "
           "rewritten\n    __syncthreads();\n")
    text = _rep(text, bar, _st("k4", 3, "    ") + bar + _st("k4", 4, "    "))
    end = "    }\n  }\n}\n\ntemplate <typename T, bool kPrescaled>\nint launch("
    return _rep(text, end, "    }\n" + _st("k4", 5, "    ") + end[6:])


def patch_k1(text: str) -> str:
    """bilstm_fused.cu's ``bilstm_center_mono_kernel`` with its stamps."""
    text = text.replace("namespace {\n", _decl("k1"), 1)
    loop = "    for (int t = 0; t < steps; ++t) {\n"
    text = _rep(text, loop, "    const bool watch = blockIdx.x == 0 && "
                "blockIdx.y == 0 && threadIdx.x == 0 && layer == 1;\n" + loop
                + _st("k1", 0, "      "))
    h = ("      if (t > 0) {  // h_{-1} = 0 contributes nothing\n"
         "        accumulate(seq")
    text = _rep(text, h, _st("k1", 1, "      ") + h)
    bar = ("      // every thread has read row t (and row t-1) before row t "
           "is rewritten\n      __syncthreads();\n")
    text = _rep(text, bar, _st("k1", 2, "      ") + bar
                + _st("k1", 3, "      "))
    end = "      __syncthreads();\n    }\n    wl +="
    return _rep(text, end, _st("k1", 4, "      ") + "      __syncthreads();\n"
                + _st("k1", 5, "      ") + "    }\n    wl +=")


def patch_k2(text: str) -> str:
    """bilstm_train.cu's ``train_fwd_kernel`` with its stamps."""
    text = text.replace("namespace {\n", _decl("k2"), 1)
    loop = "    for (int t = 0; t < steps; ++t) {\n"
    text = _rep(text, loop, "    const bool watch = blockIdx.x == 0 && "
                "blockIdx.y == 0 && threadIdx.x == 0 && layer == 1;\n" + loop
                + _st("k2", 0, "      "))
    h = "      if (t > 0) {  // h_{-1} = 0 contributes nothing\n"
    text = _rep(text, h, _st("k2", 1, "      ") + h)
    bar = ("      // every thread has read row t and the carry before either "
           "changes\n      __syncthreads();\n")
    text = _rep(text, bar, _st("k2", 2, "      ") + bar
                + _st("k2", 3, "      "))
    cell = "      // the fp32 carry for this layer's next step"
    text = _rep(text, cell, _st("k2", 4, "      ") + cell)
    end = ("      __syncthreads();\n    }\n    wl += static_cast<size_t>"
           "(lin + hidden) * gates;")
    bar = "      __syncthreads();\n"
    return _rep(text, end, _st("k2", 5, "      ") + bar
                + _st("k2", 6, "      ") + end[len(bar):])


def _fold(text: str, typ: str) -> str:
    """The products' weight row k read at row k & 7."""
    return _rep(text, f"const {typ}* wk = w + static_cast<size_t>(k) * row;",
                f"const {typ}* wk = w + static_cast<size_t>(k & 7) * row;")


# per kernel: its source, its stamps, and where its products read a weight
# row (source, the pointer's type)
PATCHES = {
    "k4": ("bilstm_layer.cu", patch_k4, ("lstm_common.cuh", "T")),
    "k1": ("bilstm_fused.cu", patch_k1, ("lstm_common.cuh", "T")),
    "k2": ("bilstm_train.cu", patch_k2, ("bilstm_train.cu", "float")),
}


def make_copy(tree: str, out: str, l1: bool,
              kernels: Sequence[str] = ("k4", "k1")) -> str:
    """The stamped copy of ``tree``'s package under ``out`` with the stamps
    of ``kernels``; with ``l1`` their weight rows folded into rows 0-7."""
    pkg = os.path.join(tree, "deepmod_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    dst = os.path.join(out, "deepmod_tpu_torch")
    shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "csrc")
    edits = [PATCHES[k][:2] for k in kernels]
    if l1:
        folds = {PATCHES[k][2] for k in kernels}
        edits += [(name, lambda t, typ=typ: _fold(t, typ))
                  for name, typ in sorted(folds)]
    for name, fn in edits:
        path = os.path.join(csrc, name)
        with open(path) as fh:
            text = fh.read()
        with open(path, "w") as fh:
            fh.write(fn(text))
    return out


# K2's digest shapes: (hidden, batch, T)
DIGEST_CASES = ((100, 2083, 21), (100, 37, 8), (100, 2048, 20), (128, 2083, 21))


def k2_digests(device) -> list:
    """One line per shape of DIGEST_CASES and precision: the sha-256 of
    the (hs, cs) bytes ``train_fwd`` returns on inputs made from a seed,
    to compare two builds' bits (this tool's old K2, ``stamp_steps.py
    k2``'s current one)."""
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


def _stamp_spans(lib, tag: str) -> str:
    """The watched thread's stamps of ``tag``: each span's mean over steps
    1-10, cycles."""
    import ctypes

    import numpy as np

    buf = (ctypes.c_longlong * 128)()
    read = getattr(lib, f"dmt_read_{tag}")
    read.argtypes = [ctypes.c_void_p]
    if read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the stamps failed")
    st = np.array(buf[:], dtype=np.int64).reshape(16, 8)
    names = SPANS[tag]
    spans = np.array([np.diff(st[t, :len(names) + 1]) for t in range(1, 11)])
    return ("; ".join(f"{n} {v:.0f}" for n, v in zip(names, spans.mean(0)))
            + f"; total {spans.sum(1).mean():.0f} cycles")


def _run_child(variant: str, kernels: Sequence[str]) -> None:
    import statistics

    import numpy as np
    import torch

    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.ops import _build
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    lib = _build.library()
    dev = torch.device("cuda", 0)

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

    for tag, timesteps, mono in (("k4", 20, False), ("k1", 21, None)):
        if tag not in kernels:
            continue
        cfg = BiLSTMConfig(timesteps=timesteps)
        params = init_bilstm_params(2024, cfg, device=dev)
        packed = ops.pack_bilstm_params(params, cfg, "fp32")
        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            (262144, timesteps, cfg.num_input), dtype=np.float32)).to(dev)
        ms = time_ms(lambda: ops.bilstm_center_features(
            packed, x, cfg, "fp32", mono=mono))
        print(f"[{variant}] {tag} fp32 T={timesteps} B=262144: {ms:.3f} ms")
        ops.bilstm_center_features(packed, x, cfg, "fp32", mono=mono)
        torch.cuda.synchronize()
        print(f"[{variant}] {tag} mean of steps 1-10: "
              + _stamp_spans(lib, tag))
    if "k2" in kernels:
        from deepmod_tpu_torch.ops import bilstm_fused_train as tr

        cfg = BiLSTMConfig()
        params = init_bilstm_params(2024, cfg, device=dev)
        weights = tr.stack_lanes(params)
        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            (2048, cfg.timesteps, cfg.num_input), dtype=np.float32)).to(dev)
        for precision in tr.PRECISIONS:
            xin = tr.layer_inputs(x.to(tr.storage_dtype(precision)),
                                  tr.readout(cfg.timesteps)[0])
            ms = time_ms(lambda: tr.train_fwd(xin, weights, cfg.forget_bias),
                         reps=5)
            print(f"[{variant}] k2 {precision} T={cfg.timesteps} B=2048: "
                  f"{ms:.4f} ms")
            tr.train_fwd(xin, weights, cfg.forget_bias)
            torch.cuda.synchronize()
            print(f"[{variant}] k2 {precision} mean of steps 1-10: "
                  + _stamp_spans(lib, "k2"))
        if variant == "as built":
            for line in k2_digests(dev):
                print(f"[{variant}] {line}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.stamp_old_fp32",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                      "stamp_old_fp32"))
    parser.add_argument("--kernels", default="k4,k1",
                        help="comma-separated: k4, k1 (up to 2fe4907), k2 "
                        "(up to b13ad67)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(PATCHES):
        parser.error(f"--kernels: one or more of {sorted(PATCHES)}")
    if args.child:
        _run_child(args.child, kernels)
        return 0
    rc = 0
    for variant in ("as built", "weights in L1"):
        root = make_copy(os.path.abspath(args.tree), os.path.join(
            os.path.abspath(args.out), variant.replace(" ", "_")),
            variant != "as built", kernels)
        env = dict(os.environ, PYTHONPATH=root,
                   DMT_TORCH_BUILD_DIR=os.path.join(root, "kernels"))
        # this file runs the child: the copy (an older package) lacks it
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", args.tree,
             "--kernels", args.kernels, "--child", variant], env=env,
            cwd=root, check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
