"""Probe: where the CUDA-core fp32 bodies that the fp32 core replaced spent
a step, and whether their weight reads from L2 bounded them.

    git archive 2fe4907 deepmod_tpu_torch | tar -x -C build/old_fp32
    python -m deepmod_tpu_torch.tools.stamp_old_fp32 --tree build/old_fp32

``--tree`` is a checkout of the port whose ``csrc/bilstm_layer.cu`` and
``csrc/bilstm_fused.cu`` still hold those bodies (``bilstm_layer_kernel``,
K4; ``bilstm_center_mono_kernel``, K1: commit 2fe4907 and before). The
tool copies that package twice into ``--out`` (default
``build/stamp_old_fp32``), inserts ``clock64()`` stamps into both step
loops for one watched thread (block 0, thread 0, a layer after the first)
and, in the second copy, folds every weight row the products read into
rows 0-7 (``k & 7`` in ``lstm_common.cuh::accumulate``: 12.8 KB, which
stays in L1; the same instructions, wrong results). Each copy is built in
its own build directory and run in a child process on 262,144 windows at
H=100: K4 fp32 at T=20, K1 fp32 at T=21. Prints each kernel's time and
the cycles of each span of steps 1-10 and their mean. Needs a CUDA GPU
and nvcc.
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


def make_copy(tree: str, out: str, l1: bool) -> str:
    """The stamped copy of ``tree``'s package under ``out``; with ``l1``
    the weight rows folded into rows 0-7."""
    pkg = os.path.join(tree, "deepmod_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    dst = os.path.join(out, "deepmod_tpu_torch")
    shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "csrc")
    edits = [("bilstm_layer.cu", patch_k4), ("bilstm_fused.cu", patch_k1)]
    if l1:
        edits.append(("lstm_common.cuh", lambda t: _rep(
            t, "const T* wk = w + static_cast<size_t>(k) * row;",
            "const T* wk = w + static_cast<size_t>(k & 7) * row;")))
    for name, fn in edits:
        path = os.path.join(csrc, name)
        with open(path) as fh:
            text = fh.read()
        with open(path, "w") as fh:
            fh.write(fn(text))
    return out


def _run_child(variant: str) -> None:
    import ctypes
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
        buf = (ctypes.c_longlong * 128)()
        read = getattr(lib, f"dmt_read_{tag}")
        read.argtypes = [ctypes.c_void_p]
        if read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("reading the stamps failed")
        st = np.array(buf[:], dtype=np.int64).reshape(16, 8)
        spans = np.array([np.diff(st[t, :6]) for t in range(1, 11)])
        names = SPANS[tag]
        print(f"[{variant}] {tag} mean of steps 1-10: " + "; ".join(
            f"{n} {v:.0f}" for n, v in zip(names, spans.mean(0)))
            + f"; total {spans.sum(1).mean():.0f} cycles")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.stamp_old_fp32",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                      "stamp_old_fp32"))
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        _run_child(args.child)
        return 0
    rc = 0
    for variant in ("as built", "weights in L1"):
        root = make_copy(os.path.abspath(args.tree), os.path.join(
            os.path.abspath(args.out), variant.replace(" ", "_")),
            variant != "as built")
        env = dict(os.environ, PYTHONPATH=root,
                   DMT_TORCH_BUILD_DIR=os.path.join(root, "kernels"))
        # this file runs the child: the copy (an older package) lacks it
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", args.tree,
             "--child", variant], env=env, cwd=root, check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
