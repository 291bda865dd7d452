"""Build the port's CUDA kernels into one shared library, bound with ctypes.

Every ``csrc/*.cu`` source (``bilstm_fused.cu``: K1; ``bilstm_train.cu``:
K2, K3; ``bilstm_layer.cu``: K4; ``bilstm_mono_merged.cu``,
``bilstm_mono_pregemm.cu``, ``bilstm_mono_wavefront.cu``: K5a-c;
``lstm_layer.cu``: K6; ``probe_transcendental.cu``: P1; the bf16 modes of
K1, K4 and K5a-c include ``lstm_tc.cuh``, the fp32 modes of K1, K4 and
K5a-c, K2 and K6 ``lstm_f32.cuh``) is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, and the objects are linked into
``build/kernels/libdmt_torch_kernels.so`` at the repository root. The
sources carry a plain C interface, so no PyTorch header is compiled and
a build takes seconds. The build runs at first use, from the sources in
the checkout only, and is reused while the sources' content hash is
unchanged. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.environ.get(
    "DMT_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(_PKG), "build", "kernels"),
)
LIB_NAME = "libdmt_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the bytes of shared memory a block may use on Hopper, which every
# wrapper checks before it launches
MAX_SMEM = 232448

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds taken and the compilers' messages
# (``-Xptxas -v``: registers, shared memory and spills per kernel)
build_info = {"seconds": 0.0, "log": "", "cached": False}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for path in sources + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(ARCH_FLAGS + flags).encode())
    return h.hexdigest()[:16]


def build(sources=None, defines=(), build_dir: Optional[str] = None) -> str:
    """Compile the kernels if their sources changed; return the .so path.
    By default every source with the default flags into ``BUILD_DIR``;
    ``variant_library`` passes a subset, ``-D`` defines and its own
    directory."""
    sources = _sources() if sources is None else sources
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = _digest(sources, flags)
    out_dir = os.path.join(build_dir or BUILD_DIR, digest)
    lib_path = os.path.join(out_dir, LIB_NAME)
    default = build_dir is None  # build_info describes the default build
    if os.path.exists(lib_path):
        if default:
            build_info.update(seconds=0.0, log="", cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    objs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        objs.append(obj)
        cmd = [nvcc, *ARCH_FLAGS, *flags, "-c", src, "-o", obj]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    if default:
        build_info.update(
            seconds=time.perf_counter() - t0, log="".join(log), cached=False
        )
    return lib_path


def _bind_k1(lib: ctypes.CDLL) -> None:
    """What ``bilstm_fused.cu`` exports: K1 in both precisions and the
    error string."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q = ctypes.c_longlong
    # K1 fp32 (the fp32 core): x, stride_b, stride_t, stride_f, batch,
    # timesteps, in_dim, hidden, num_layers, w, bias, forget_bias, the
    # workspace, out, tile, split, stream
    lib.dmt_bilstm_center_f32.argtypes = [p, q, q, q, i, i, i, i, i, p, p, f,
                                          p, p, i, i, p]
    lib.dmt_bilstm_center_f32.restype = ctypes.c_int
    # K1 bf16 (tensor cores, 64 windows a block): the fp32 arguments with
    # the tensor-core packing as w and bias, then the workspace, out,
    # stream
    lib.dmt_bilstm_center_bf16.argtypes = [p, q, q, q, i, i, i, i, i, p, p,
                                           f, p, p, p]
    lib.dmt_bilstm_center_bf16.restype = ctypes.c_int
    lib.dmt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dmt_cuda_error_string.restype = ctypes.c_char_p


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q = ctypes.c_longlong
    n = ctypes.POINTER(ctypes.c_int)
    _bind_k1(lib)
    # K5a fp32 (the fp32 core, the merged operand ring): K1 fp32's
    # arguments
    lib.dmt_bilstm_merged_f32.argtypes = lib.dmt_bilstm_center_f32.argtypes
    lib.dmt_bilstm_merged_f32.restype = ctypes.c_int
    # K5c fp32 (the fp32 core, a persistent grid of clusters of a CTA
    # group a layer): K1 fp32's arguments up to forget_bias, then out,
    # tile, split, the grid's slots, stream; and its clusters resident at
    # once (in_dim, hidden, num_layers, tile, split)
    lib.dmt_bilstm_wavefront_f32.argtypes = [p, q, q, q, i, i, i, i, i, p,
                                             p, f, p, i, i, i, p]
    lib.dmt_bilstm_wavefront_f32.restype = ctypes.c_int
    lib.dmt_bilstm_wavefront_f32_clusters.argtypes = [i, i, i, i, i, n]
    lib.dmt_bilstm_wavefront_f32_clusters.restype = ctypes.c_int
    # K5a bf16 (tensor cores, 64 windows a block): K1 bf16's arguments
    lib.dmt_bilstm_merged_bf16.argtypes = [p, q, q, q, i, i, i, i, i, p, p,
                                           f, p, p, p]
    lib.dmt_bilstm_merged_bf16.restype = ctypes.c_int
    # K5b fp32 (the fp32 core, persistent grid): K1 fp32's arguments up
    # to forget_bias, then gx, gate_bf16, the row workspace, the grid's
    # slots, out, tile, split, stream; and its clusters resident at once
    # (in_dim, hidden, tile, split, gate_bf16)
    lib.dmt_bilstm_pregemm_f32.argtypes = [p, q, q, q, i, i, i, i, i, p, p,
                                           f, p, i, p, i, p, i, i, p]
    lib.dmt_bilstm_pregemm_f32.restype = ctypes.c_int
    lib.dmt_bilstm_pregemm_f32_clusters.argtypes = [i, i, i, i, i, n]
    lib.dmt_bilstm_pregemm_f32_clusters.restype = ctypes.c_int
    # K5b bf16 (tensor cores, persistent grid): K1's arguments with the
    # tensor-core packing, then gx, gate_bf16, the row workspace, the
    # grid's slots, out, stream
    lib.dmt_bilstm_pregemm_bf16.argtypes = [p, q, q, q, i, i, i, i, i, p, p,
                                            f, p, i, p, i, p, p]
    lib.dmt_bilstm_pregemm_bf16.restype = ctypes.c_int
    # K5c bf16 (tensor cores, a cluster a tile-lane): K1's arguments with
    # the tensor-core packing, no tile
    lib.dmt_bilstm_wavefront_bf16.argtypes = [p, q, q, q, i, i, i, i, i, p,
                                              p, f, p, p]
    lib.dmt_bilstm_wavefront_bf16.restype = ctypes.c_int
    # shape queries: K5b's grid (batch, in_dim, hidden, gate_bf16), the
    # clusters of K5a (in_dim, hidden) and K5c (in_dim, hidden, layers)
    # resident at once
    lib.dmt_bilstm_pregemm_bf16_slots.argtypes = [i, i, i, i, n]
    lib.dmt_bilstm_merged_bf16_clusters.argtypes = [i, i, n]
    lib.dmt_bilstm_wavefront_bf16_clusters.argtypes = [i, i, i, n]
    for fn in (lib.dmt_bilstm_pregemm_bf16_slots,
               lib.dmt_bilstm_merged_bf16_clusters,
               lib.dmt_bilstm_wavefront_bf16_clusters):
        fn.restype = ctypes.c_int
    for name in ("dmt_bilstm_train_fwd_f32", "dmt_bilstm_train_fwd_bf16"):
        fn = getattr(lib, name)
        # K2 (the fp32 core): xin, batch, steps, in_dim, hidden,
        # num_layers, w, bias, forget_bias, hs, cs, the workspace, tile,
        # split, stream
        fn.argtypes = [p, i, i, i, i, i, p, p, f, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    # K2's clusters resident at once (in_dim, hidden, tile, split)
    lib.dmt_bilstm_train_fwd_clusters.argtypes = [i, i, i, i, n]
    lib.dmt_bilstm_train_fwd_clusters.restype = ctypes.c_int
    for name in ("dmt_bilstm_train_bwd_f32", "dmt_bilstm_train_bwd_bf16"):
        fn = getattr(lib, name)
        # xin, hs, cs, dh, w, wht, bias, forget_bias, dx, rows, gates, da,
        # dw, partial, splits, batch, steps, in_dim, hidden, stream
        fn.argtypes = [p, p, p, p, p, p, p, f, p, p, p, p, p, p, i, i, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    # K4 fp32 (the fp32 core): x, s_b, s_t, s_f, reverse_bw, seq_in,
    # batch, in_steps, steps, in_dim, hidden, w, bias, forget_bias,
    # seq_out, out, fw_step, bw_step, tile, split, stream; and its clusters
    # resident at once (in_dim, hidden, tile, split)
    lib.dmt_bilstm_layer_f32.argtypes = [p, q, q, q, i, p, i, i, i, i, i, p,
                                         p, f, p, p, i, i, i, i, p]
    lib.dmt_bilstm_layer_f32.restype = ctypes.c_int
    lib.dmt_bilstm_layer_f32_clusters.argtypes = [i, i, i, i, n]
    lib.dmt_bilstm_layer_f32_clusters.restype = ctypes.c_int
    # K4 bf16 (tensor cores): x, s_b, s_t, s_f, reverse_bw, seq_in, batch,
    # in_steps, steps, in_dim, hidden, w, bias, forget_bias term, seq_out,
    # out, fw_step, bw_step, stream
    lib.dmt_bilstm_layer_bf16.argtypes = [p, q, q, q, i, p, i, i, i, i, i, p,
                                          p, f, p, p, i, i, p]
    lib.dmt_bilstm_layer_bf16.restype = ctypes.c_int
    # K6 (the fp32 core's pieces): xp, the packed W_h, forget_bias, out,
    # batch, timesteps, hidden, reverse, tile, split, stream; and its
    # clusters resident at once (hidden, tile, split)
    lib.dmt_lstm_layer_f32.argtypes = [p, p, f, p, i, i, i, i, i, i, p]
    lib.dmt_lstm_layer_f32.restype = ctypes.c_int
    lib.dmt_lstm_layer_f32_clusters.argtypes = [i, i, i, n]
    lib.dmt_lstm_layer_f32_clusters.restype = ctypes.c_int
    for name in ("dmt_probe_f32", "dmt_probe_bf16"):
        fn = getattr(lib, name)
        # op, x, out, n, iters, stream
        fn.argtypes = [i, p, p, i, i, p]
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (inside ``variant``:
    that build instead)."""
    global _lib
    if _variant is not None:
        return _variant
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
    return _lib


# the library ``variant`` routes the wrappers' launches to, while it runs
_variant: Optional[ctypes.CDLL] = None
_variants = {}
# K1 with its fp32 sigmoids in the tanh form (lstm_common.cuh::cell<false>
# under this define); only tools/probe_sigmoid.py and chip_smoke.py use it
TANH_SIGMOID = "DMT_TANH_SIGMOID"


def variant_library(define: str) -> ctypes.CDLL:
    """K1's source (``bilstm_fused.cu``) built with ``-D<define>`` into its
    own directory, ``build/kernels_<define>/<hash>/``, and bound: K1 in
    both precisions. The default build never sets the define."""
    with _lock:
        if define not in _variants:
            lib = ctypes.CDLL(build(
                [os.path.join(CSRC_DIR, "bilstm_fused.cu")], (define,),
                os.path.join(os.path.dirname(BUILD_DIR),
                             f"kernels_{define.lower()}")))
            _bind_k1(lib)
            _variants[define] = lib
    return _variants[define]


@contextlib.contextmanager
def variant(define: str):
    """Launch K1 from ``variant_library(define)`` inside the block (one
    thread at a time: the route is this module's)."""
    global _variant
    lib = variant_library(define)
    with _variant_lock:
        _variant = lib
        try:
            yield lib
        finally:
            _variant = None


_variant_lock = threading.Lock()


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        name = library().dmt_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({name})")
