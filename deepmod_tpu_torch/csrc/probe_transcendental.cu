// Transcendental-rate probe for Hopper (sm_90a): v <- op(v), K times, in
// a loop inside the kernel.
//
// Replaces the TPU probe scripts/probe_transcendental.py::run (its Pallas
// kernel loops K times over a (512, 512) VMEM block). The point of the
// probe is the same: with the K loop inside one kernel, launch overhead
// drops out as K grows, and the large-K rate is the rate of the op. The
// ops:
//   tanh: tanhf (the accurate libdevice tanh, what the LSTM kernels call);
//   pade: v * (27 + v^2) / (27 + 9 v^2), a rational tanh approximation;
//   mul:  v * 1.0009765625 + 0.125 as one fused multiply-add, the
//         simplest op, to calibrate the other two against.
// pade's multiplies, adds and its divide use the _rn intrinsics, so they
// round like the plain PyTorch version's separate ops (no contraction).
// Storage T is float or bf16; in bf16 mode every step rounds v to bf16,
// as the TPU probe's bf16 loop carry does, and computes in fp32.
//
// One thread per element; `#pragma unroll 1` keeps one op a loop
// iteration, so the loop body in the SASS is one step (chip_smoke.py
// counts its instructions to bound the rate). What bounds it: issue slots
// and, for tanhf, the MUFU (special-function) units; the buffer moves
// once (2 MB in fp32), so bytes never bound it at K >= 256.

#include "lstm_common.cuh"

namespace {

using dmt::from_f;
using dmt::to_f;

enum Op { kTanh = 0, kPade = 1, kMul = 2 };

template <int kOp>
__device__ __forceinline__ float apply(float v) {
  if (kOp == kTanh) return tanhf(v);
  if (kOp == kMul) return __fmaf_rn(v, 1.0009765625f, 0.125f);
  const float v2 = __fmul_rn(v, v);
  return __fdiv_rn(__fmul_rn(v, __fadd_rn(27.0f, v2)),
                   __fadd_rn(27.0f, __fmul_rn(9.0f, v2)));
}

template <typename T, int kOp>
__global__ void probe_kernel(const T* __restrict__ x, T* __restrict__ out,
                             int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = to_f(x[i]);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) v = to_f(from_f<T>(apply<kOp>(v)));
  out[i] = from_f<T>(v);
}

template <typename T>
int launch(int op, const void* x, void* out, int n, int iters,
           void* stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (op) {
    case kTanh:
      probe_kernel<T, kTanh><<<grid, threads, 0, s>>>(xi, o, n, iters);
      break;
    case kPade:
      probe_kernel<T, kPade><<<grid, threads, 0, s>>>(xi, o, n, iters);
      break;
    case kMul:
      probe_kernel<T, kMul><<<grid, threads, 0, s>>>(xi, o, n, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// op: 0 tanh, 1 pade, 2 mul; x and out hold n values of the storage type.
// Returns cudaGetLastError() after the launch (0 = success)
int dmt_probe_f32(int op, const void* x, void* out, int n, int iters,
                  void* stream) {
  return launch<float>(op, x, out, n, iters, stream);
}

int dmt_probe_bf16(int op, const void* x, void* out, int n, int iters,
                   void* stream) {
  return launch<__nv_bfloat16>(op, x, out, n, iters, stream);
}

}  // extern "C"
