// Helpers shared by the LSTM kernels: the fp32 sequence's and bf16's
// conversions (to_f, from_f: the tensor-core pieces of K1, K4 and K5a-c in
// lstm_tc.cuh, P1's probe_transcendental.cu), the TF1 cell (lstm_tc.cuh,
// and the fp32 core lstm_f32.cuh of K1, K2, K4, K5a-c and K6), kR, and
// K5b's bf16 gate stores (store8, zero: bilstm_mono_pregemm.cu).
//
// Thread layout of the CUDA-core kernels (the fp32 core): thread (u, g) of
// a CTA owns hidden unit u for the kR windows g*kR .. g*kR+kR-1, and
// shared memory holds a CTA's operands feature-major, [feature][window],
// so one thread reads its kR windows of a feature as one 32-byte vector.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dmt {

constexpr int kR = 8;  // windows per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 values rounded to bf16 (RNE) at p, 16-byte aligned
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kR]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void zero(float (&acc)[4][kR]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
}

// the TF1 BasicLSTMCell tail on fp32 gate pre-activations (bias added):
// updates c, returns h. kPrescaled is the bf16 contract (i/f/o arrive
// pre-halved, sigmoid as 0.5*tanh+0.5, fb_term = 0.5*forget_bias added in
// the original association); otherwise exp-based sigmoids, fb_term =
// forget_bias. DMT_TANH_SIGMOID (never set by the default build; the
// variant that tools/probe_sigmoid.py times) computes those as
// 0.5*tanh(0.5*x)+0.5 instead
template <bool kPrescaled>
__device__ __forceinline__ float cell(float gi, float gj, float gf, float go,
                                      float fb_term, float& c) {
  float si, sf, so;
  if (kPrescaled) {
    si = 0.5f * tanhf(gi) + 0.5f;
    sf = 0.5f * tanhf(gf + fb_term) + 0.5f;
    so = 0.5f * tanhf(go) + 0.5f;
  } else {
#ifdef DMT_TANH_SIGMOID
    si = 0.5f * tanhf(0.5f * gi) + 0.5f;
    sf = 0.5f * tanhf(0.5f * (gf + fb_term)) + 0.5f;
    so = 0.5f * tanhf(0.5f * go) + 0.5f;
#else
    si = 1.0f / (1.0f + expf(-gi));
    sf = 1.0f / (1.0f + expf(-(gf + fb_term)));
    so = 1.0f / (1.0f + expf(-go));
#endif
  }
  c = c * sf + si * tanhf(gj);
  return tanhf(c) * so;
}

}  // namespace dmt
