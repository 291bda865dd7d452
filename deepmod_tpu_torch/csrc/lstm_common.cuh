// Helpers shared by the inference LSTM kernels (bilstm_mono_merged.cu,
// bilstm_mono_pregemm.cu, bilstm_mono_wavefront.cu: K5a-c, lstm_layer.cu:
// K6); probe_transcendental.cu (P1) uses the storage-type conversions,
// lstm_tc.cuh (the tensor-core pieces of K1, K4 and K5a-c in bf16) the
// conversions and the cell, lstm_f32.cuh (the fp32 core of K1 and K4) the
// cell and kR.
//
// The CUDA-core kernels' thread layout is the same: thread (u, g) of a
// block owns hidden unit u for the kR windows g*kR .. g*kR+kR-1, and
// shared memory holds a block's sequences feature-major, [feature][window],
// so one thread reads its kR windows of a feature as one 16-byte (bf16) or
// 32-byte (fp32) vector.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dmt {

constexpr int kR = 8;  // windows per thread
// at most 128 registers a thread: the 32 gate accumulators, 8 cell states
// and the unrolled loads fit without spilling (K5c, one thread group a
// layer, has its own bound)
constexpr int kMaxThreads = 512;

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

// 8 consecutive values from shared memory (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[kR]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kR]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kR]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
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

// acc[g][r] += sum_k src[k][r] * w[k][g*H + u] over `rows` rows; w points
// at the thread's unit column of a TF (rows, 4H) gate-block kernel
template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ src,
                                           int src_stride,
                                           const T* __restrict__ w, int rows,
                                           int hidden, float (&acc)[4][kR]) {
  const int gate = hidden;
  const int row = 4 * hidden;
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float xv[kR];
    load8(src + static_cast<size_t>(k) * src_stride, xv);
    const T* wk = w + static_cast<size_t>(k) * row;
    const float wi = to_f(__ldg(wk));
    const float wj = to_f(__ldg(wk + gate));
    const float wf = to_f(__ldg(wk + 2 * gate));
    const float wo = to_f(__ldg(wk + 3 * gate));
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[0][r] = fmaf(wi, xv[r], acc[0][r]);
      acc[1][r] = fmaf(wj, xv[r], acc[1][r]);
      acc[2][r] = fmaf(wf, xv[r], acc[2][r]);
      acc[3][r] = fmaf(wo, xv[r], acc[3][r]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][kR]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
}

// the mono kernels (K1, K5a-c): stage a lane's layer-0 inputs for the
// block's tile_b windows from b0 on into xs[step][feature][window], reading
// x through the caller's strides (the bw lane, lane 1, reads step T-1-t);
// windows past the batch read zeros and are never written out
template <typename T>
__device__ __forceinline__ void stage_inputs(
    const T* __restrict__ x, long long stride_b, long long stride_t,
    long long stride_f, long long b0, int batch, int timesteps, int steps,
    int in_dim, int tile_b, int lane, T* __restrict__ xs) {
  const int n_stage = steps * in_dim * tile_b;
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) {
    const int wi = i % tile_b;
    const int f = (i / tile_b) % in_dim;
    const int t = i / (tile_b * in_dim);
    const long long b = b0 + wi;
    const int tt = lane == 0 ? t : timesteps - 1 - t;
    T v = from_f<T>(0.0f);
    if (b < batch) v = x[b * stride_b + tt * stride_t + f * stride_f];
    xs[i] = v;
  }
}

// the mono kernels: the center row of windows b0 .. b0+kR-1 of unit u into
// out (B, 2H) at the lane's half, rounded through the storage type as the
// TPU kernel's output block is; windows past the batch are not written
template <typename T>
__device__ __forceinline__ void store_center(float* __restrict__ out,
                                             const float (&h)[kR],
                                             long long b0, int batch,
                                             int hidden, int lane, int u) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long b = b0 + r;
    if (b < batch) {
      out[b * 2 * hidden + lane * hidden + u] = to_f(from_f<T>(h[r]));
    }
  }
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
