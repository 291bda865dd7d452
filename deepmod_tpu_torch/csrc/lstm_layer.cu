// One LSTM layer, one direction, for Hopper (sm_90a): the recurrence over
// precomputed gate pre-activations.
//
// Replaces the TPU kernel deepmod_tpu/ops/lstm_pallas.py::
// lstm_layer_pallas (Pallas body _lstm_kernel), the per-layer path of the
// model's one-direction stacks (models/bilstm.py::_stack_direction with
// the kernel flag). The input projection x @ W_x + b stays outside the
// kernel, as in the TPU package; the kernel runs
//   gates_t = xp_t + h_{t-1} @ W_h   (TF i, j, f, o order)
//   c_t = c_{t-1} * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
//   h_t = tanh(c_t) * sigmoid(o)
// over t = 0..T-1, or T-1..0 with `reverse`, storing each h_t at its own
// index t. fp32 throughout (exp sigmoids, accurate expf/tanhf).
//
// Design: grid ceil(B / tile_b) blocks of hidden * tile_b / 8 threads;
// thread (u, g) owns unit u for 8 windows, keeps c in registers and reads
// its four gate pre-activations of xp_t from global memory (coalesced
// across u). h_{t-1} lives in shared memory [H][tile_b]; W_h is read from
// global memory and stays in L2. Two barriers a step.
//
// What bounds it on an H100: per window and step 2*H*4H FLOP of h-product
// (T=21, H=100: 1.68 MFLOP a window) against 4H+H fp32 values moved (42 KB
// a window), so operations (67 TFLOP/s fp32) bound it at about twice the
// time the bytes need (3.35 TB/s), and the T dependent steps are its
// latency floor. Left for later: tensor-core h-products and the
// projection fused in.

#include "lstm_common.cuh"

namespace {

using dmt::accumulate;
using dmt::kMaxThreads;
using dmt::kR;
using dmt::store8;

__global__ void __launch_bounds__(kMaxThreads)
lstm_layer_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                  float forget_bias, float* __restrict__ out, int batch,
                  int timesteps, int hidden, int reverse, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [hidden][tile_b]
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const int gates = 4 * hidden;
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;

  for (int step = 0; step < timesteps; ++step) {
    const int t = reverse ? timesteps - 1 - step : step;
    float acc[4][kR];
    dmt::zero(acc);
    if (step > 0) {  // h_{-1} = 0 contributes nothing
      accumulate(hs + w0, tile_b, wh + u, hidden, hidden, acc);
    }
    // every thread has read h_{t-1} before it is rewritten
    __syncthreads();
    float h[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long b = b0 + w0 + r;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < batch) {
        const float* xr = xp + (b * timesteps + t) * gates + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = xr[g * hidden];
      }
      h[r] = dmt::cell<false>(x[0] + acc[0][r], x[1] + acc[1][r],
                              x[2] + acc[2][r], x[3] + acc[3][r],
                              forget_bias, c[r]);
      if (b < batch) out[(b * timesteps + t) * hidden + u] = h[r];
    }
    store8(hs + static_cast<size_t>(u) * tile_b + w0, h);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// xp (B, T, 4H) fp32 gate pre-activations (bias included), wh (H, 4H)
// fp32, out (B, T, H) fp32. Returns cudaGetLastError() after the launch
// (0 = success)
int dmt_lstm_layer_f32(const void* xp, const void* wh, float forget_bias,
                       void* out, int batch, int timesteps, int hidden,
                       int reverse, int tile_b, void* stream) {
  const size_t smem = static_cast<size_t>(hidden) * tile_b * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b);
  const dim3 block(hidden * (tile_b / kR));
  lstm_layer_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(wh),
      forget_bias, static_cast<float*>(out), batch, timesteps, hidden,
      reverse, tile_b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
