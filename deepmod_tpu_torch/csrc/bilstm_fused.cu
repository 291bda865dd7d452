// Whole-stack BiLSTM center features for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// bilstm_fused_center_mono (Pallas body _mono_kernel, with _make_cell,
// _cell_tail and _prescale_ifo). It computes the same function, not the
// same schedule: (B, T, F) windows -> (B, 2H) fp32 [fw; bw] hidden states
// at the center step, for odd T, where every layer of each lane stops at
// step T//2 (the readout cone: the fw and bw stacks never exchange state
// before the final concat, so the center readout depends only on steps
// 0..T//2 of each lane at every depth). The bw lane reads x time-reversed.
//
// Design (simple first, fast later):
//   grid (ceil(B / tile_b), 2): blockIdx.y is the lane, and one block runs
//     all layers of that lane for tile_b windows, T//2+1 steps per layer.
//   threads: hidden * tile_b / 8. Thread (u, g) owns hidden unit u for the
//     8 windows g*8 .. g*8+7. It computes all four gates i, j, f, o of its
//     unit as dot products over [x_t; h_{t-1}], reading the layer kernel
//     in TF's (in+H, 4H) gate-block layout, so the cell update stays in
//     the thread and the cell state c stays in registers.
//   shared memory: ONE sequence buffer seq[step][unit][window] holds the
//     previous layer's outputs. Layer L at step t reads row t (layer L-1's
//     h_t) and row t-1 (its own h_{t-1}, already written back), and only
//     after a barrier overwrites row t with its h_t, so the single buffer
//     replaces the TPU kernel's four ping-pong buffers. The layer-0 inputs
//     for the block's windows are staged once into xs[step][feature][window].
//   weights are read from global memory and stay in L2 (about 0.8 MB in
//     bf16 for all six layer-lanes at H=100, F=7).
//   x is read through explicit strides, so the same kernel serves
//     materialized windows (stride_b = T*F) and the overlapping window view
//     of a (rows, F) feature block (stride_b = F): the window build of the
//     compact transfer path is folded into these loads.
//
// Numerics follow the TPU kernel's contract:
//   fp32: sigmoid = 1/(1+expf(-x)), forget_bias added inside the f sigmoid,
//     fp32 weights and sequences.
//   bf16: bf16 x, weights and stored sequences (so h is rounded to bf16
//     before the h-product), fp32 accumulation and fp32 c; sigmoid as
//     0.5*tanhf(x)+0.5 on i/f/o columns that the wrapper pre-halved, and
//     the f gate adds 0.5*forget_bias in the original association. The
//     center row leaves the kernel rounded to bf16, as the TPU kernel's
//     bf16 output block does.
//   Accurate expf/tanhf (no fast-math).
//
// What bounds it on an H100: per window it does 8.92 MFLOP at H=100, F=7,
// T=21 (per lane per step 2*107*400 for layer 0 plus 2*(2*200*400) for
// layers 1-2, times 11 steps times 2 lanes) and moves only 7-294 bytes of
// input plus 800 bytes of output, so it is bound by operations, and 33
// serial dependent steps per lane are its latency floor. This version runs
// the products as fp32 FMAs on the CUDA cores in both precisions. Left for
// later: wgmma on the tensor cores (a 64-window tile is one wgmma M), the
// weights in shared memory, and a TMA ring for the inputs.

#include "lstm_common.cuh"

namespace {

using dmt::accumulate;
using dmt::from_f;
using dmt::kMaxThreads;
using dmt::kR;
using dmt::store8;
using dmt::to_f;

template <typename T, bool kPrescaled>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_center_mono_kernel(const T* __restrict__ x, long long stride_b,
                          long long stride_t, long long stride_f, int batch,
                          int timesteps, int in_dim, int hidden,
                          int num_layers, const T* __restrict__ w,
                          const float* __restrict__ bias, float fb_term,
                          float* __restrict__ out, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  T* seq = reinterpret_cast<T*>(smem_raw);  // [steps][hidden][tile_b]
  T* xs = seq + static_cast<size_t>(steps) * hidden * tile_b;
  // xs: [steps][in_dim][tile_b]

  // stage this lane's layer-0 inputs (bw reads step T-1-t); windows past
  // the batch read zeros and are never written out
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

  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const size_t lane_w =
      static_cast<size_t>(in_dim + hidden) * 4 * hidden +
      static_cast<size_t>(num_layers - 1) * 2 * hidden * 4 * hidden;
  const T* wl = w + lane * lane_w;
  const float* bl = bias + static_cast<size_t>(lane) * num_layers * 4 * hidden;
  __syncthreads();

  for (int layer = 0; layer < num_layers; ++layer) {
    const int lin = layer == 0 ? in_dim : hidden;
    const T* src = layer == 0 ? xs : seq;
    const bool last = layer == num_layers - 1;
    const float bi = bl[u];
    const float bj = bl[hidden + u];
    const float bf = bl[2 * hidden + u];
    const float bo = bl[3 * hidden + u];
    float c[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) c[r] = 0.0f;

    for (int t = 0; t < steps; ++t) {
      float acc[4][kR];
      dmt::zero(acc);
      accumulate(src + static_cast<size_t>(t) * lin * tile_b + w0, tile_b,
                 wl + u, lin, hidden, acc);
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        accumulate(seq + static_cast<size_t>(t - 1) * hidden * tile_b + w0,
                   tile_b, wl + static_cast<size_t>(lin) * 4 * hidden + u,
                   hidden, hidden, acc);
      }
      // every thread has read row t (and row t-1) before row t is rewritten
      __syncthreads();
      float h[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        h[r] = dmt::cell<kPrescaled>(acc[0][r] + bi, acc[1][r] + bj,
                                     acc[2][r] + bf, acc[3][r] + bo, fb_term,
                                     c[r]);
      }
      if (last && t == steps - 1) {
        // only the center row leaves the kernel
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const long long b = b0 + w0 + r;
          if (b < batch) {
            out[b * 2 * hidden + lane * hidden + u] =
                to_f(from_f<T>(h[r]));
          }
        }
      } else {
        store8(seq + (static_cast<size_t>(t) * hidden + u) * tile_b + w0, h);
      }
      __syncthreads();
    }
    wl += static_cast<size_t>(lin + hidden) * 4 * hidden;
    bl += 4 * hidden;
  }
}

template <typename T, bool kPrescaled>
int launch(const void* x, long long stride_b, long long stride_t,
           long long stride_f, int batch, int timesteps, int in_dim,
           int hidden, int num_layers, const void* w, const float* bias,
           float fb_term, float* out, int tile_b, void* stream) {
  const int steps = timesteps / 2 + 1;
  const size_t smem =
      static_cast<size_t>(steps) * (hidden + in_dim) * tile_b * sizeof(T);
  auto kernel = bilstm_center_mono_kernel<T, kPrescaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b, 2);
  const dim3 block(hidden * (tile_b / kR));
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), stride_b, stride_t, stride_f, batch,
      timesteps, in_dim, hidden, num_layers, static_cast<const T*>(w), bias,
      fb_term, out, tile_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 mode; returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_center_f32(const void* x, int stride_b, int stride_t,
                          int stride_f, int batch, int timesteps, int in_dim,
                          int hidden, int num_layers, const void* w,
                          const void* bias, float forget_bias, void* out,
                          int tile_b, void* stream) {
  return launch<float, false>(x, stride_b, stride_t, stride_f, batch,
                              timesteps, in_dim, hidden, num_layers, w,
                              static_cast<const float*>(bias), forget_bias,
                              static_cast<float*>(out), tile_b, stream);
}

// bf16 mode: x and w are bf16, i/f/o columns of w and bias pre-halved;
// half_forget_bias is 0.5 * forget_bias
int dmt_bilstm_center_bf16(const void* x, int stride_b, int stride_t,
                           int stride_f, int batch, int timesteps, int in_dim,
                           int hidden, int num_layers, const void* w,
                           const void* bias, float half_forget_bias,
                           void* out, int tile_b, void* stream) {
  return launch<__nv_bfloat16, true>(
      x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
      num_layers, w, static_cast<const float*>(bias), half_forget_bias,
      static_cast<float*>(out), tile_b, stream);
}

}  // extern "C"
