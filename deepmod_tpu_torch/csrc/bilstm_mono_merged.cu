// K1's function under the merged-GEMM schedule (K5a), for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_merged_kernel (bilstm_fused_center_mono with merged_gemm=True):
// (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center features, odd T, every
// layer of each lane stopping at step T//2 (the readout cone), the bw lane
// reading x time-reversed. The TPU kernel issues ONE [x_t; h] @ [Wx; Wh]
// product a step instead of two; here each step assembles the operand
// [x_t; h_{t-1}] in shared memory and each thread runs ONE dot product over
// its lin+H rows against its unit's column of the layer's whole TF
// (lin+H, 4H) kernel, which is already [Wx; Wh] stacked, so the wrapper
// packs nothing of its own.
//
// Design (K1's, csrc/bilstm_fused.cu, plus the operand buffer):
//   grid (ceil(B / tile_b), 2), blockIdx.y the lane; thread (u, g) owns
//     unit u for the 8 windows g*8 .. g*8+7, all four gates, c in
//     registers.
//   shared memory: seq[step][unit][window] (the previous layer's outputs,
//     row t overwritten with this layer's h_t), xs[step][feature][window]
//     (the staged layer-0 inputs) and xh[row][window], rows 0..lin-1 the
//     step's input and rows lin..lin+H-1 h_{t-1} (zeros at t=0).
//   a step: assemble xh, barrier, one accumulate over lin+H rows, the cell,
//     write h_t to seq row t (every read of row t went through xh before the
//     barrier), barrier. Two barriers a step, as K1.
//   x is read through the caller's strides (materialized windows or the
//     overlapping window view of a feature block, read in place).
//
// Numerics: K1's contract (lstm_common.cuh's cell; fp32 exp sigmoids; bf16
// storage with pre-halved i/f/o columns and tanh sigmoids). The FMA chain is
// K1's: the x rows, then the h rows, into the same accumulators (at t=0 the
// h rows are zeros and add exact zeros), so the result has K1's bits.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1 (operations,
// not bytes), on the CUDA cores, with 33 dependent steps a lane. The copy
// into xh adds (lin+H)*tile_b element moves a step and the buffer adds
// (max(F,H)+H)*tile_b elements to K1's shared memory: 19.2 KB at tile 24
// fp32 on top of 113 KB, so only one such block fits an SM; the default
// tile comes from chip_smoke.py's sweep. Left for later: wgmma over the
// merged operand, which is the form a tensor-core product wants.

#include "lstm_common.cuh"

namespace {

using dmt::accumulate;
using dmt::from_f;
using dmt::kMaxThreads;
using dmt::kR;
using dmt::store8;

template <typename T, bool kPrescaled>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_merged_kernel(const T* __restrict__ x, long long stride_b,
                     long long stride_t, long long stride_f, int batch,
                     int timesteps, int in_dim, int hidden, int num_layers,
                     const T* __restrict__ w, const float* __restrict__ bias,
                     float fb_term, float* __restrict__ out, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  T* seq = reinterpret_cast<T*>(smem_raw);  // [steps][hidden][tile_b]
  T* xs = seq + static_cast<size_t>(steps) * hidden * tile_b;
  // xs: [steps][in_dim][tile_b]; xh: [lin + hidden][tile_b]
  T* xh = xs + static_cast<size_t>(steps) * in_dim * tile_b;

  dmt::stage_inputs(x, stride_b, stride_t, stride_f, b0, batch, timesteps,
                    steps, in_dim, tile_b, lane, xs);

  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const size_t lane_w =
      static_cast<size_t>(in_dim + hidden) * 4 * hidden +
      static_cast<size_t>(num_layers - 1) * 2 * hidden * 4 * hidden;
  const T* wl = w + lane * lane_w;
  const float* bl = bias + static_cast<size_t>(lane) * num_layers * 4 * hidden;
  const int n_h = hidden * tile_b;
  __syncthreads();

  for (int layer = 0; layer < num_layers; ++layer) {
    const int lin = layer == 0 ? in_dim : hidden;
    const T* src = layer == 0 ? xs : seq;
    const bool last = layer == num_layers - 1;
    const int n_x = lin * tile_b;
    const float bi = bl[u];
    const float bj = bl[hidden + u];
    const float bf = bl[2 * hidden + u];
    const float bo = bl[3 * hidden + u];
    float c[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) c[r] = 0.0f;

    for (int t = 0; t < steps; ++t) {
      // [x_t; h_{t-1}]: the input's row t, then this layer's own row t-1
      // (the staging loop, or the previous step's stores, ended in a barrier)
      const T* x_row = src + static_cast<size_t>(t) * n_x;
      for (int i = threadIdx.x; i < n_x + n_h; i += blockDim.x) {
        T v = from_f<T>(0.0f);
        if (i < n_x) {
          v = x_row[i];
        } else if (t > 0) {
          v = seq[static_cast<size_t>(t - 1) * n_h + (i - n_x)];
        }
        xh[i] = v;
      }
      __syncthreads();
      float acc[4][kR];
      dmt::zero(acc);
      accumulate(xh + w0, tile_b, wl + u, lin + hidden, hidden, acc);
      float h[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        h[r] = dmt::cell<kPrescaled>(acc[0][r] + bi, acc[1][r] + bj,
                                     acc[2][r] + bf, acc[3][r] + bo, fb_term,
                                     c[r]);
      }
      if (last && t == steps - 1) {
        // only the center row leaves the kernel
        dmt::store_center<T>(out, h, b0 + w0, batch, hidden, lane, u);
      } else {
        store8(seq + (static_cast<size_t>(t) * hidden + u) * tile_b + w0, h);
      }
      // row t written and every thread done with xh before the next copy
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
  const int max_in = in_dim > hidden ? in_dim : hidden;
  const size_t smem =
      (static_cast<size_t>(steps) * (hidden + in_dim) + max_in + hidden) *
      tile_b * sizeof(T);
  auto kernel = bilstm_merged_kernel<T, kPrescaled>;
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

// fp32 mode; returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_merged_f32(const void* x, long long stride_b,
                          long long stride_t, long long stride_f, int batch,
                          int timesteps, int in_dim, int hidden,
                          int num_layers, const void* w, const void* bias,
                          float forget_bias, void* out, int tile_b,
                          void* stream) {
  return launch<float, false>(x, stride_b, stride_t, stride_f, batch,
                              timesteps, in_dim, hidden, num_layers, w,
                              static_cast<const float*>(bias), forget_bias,
                              static_cast<float*>(out), tile_b, stream);
}

// bf16 mode: x and w are bf16, i/f/o columns of w and bias pre-halved;
// half_forget_bias is 0.5 * forget_bias
int dmt_bilstm_merged_bf16(const void* x, long long stride_b,
                           long long stride_t, long long stride_f, int batch,
                           int timesteps, int in_dim, int hidden,
                           int num_layers, const void* w, const void* bias,
                           float half_forget_bias, void* out, int tile_b,
                           void* stream) {
  return launch<__nv_bfloat16, true>(
      x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
      num_layers, w, static_cast<const float*>(bias), half_forget_bias,
      static_cast<float*>(out), tile_b, stream);
}

}  // extern "C"
