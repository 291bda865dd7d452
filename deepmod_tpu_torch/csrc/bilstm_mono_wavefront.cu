// K1's function under the layer-wavefront schedule (K5c), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_wavefront_kernel (bilstm_fused_center_mono with wavefront=True,
// num_layers <= 3): (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center
// features, odd T, the readout cone, the bw lane reading x time-reversed.
// At wavefront step s, layer L runs step t = s - L, so the num_layers
// chains of a lane are independent within a wavefront step.
//
// Design:
//   grid (ceil(B / tile_b), 2), blockIdx.y the lane. The block holds
//     num_layers thread groups of H * tile_b / 8 threads, one a layer;
//     thread (u, g) of group L owns unit u of layer L for the 8 windows
//     g*8 .. g*8+7, all four gates, its c in registers for the whole run.
//   shared memory: the staged layer-0 inputs xs[step][feature][window] and,
//     for each layer, a 2-row ring of h, ring[L][t % 2][unit][window].
//   wavefront step s: group L, when 0 <= t = s - L < steps, reads its input
//     row (xs row t for layer 0, ring[L-1][t % 2] otherwise) and its own
//     h_{t-1} (ring[L][(t-1) % 2]), runs the cell and writes h_t to
//     ring[L][t % 2]; every group reaches the barrier that ends the step.
//   ONE barrier a wavefront step suffices. During step s the slot
//     ring[L][t % 2] is written by layer L alone, and nobody reads it:
//     layer L reads slot (t-1) % 2, and layer L+1 runs t-1 and reads
//     ring[L][(t-1) % 2]. Its previous content, h_{t-2} of layer L, was last
//     read in step s-1 (by layer L as its h_{t-2}, and by layer L+1 running
//     t-2 as its input), before that step's barrier. Every value a group
//     reads in step s was written in step s-1 (ring[L-1][t % 2] by layer
//     L-1 running t at s-1, ring[L][(t-1) % 2] by layer L itself) or before
//     it (xs), behind at least one barrier. So a lane takes
//     steps + num_layers - 1 barriers, 13 at T=21 with 3 layers, against
//     K1's 2 * steps * num_layers = 66.
//   threads: num_layers * H * tile_b / 8, 300 at H=100, 3 layers, tile 8,
//     600 at tile 16, more than the 512 of the other inference kernels
//     (kMaxThreads). This kernel alone is bounded at kWaveMaxThreads = 600
//     threads, so that tile 16 fits at H=100 with 3 layers. ptxas then
//     caps it at 96 registers a thread (65,536 over 20 warps, rounded to
//     its allocation unit): the bf16 kernel fits, the fp32 kernel spills 12
//     bytes (chip_smoke.py prints both counts). At tile 16 one block fills
//     an SM's registers, as two of K1's do.
//   x is read through the caller's strides (materialized windows or the
//     overlapping window view of a feature block, read in place).
//
// Numerics: K1's contract (lstm_common.cuh's cell). Each layer's chain is
// K1's: the input rows, then the h rows from t=1 on, into the same
// accumulators, on the same stored values, so the result has K1's bits.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1, by
// operations, on the CUDA cores; the serial chain per lane shrinks from
// 33 dependent steps to 13 wavefront steps. Left for later: wgmma, with
// the three layers' products of a wavefront step as independent tiles.

#include "lstm_common.cuh"

namespace {

using dmt::accumulate;
using dmt::from_f;
using dmt::kR;
using dmt::store8;

constexpr int kWaveMaxThreads = 600;

template <typename T, bool kPrescaled>
__global__ void __launch_bounds__(kWaveMaxThreads)
bilstm_wavefront_kernel(const T* __restrict__ x, long long stride_b,
                        long long stride_t, long long stride_f, int batch,
                        int timesteps, int in_dim, int hidden,
                        int num_layers, const T* __restrict__ w,
                        const float* __restrict__ bias, float fb_term,
                        float* __restrict__ out, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  T* xs = reinterpret_cast<T*>(smem_raw);  // [steps][in_dim][tile_b]
  T* ring = xs + static_cast<size_t>(steps) * in_dim * tile_b;
  // ring: [num_layers][2][hidden][tile_b]

  dmt::stage_inputs(x, stride_b, stride_t, stride_f, b0, batch, timesteps,
                    steps, in_dim, tile_b, lane, xs);

  const int group = hidden * (tile_b / kR);  // threads a layer
  const int layer = threadIdx.x / group;
  const int local = threadIdx.x - layer * group;
  const int u = local % hidden;
  const int w0 = (local / hidden) * kR;
  const int lin = layer == 0 ? in_dim : hidden;
  const bool last = layer == num_layers - 1;
  const size_t lane_w =
      static_cast<size_t>(in_dim + hidden) * 4 * hidden +
      static_cast<size_t>(num_layers - 1) * 2 * hidden * 4 * hidden;
  const size_t layer_w =
      layer == 0 ? 0
                 : static_cast<size_t>(in_dim + hidden) * 4 * hidden +
                       static_cast<size_t>(layer - 1) * 2 * hidden * 4 *
                           hidden;
  const T* wl = w + lane * lane_w + layer_w;
  const float* bl =
      bias + (static_cast<size_t>(lane) * num_layers + layer) * 4 * hidden;
  const float bi = bl[u];
  const float bj = bl[hidden + u];
  const float bf = bl[2 * hidden + u];
  const float bo = bl[3 * hidden + u];
  const size_t plane = static_cast<size_t>(hidden) * tile_b;
  T* own = ring + static_cast<size_t>(layer) * 2 * plane;
  const T* below = ring + static_cast<size_t>(layer > 0 ? layer - 1 : 0) * 2 *
                              plane;
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;
  __syncthreads();

  for (int s = 0; s < steps + num_layers - 1; ++s) {
    const int t = s - layer;
    if (t >= 0 && t < steps) {
      const T* in = layer == 0 ? xs + static_cast<size_t>(t) * in_dim * tile_b
                               : below + (t & 1) * plane;
      float acc[4][kR];
      dmt::zero(acc);
      accumulate(in + w0, tile_b, wl + u, lin, hidden, acc);
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        accumulate(own + ((t - 1) & 1) * plane + w0, tile_b,
                   wl + static_cast<size_t>(lin) * 4 * hidden + u, hidden,
                   hidden, acc);
      }
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
        store8(own + (t & 1) * plane + static_cast<size_t>(u) * tile_b + w0,
               h);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kPrescaled>
int launch(const void* x, long long stride_b, long long stride_t,
           long long stride_f, int batch, int timesteps, int in_dim,
           int hidden, int num_layers, const void* w, const float* bias,
           float fb_term, float* out, int tile_b, void* stream) {
  const int steps = timesteps / 2 + 1;
  const size_t smem =
      (static_cast<size_t>(steps) * in_dim + 2 * num_layers * hidden) *
      tile_b * sizeof(T);
  auto kernel = bilstm_wavefront_kernel<T, kPrescaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b, 2);
  const dim3 block(num_layers * hidden * (tile_b / kR));
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), stride_b, stride_t, stride_f, batch,
      timesteps, in_dim, hidden, num_layers, static_cast<const T*>(w), bias,
      fb_term, out, tile_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fp32 mode; returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_wavefront_f32(const void* x, long long stride_b,
                             long long stride_t, long long stride_f,
                             int batch, int timesteps, int in_dim,
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
int dmt_bilstm_wavefront_bf16(const void* x, long long stride_b,
                              long long stride_t, long long stride_f,
                              int batch, int timesteps, int in_dim,
                              int hidden, int num_layers, const void* w,
                              const void* bias, float half_forget_bias,
                              void* out, int tile_b, void* stream) {
  return launch<__nv_bfloat16, true>(
      x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
      num_layers, w, static_cast<const float*>(bias), half_forget_bias,
      static_cast<float*>(out), tile_b, stream);
}

}  // extern "C"
