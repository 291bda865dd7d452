// K1's function under the pre-projected-gates schedule (K5b), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_pregemm_kernel (bilstm_fused_center_mono with pregemm=True and
// gate_store): (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center features,
// odd T, the readout cone, the bw lane reading x time-reversed. For each
// layer and lane the TPU kernel first projects every step's input into a
// gate buffer (no bias), in gate_store's dtype; the recurrence then adds
// h_{t-1} @ Wh and the bias to the stored row. This kernel does the same in
// two phases a layer.
//
// Design (K1's thread layout, csrc/bilstm_fused.cu):
//   grid (ceil(B / tile_b), 2), blockIdx.y the lane; thread (u, g) owns
//     unit u for the 8 windows g*8 .. g*8+7, all four gates, c in
//     registers. Shared memory as K1: seq[step][unit][window] and the
//     staged layer-0 inputs xs[step][feature][window].
//   phase 1: for every step t the thread projects the layer's input row t
//     onto its unit's four x columns and stores the sums to the gate
//     workspace gx[t][gate*H + u][window]. One barrier ends the phase (the
//     recurrence overwrites the seq rows the projection read).
//   phase 2: each step loads its gx row, adds the h rows and the bias, runs
//     the cell and writes h_t to seq row t. A step reads only row t-1, so
//     ONE barrier a step suffices (K1 needs two).
//   the workspace does not fit in shared memory (one lane at tile 24 needs
//     11*400*24*4 = 422,400 B in fp32), so it lives in device memory,
//     allocated by the wrapper and reused by every layer: a region
//     [block][lane][steps][4H][tile_b] in which each thread reads back
//     exactly the (gate, unit, 8 windows) slices it wrote itself, so the two
//     phases need no barrier or fence between them.
//   x is read through the caller's strides (materialized windows or the
//     overlapping window view of a feature block, read in place).
//
// Numerics: K1's contract (lstm_common.cuh's cell). With fp32 gates the FMA
// chain is K1's (the x-row sum stored in fp32, reloaded, then the h rows),
// so the result has K1's bits; with bf16 gates the stored sum is rounded to
// nearest even (__float2bfloat16_rn), in either precision, as the TPU
// kernel's bf16 gate buffer is.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1, by
// operations. The design adds device-memory traffic that is not part of
// the function: each layer writes and reads back steps*4H gate values a
// window and lane, 2*11*400*4 B = 35.2 KB a window per layer in fp32 (17.6
// KB with bf16 gates), 9.2 GB of workspace at 262,144 windows. Left for
// later: the projection as a tensor-core product and a workspace that stays
// in L2 or shared memory at a smaller tile.

#include "lstm_common.cuh"

namespace {

using dmt::accumulate;
using dmt::from_f;
using dmt::kMaxThreads;
using dmt::kR;
using dmt::load8;
using dmt::store8;

template <typename T, typename G, bool kPrescaled>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_pregemm_kernel(const T* __restrict__ x, long long stride_b,
                      long long stride_t, long long stride_f, int batch,
                      int timesteps, int in_dim, int hidden, int num_layers,
                      const T* __restrict__ w, const float* __restrict__ bias,
                      float fb_term, G* gx_all, float* __restrict__ out,
                      int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  T* seq = reinterpret_cast<T*>(smem_raw);  // [steps][hidden][tile_b]
  T* xs = seq + static_cast<size_t>(steps) * hidden * tile_b;
  // xs: [steps][in_dim][tile_b]

  dmt::stage_inputs(x, stride_b, stride_t, stride_f, b0, batch, timesteps,
                    steps, in_dim, tile_b, lane, xs);

  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const size_t lane_w =
      static_cast<size_t>(in_dim + hidden) * 4 * hidden +
      static_cast<size_t>(num_layers - 1) * 2 * hidden * 4 * hidden;
  const T* wl = w + lane * lane_w;
  const float* bl = bias + static_cast<size_t>(lane) * num_layers * 4 * hidden;
  // this block and lane's workspace, [steps][4 * hidden][tile_b]
  const size_t gx_row = static_cast<size_t>(4) * hidden * tile_b;
  G* gx = gx_all + (static_cast<size_t>(blockIdx.x) * 2 + lane) * steps *
                       gx_row;
  __syncthreads();

  for (int layer = 0; layer < num_layers; ++layer) {
    const int lin = layer == 0 ? in_dim : hidden;
    const T* src = layer == 0 ? xs : seq;
    const bool last = layer == num_layers - 1;

    // phase 1: the input projection of every step, without the bias
    for (int t = 0; t < steps; ++t) {
      float acc[4][kR];
      dmt::zero(acc);
      accumulate(src + static_cast<size_t>(t) * lin * tile_b + w0, tile_b,
                 wl + u, lin, hidden, acc);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        store8(gx + t * gx_row + (static_cast<size_t>(g) * hidden + u) *
                                     tile_b + w0,
               acc[g]);
      }
    }
    // every thread has read the layer's input rows before row 0 is rewritten
    __syncthreads();

    const float bi = bl[u];
    const float bj = bl[hidden + u];
    const float bf = bl[2 * hidden + u];
    const float bo = bl[3 * hidden + u];
    float c[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) c[r] = 0.0f;

    // phase 2: the recurrence, starting each step from its stored row
    for (int t = 0; t < steps; ++t) {
      float acc[4][kR];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        load8(gx + t * gx_row + (static_cast<size_t>(g) * hidden + u) *
                                    tile_b + w0,
              acc[g]);
      }
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        accumulate(seq + static_cast<size_t>(t - 1) * hidden * tile_b + w0,
                   tile_b, wl + static_cast<size_t>(lin) * 4 * hidden + u,
                   hidden, hidden, acc);
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
        // nobody reads row t during step t: it held the layer's input,
        // already projected
        store8(seq + (static_cast<size_t>(t) * hidden + u) * tile_b + w0, h);
      }
      __syncthreads();
    }
    wl += static_cast<size_t>(lin + hidden) * 4 * hidden;
    bl += 4 * hidden;
  }
}

template <typename T, typename G, bool kPrescaled>
int launch(const void* x, long long stride_b, long long stride_t,
           long long stride_f, int batch, int timesteps, int in_dim,
           int hidden, int num_layers, const void* w, const float* bias,
           float fb_term, void* gx, float* out, int tile_b, void* stream) {
  const int steps = timesteps / 2 + 1;
  const size_t smem =
      static_cast<size_t>(steps) * (hidden + in_dim) * tile_b * sizeof(T);
  auto kernel = bilstm_pregemm_kernel<T, G, kPrescaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b, 2);
  const dim3 block(hidden * (tile_b / kR));
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), stride_b, stride_t, stride_f, batch,
      timesteps, in_dim, hidden, num_layers, static_cast<const T*>(w), bias,
      fb_term, static_cast<G*>(gx), out, tile_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fp32 mode. gx: the wrapper's workspace of ceil(batch / tile_b) * tile_b
// * 2 * (timesteps/2+1) * 4 * hidden gate values, fp32, or bf16 when
// gate_bf16 is set. Returns cudaGetLastError() after the launch.
int dmt_bilstm_pregemm_f32(const void* x, long long stride_b,
                           long long stride_t, long long stride_f, int batch,
                           int timesteps, int in_dim, int hidden,
                           int num_layers, const void* w, const void* bias,
                           float forget_bias, void* gx, int gate_bf16,
                           void* out, int tile_b, void* stream) {
  auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (gate_bf16) {
    return launch<float, __nv_bfloat16, false>(
        x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, w, b, forget_bias, gx, o, tile_b, stream);
  }
  return launch<float, float, false>(
      x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
      num_layers, w, b, forget_bias, gx, o, tile_b, stream);
}

// bf16 mode: x and w are bf16, i/f/o columns of w and bias pre-halved;
// half_forget_bias is 0.5 * forget_bias; gx as above
int dmt_bilstm_pregemm_bf16(const void* x, long long stride_b,
                            long long stride_t, long long stride_f,
                            int batch, int timesteps, int in_dim, int hidden,
                            int num_layers, const void* w, const void* bias,
                            float half_forget_bias, void* gx, int gate_bf16,
                            void* out, int tile_b, void* stream) {
  auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (gate_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16, true>(
        x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, w, b, half_forget_bias, gx, o, tile_b, stream);
  }
  return launch<__nv_bfloat16, float, true>(
      x, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
      num_layers, w, b, half_forget_bias, gx, o, tile_b, stream);
}

}  // extern "C"
