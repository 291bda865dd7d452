// K1's function under the merged-GEMM schedule (K5a), for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_merged_kernel (bilstm_fused_center_mono with merged_gemm=True):
// (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center features, odd T, every
// layer of each lane stopping at step T//2 (the readout cone), the bw lane
// reading x time-reversed. The TPU kernel issues ONE [x_t; h] @ [Wx; Wh]
// product a step instead of two. Two modes:
//
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh): grid (ceil(B/64), 2),
//   256 threads; each layer of the lane runs lstm_tc.cuh::run_layer, one
//   [h_{t-1}; x_t] @ [Wh; Wx] wgmma chain a step with the layer's padded,
//   gate-permuted weights in shared memory (ops/bilstm_fused.py packs
//   them, [layer][lane]). The layer loop and the readout cone (T//2+1
//   steps) stay inside the block; layer 0 reads x through the caller's
//   strides; the inter-layer sequence (11 x 64 x 104 x 2 B = 146 KB at
//   T=21, H=100) does not fit beside the weights, so it lives in a
//   device-memory workspace from the wrapper, one blocked row a step,
//   overwritten in place by the next layer: its step t+1 writes row t,
//   which the prefetch of step t-1 read. 132 resident blocks x 146 KB stay
//   in the 50 MB L2. Hidden 105-128 (Hp 112-128): a 2-CTA cluster a
//   tile-lane, each CTA 128 threads over its half of the units
//   (lstm_tc.cuh, the split), the pair sharing the workspace rows.
//
// fp32: each step assembles the operand [x_t; h_{t-1}] in shared memory
// and each thread runs ONE dot product over its lin+H rows against its
// unit's column of the layer's whole TF (lin+H, 4H) kernel, which is
// already [Wx; Wh] stacked, so the wrapper packs nothing of its own.
//
// fp32 design (K1's, csrc/bilstm_fused.cu, plus the operand buffer):
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
// storage with pre-halved i/f/o columns and tanh sigmoids). In fp32 the FMA
// chain is K1's: the x rows, then the h rows, into the same accumulators
// (at t=0 the h rows are zeros and add exact zeros), so the result has K1's
// bits. In bf16 the tensor cores sum in another order: K1's result within
// the bf16 tolerance, not its bits.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1 (operations,
// not bytes), with 33 dependent steps a lane. fp32: on the CUDA cores; the
// copy into xh adds (lin+H)*tile_b element moves a step and the buffer
// adds (max(F,H)+H)*tile_b elements to K1's shared memory: 19.2 KB at tile
// 24 on top of 113 KB, so only one such block fits an SM; the default tile
// comes from chip_smoke.py's sweep. bf16: lstm_tc.cuh's note (the cell's
// tanhf before the tensor cores).

#include "lstm_tc.cuh"

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

// the bf16 tensor-core kernel: one lane of one 64-window tile, every layer
// (Hp > 104: this CTA's half of the units, a 2-CTA cluster a tile-lane)
template <int kHp>
__global__ void __launch_bounds__(
    dmt::tc::threads_of(dmt::tc::split_of(kHp)), 1)
bilstm_merged_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        long long stride_b, long long stride_t,
                        long long stride_f, int batch, int timesteps,
                        int in_dim, int hidden, int num_layers, int nx_max,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, float fb_term,
                        __nv_bfloat16* __restrict__ ws,
                        float* __restrict__ out) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tile = blockIdx.x / kSplit;
  const size_t w_max =
      tc::weight_bytes(kHp, in_dim > hidden ? in_dim : hidden) / kSplit;
  const tc::Smem sm = tc::carve(tc_smem, kHp, nx_max, w_max);
  // this tile's rows of the workspace: (tiles, 2, steps, 64 * Hp)
  const long long row = static_cast<long long>(tc::kRows) * kHp;
  __nv_bfloat16* rows =
      ws + (static_cast<long long>(tile) * 2 + lane) * steps * row;

  tc::Layer L;
  L.w = w;
  L.bias = bias;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.b0 = static_cast<long long>(tile) * tc::kRows;
  L.fb = fb_term;
  for (int layer = 0; layer < num_layers; ++layer) {
    L.in_dim = layer == 0 ? in_dim : hidden;
    const long long lane_w = tc::weight_bytes(kHp, L.in_dim) / 2;
    const bool last = layer == num_layers - 1;
    tc::LayerIO io;
    io.x = layer == 0 ? x : nullptr;
    io.sb = stride_b;
    io.st = stride_t;
    io.sf = stride_f;
    io.reversed = lane == 1;
    io.in_steps = timesteps;
    io.seq_in = rows;
    io.seq_in_t = row;
    io.seq_out = last ? nullptr : rows;
    io.seq_out_t = row;
    io.out = last ? out : nullptr;
    io.out_step = steps - 1;
    tc::Layer here = L;
    here.w += lane * lane_w;
    here.bias += lane * kHp * 4;
    tc::run_layer<kHp, kSplit>(sm, here, io);
    L.w += 2 * lane_w;  // [layer][lane]
    L.bias += 2 * kHp * 4;
  }
}

template <int kHp>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* ws, void* out, void* stream) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  const int widest = in_dim > hidden ? in_dim : hidden;
  const int nx_max = tc::x_cols(widest);
  const size_t smem =
      tc::smem_bytes(kHp, nx_max, tc::weight_bytes(kHp, widest) / kSplit);
  auto kernel = bilstm_merged_tc_kernel<kHp>;
  const dim3 grid((batch + tc::kRows - 1) / tc::kRows * kSplit, 2);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const float*>(bias);
  auto* wsb = static_cast<__nv_bfloat16*>(ws);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(tc::launch_cluster(
        kernel, grid, tc::threads_of(kSplit), smem, st, kSplit, xb,
        stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, nx_max, wb, bb, fb_term, wsb, o));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, tc::kThreads, smem, st>>>(
        xb, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, nx_max, wb, bb, fb_term, wsb, o);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int kHp>
int clusters_tc(int in_dim, int hidden, int* clusters) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  const int widest = in_dim > hidden ? in_dim : hidden;
  return static_cast<int>(tc::cluster_occupancy(
      bilstm_merged_tc_kernel<kHp>, tc::threads_of(kSplit),
      tc::smem_bytes(kHp, tc::x_cols(widest),
                     tc::weight_bytes(kHp, widest) / kSplit),
      kSplit, clusters));
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

// bf16 mode, the tensor-core kernel, 64 windows a block: x is bf16; w and
// bias are the tensor-core packing of ops/bilstm_fused.py (per [layer][lane]
// the padded, gate-permuted (Kp, 4Hp) bf16 weights in core columns and the
// (Hp, 4) fp32 bias, i/f/o pre-halved); ws is a bf16 workspace of
// ceil(B/64) * 2 * (T//2+1) * 64 * Hp elements; half_forget_bias is 0.5 *
// forget_bias. Hp = hidden rounded up to 8, at most 128 (else
// cudaErrorInvalidValue); Hp 112-128 launch 2-CTA clusters
// (cudaErrorLaunchOutOfResources where none fits)
int dmt_bilstm_merged_bf16(const void* x, long long stride_b,
                           long long stride_t, long long stride_f, int batch,
                           int timesteps, int in_dim, int hidden,
                           int num_layers, const void* w, const void* bias,
                           float half_forget_bias, void* ws, void* out,
                           void* stream) {
#define DMT_LAUNCH(hp)                                                      \
  return launch_tc<hp>(x, stride_b, stride_t, stride_f, batch, timesteps,  \
                       in_dim, hidden, num_layers, w, bias,                \
                       half_forget_bias, ws, out, stream)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the bf16 kernel at this shape (a
// cluster of 1 CTA up to Hp = 104, of 2 beyond) into *clusters
int dmt_bilstm_merged_bf16_clusters(int in_dim, int hidden, int* clusters) {
#define DMT_CLUSTERS(hp) return clusters_tc<hp>(in_dim, hidden, clusters)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

}  // extern "C"
