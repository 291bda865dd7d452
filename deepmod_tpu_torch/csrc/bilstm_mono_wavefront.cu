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
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh's pieces): ONE CTA A
//   LAYER, a cluster of num_layers CTAs (1-3) per 64-window tile and lane;
//   grid (tiles * num_layers, 2). CTA L runs layer L at step t = s - L
//   with its [Wh; Wx] resident (173,056 B at Hp = 104) and lstm_tc.cuh's
//   step: one m64n(2Hp)k16 wgmma chain over [h_{t-1}; x_t], the cell in
//   registers. It writes h_t into its own h ring and, through distributed
//   shared memory, into CTA L+1's x ring slot t & 1, where layer L+1 reads
//   it as its x_t one wavefront step later. Layer 0 reads x through the
//   caller's strides (prefetched during the chain); the last layer writes
//   only the center row. One cluster barrier (arrive.release /
//   wait.acquire) ends each wavefront step, steps + num_layers - 1 of them
//   (13 at T=21 with 3 layers); the argument below carries over slot for
//   slot, with CTA L's h ring for ring[L] and CTA L+1's x ring for
//   ring[L]'s second reader. Hidden 105-128 (Hp 112-128) combine this
//   with lstm_tc.cuh's unit split: 2 CTAs a layer, a cluster of 2 *
//   num_layers (6 at most, within the portable 8), each CTA writing its
//   half of h_t into its own and its peer's h ring and into both x rings
//   of layer L+1. The cluster's CTAs sit on num_layers (or 2 num_layers)
//   SMs of one GPC, so a GPC whose SM count the cluster does not divide
//   keeps SMs idle (chip_smoke.py logs cudaOccupancyMaxActiveClusters).
//   tile 64 only; the 600-thread bound below is the fp32 kernel's.
//
// fp32 design:
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

#include "lstm_tc.cuh"

namespace {

namespace cg = cooperative_groups;
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

// ------------------------------------------------- bf16: the tensor cores

// the bf16 kernel: layer cluster_rank / split of one tile-lane
template <int kHp>
__global__ void __launch_bounds__(
    dmt::tc::threads_of(dmt::tc::split_of(kHp)), 1)
bilstm_wavefront_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           long long stride_b, long long stride_t,
                           long long stride_f, int batch, int timesteps,
                           int in_dim, int hidden, int num_layers,
                           int nx_max, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, float fb_term,
                           float* __restrict__ out) {
  namespace tc = dmt::tc;
  using bf16 = __nv_bfloat16;
  constexpr int kSplit = tc::split_of(kHp);
  constexpr int kT = tc::threads_of(kSplit);
  constexpr int kN = 2 * kHp;
  constexpr int kGroups = kHp / 8;
  constexpr int kNh = kHp / 8;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int layer = crank / kSplit;
  const int part = crank % kSplit;
  const int tile = blockIdx.x / (num_layers * kSplit);
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int steps = timesteps / 2 + 1;
  const int tid = threadIdx.x;
  const int half = kSplit > 1 ? part : tid >> 7;  // tc_gate_columns' warpgroup
  const int row0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int unit0 = half * (kHp / 2) + (tid & 3);  // unit of group p: + 4p
  const int widest = in_dim > hidden ? in_dim : hidden;
  const tc::Smem sm = tc::carve(tc_smem, kHp, nx_max,
                                tc::weight_bytes(kHp, widest) / kSplit);

  tc::Layer L;
  L.w = w;  // [layer][lane] in the packing
  for (int l = 0; l < layer; ++l) {
    L.w += tc::weight_bytes(kHp, l == 0 ? in_dim : hidden);  // 2 lanes
  }
  L.in_dim = layer == 0 ? in_dim : hidden;
  L.w += lane * static_cast<long long>(tc::weight_bytes(kHp, L.in_dim) / 2);
  L.bias = bias + (layer * 2 + lane) * kHp * 4;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.b0 = static_cast<long long>(tile) * tc::kRows;
  L.fb = fb_term;
  tc::LayerIO io = {};
  io.x = layer == 0 ? x : nullptr;
  io.sb = stride_b;
  io.st = stride_t;
  io.sf = stride_f;
  io.reversed = lane == 1;
  io.in_steps = timesteps;
  const int nx = tc::x_cols(L.in_dim);
  const int nc = kNh + nx;
  const int nk = tc::k_tiles(kHp, L.in_dim);
  const bool last = layer == num_layers - 1;

  // where h_t goes: this CTA's h ring (and the peer's), layer L+1's x rings
  unsigned char* h_peer =
      kSplit > 1 ? cluster.map_shared_rank(sm.h, crank ^ 1) : nullptr;
  unsigned char* x_next_layer[kSplit];
#pragma unroll
  for (int r = 0; r < kSplit; ++r) {
    x_next_layer[r] =
        last ? nullptr : cluster.map_shared_rank(sm.x, (layer + 1) * kSplit + r);
  }

  // prologue: weights and bias of the layer, h_{-1} = 0, the zero column,
  // x_0 (layer 0); every CTA of the cluster started before any remote write
  {
    tc::load_weights<kT>(sm.w, L.w, kHp, 0, 2 * nk, part, kSplit, false);
    const float4* b = reinterpret_cast<const float4*>(L.bias);
    for (int u = tid; u < kHp; u += kT) sm.bias[u] = b[u];
    const uint4 z = make_uint4(0, 0, 0, 0);
    uint4* h1 = reinterpret_cast<uint4*>(sm.h + sm.h_slot);
    for (int i = tid; i < sm.h_slot / 16; i += kT) h1[i] = z;
    for (int i = tid; i < tc::kColBytes / 16; i += kT) {
      reinterpret_cast<uint4*>(sm.zero)[i] = z;
    }
    if (layer == 0) {
      bf16 v[tc::kXRegs];
      tc::x_issue<kT>(io, L, 0, sm.x, nx, v);
      tc::x_complete<kT>(io, L, 0, sm.x, nx, v);
    }
    tc::cp_async_wait_all();
    tc::step_barrier<true>();
  }

  float c[2 * kGroups];
#pragma unroll
  for (int i = 0; i < 2 * kGroups; ++i) c[i] = 0.0f;
  float acc[kHp];
#pragma unroll
  for (int i = 0; i < kHp; ++i) acc[i] = 0.0f;
  const uint32_t w_lbo = 4 * kHp / kSplit * 16;
  const uint32_t w_base =
      tc::smem_addr(sm.w) + (kSplit > 1 ? 0 : half) * (kN / 8) * 128;
  const uint32_t zero_col = tc::smem_addr(sm.zero);

  for (int s = 0; s < steps + num_layers - 1; ++s) {
    const int t = s - layer;
    if (t >= 0 && t < steps) {  // CTA-uniform
      const int slot = t & 1;
      const uint32_t h_prev = tc::smem_addr(sm.h + (slot ^ 1) * sm.h_slot);
      const uint32_t x_cur = tc::smem_addr(sm.x + slot * sm.x_slot);
      tc::chain<kN>(
          acc,
          [&](int cc) {
            return cc < kNh  ? h_prev + cc * tc::kColBytes
                   : cc < nc ? x_cur + (cc - kNh) * tc::kColBytes
                             : zero_col;
          },
          w_base, w_lbo, nk, 0);
      // while the tensor cores run: layer 0's x_{t+1}
      bf16 xv[tc::kXRegs];
      unsigned char* x_next = sm.x + (slot ^ 1) * sm.x_slot;
      const bool fetch = layer == 0 && t + 1 < steps;
      if (fetch) tc::x_issue<kT>(io, L, t + 1, x_next, nx, xv);
      tc::wgmma_wait_all();
      tc::fence_acc(acc);

      const bool emit = last && t == steps - 1;
#pragma unroll
      for (int p = 0; p < kGroups; ++p) {
        const int u = unit0 + 4 * p;
        bf16 v0 = dmt::from_f<bf16>(0.0f), v1 = dmt::from_f<bf16>(0.0f);
        if (half * (kHp / 2) + 4 * p < hidden) {  // warp-uniform
          tc::cell_pair(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2],
                        acc[8 * p + 3], acc[8 * p + 4], acc[8 * p + 5],
                        acc[8 * p + 6], acc[8 * p + 7], sm.bias[u], fb_term,
                        c[2 * p], c[2 * p + 1], v0, v1);
        }
        // one straight-line body for every group, as run_layer's: a
        // `continue` past the stores here (the last step's h is read by
        // nobody) cost ~4,000 cycles a step in the cell (clock64 stamps,
        // H100) and 20% of the kernel's time
        tc::put_h(sm.h + slot * sm.h_slot, u, row0, v0, v1);
        if (kSplit > 1) tc::put_h(h_peer + slot * sm.h_slot, u, row0, v0, v1);
        if (!last) {
#pragma unroll
          for (int r = 0; r < kSplit; ++r) {
            tc::put_h(x_next_layer[r] + slot * sm.x_slot, u, row0, v0, v1);
          }
        }
        if (emit && u < hidden) {
          const long long b = L.b0 + row0;
          float* o = out + lane * hidden + u;
          if (b < batch) o[b * 2 * hidden] = dmt::to_f(v0);
          if (b + 8 < batch) o[(b + 8) * 2 * hidden] = dmt::to_f(v1);
        }
      }
      if (fetch) tc::x_complete<kT>(io, L, t + 1, x_next, nx, xv);
    }
    tc::step_barrier<true>();
  }
}

template <int kHp>
size_t wavefront_smem(int in_dim, int hidden) {
  namespace tc = dmt::tc;
  const int widest = in_dim > hidden ? in_dim : hidden;
  return tc::smem_bytes(kHp, tc::x_cols(widest),
                        tc::weight_bytes(kHp, widest) / tc::split_of(kHp));
}

template <int kHp>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* out, void* stream) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  if (num_layers < 1 || num_layers > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nx_max = tc::x_cols(in_dim > hidden ? in_dim : hidden);
  const int cluster = num_layers * kSplit;
  const dim3 grid((batch + tc::kRows - 1) / tc::kRows * cluster, 2);
  return static_cast<int>(tc::launch_cluster(
      bilstm_wavefront_tc_kernel<kHp>, grid, tc::threads_of(kSplit),
      wavefront_smem<kHp>(in_dim, hidden), static_cast<cudaStream_t>(stream),
      cluster, static_cast<const __nv_bfloat16*>(x), stride_b, stride_t,
      stride_f, batch, timesteps, in_dim, hidden, num_layers, nx_max,
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      fb_term, static_cast<float*>(out)));
}

template <int kHp>
int clusters_tc(int in_dim, int hidden, int num_layers, int* clusters) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  return static_cast<int>(tc::cluster_occupancy(
      bilstm_wavefront_tc_kernel<kHp>, tc::threads_of(kSplit),
      wavefront_smem<kHp>(in_dim, hidden), num_layers * kSplit, clusters));
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

// bf16 mode, the tensor-core kernel, 64 windows a cluster: x is bf16; w
// and bias are the tensor-core packing of ops/bilstm_fused.py (per
// [layer][lane] the padded, gate-permuted (Kp, 4Hp) bf16 weights in core
// columns and the (Hp, 4) fp32 bias, i/f/o pre-halved); half_forget_bias
// is 0.5 * forget_bias; num_layers 1-3. Hp = hidden rounded up to 8, at
// most 128 (else cudaErrorInvalidValue); a cluster shape the card cannot
// place returns cudaErrorLaunchOutOfResources
int dmt_bilstm_wavefront_bf16(const void* x, long long stride_b,
                              long long stride_t, long long stride_f,
                              int batch, int timesteps, int in_dim,
                              int hidden, int num_layers, const void* w,
                              const void* bias, float half_forget_bias,
                              void* out, void* stream) {
#define DMT_LAUNCH(hp)                                                      \
  return launch_tc<hp>(x, stride_b, stride_t, stride_f, batch, timesteps,  \
                       in_dim, hidden, num_layers, w, bias,                \
                       half_forget_bias, out, stream)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the bf16 kernel's cluster at this
// shape (num_layers CTAs, or 2 * num_layers for Hp 112-128) into *clusters
int dmt_bilstm_wavefront_bf16_clusters(int in_dim, int hidden,
                                       int num_layers, int* clusters) {
#define DMT_CLUSTERS(hp) \
  return clusters_tc<hp>(in_dim, hidden, num_layers, clusters)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

}  // extern "C"
