// One LSTM layer, one direction, for Hopper (sm_90a): the recurrence over
// precomputed gate pre-activations (K6), on the fp32 core's pieces
// (lstm_f32.cuh).
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
// index t. fp32 throughout (the core's Infer cell: exp sigmoids, accurate
// expf/tanhf).
//
// Design: W_h resident in shared memory, split by units over a
// thread-block cluster of kSplit CTAs (1, 2 or 4; ops/lstm_layer.py::
// lstm_layer_shape picks it), one direction a launch, grid ceil(B / tile)
// x kSplit CTAs, no workspace:
//   CTA r holds the four gate columns of units r*U .. r*U+U-1 (U =
//     ceil(H/kSplit)) of every row of W_h, [k][U][i,j,f,o]: the W_h rows of
//     ops/bilstm_fused.py::f32_pack_layer's packing (ops/lstm_layer.py::
//     pack_wh), loaded once in the prologue. At H=100 in a 2-CTA cluster,
//     100 x 50 x 16 B = 80,000 B a CTA: half of K1's, so two CTAs can
//     share an SM.
//   thread (u, g) owns unit u for the 8 windows g*8 .. g*8+7 and keeps
//     their c in registers. A step starts its accumulators at 0 and adds
//     the h rows of h_{t-1} in ascending k (the core's product; none at the
//     first step), then gates = xp_t + acc: the JAX association and the
//     CUDA-core kernel's this replaces, so the same fmaf chain. h_t goes
//     into every peer's h ring slot through distributed shared memory;
//     the cluster barrier's arrive, the global store of h_t, the wait: one
//     cluster barrier a step, the core's two-slot ring argument.
//   the thread's 4 x 8 values of xp_{t+1} ((B, T, 4H), coalesced across
//     units) are issued into the registers of xp_t right after step t's
//     arrive, beside the store of h_t; nothing waits on them until step
//     t+1's cell, so they are in flight under the barrier and the next
//     product, and one set of 32 registers serves (two sets, the next
//     step's issued before the product, would cost 32 more a thread).
//     Windows past the batch read the last window's values (never
//     stored), so no load is guarded.
//
// What bounds it on an H100: per window and step 2 * H * 4H FLOP of
// h-product (T=21, H=100: 1.68 MFLOP a window) against 4H + H fp32 values
// moved (42 KB a window over the T steps), so operations (67 TFLOP/s fp32)
// bound it at about twice the time the bytes need (3.35 TB/s); the T
// dependent steps are its latency floor. Measured on an H100 (PERF.md §6):
// 2.6x the bound at tile 40 in 2-CTA clusters, one CTA an SM (162
// registers at 250 threads); a step's single 100-row product leaves the
// cell, the barrier and the loads a large share. The body it replaces read
// its unit's column of W_h from L2 in every step with four scalar loads a
// row, and took two block barriers a step.

#include "lstm_f32.cuh"

namespace {

namespace f32 = dmt::f32;
namespace tc = dmt::tc;
using dmt::kR;

// xp_t's four gate values of unit u for the thread's windows (each row
// clamped to the batch)
__device__ __forceinline__ void load_xp(const float* __restrict__ xp,
                                        const long long (&row)[kR], int t,
                                        int gates, int hidden, int u,
                                        float (&v)[4][kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float* p = xp + row[r] + static_cast<long long>(t) * gates + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g][r] = p[g * hidden];
  }
}

// one direction of one layer for a tile of windows, a cluster of kSplit
// CTAs (each its units)
template <int kSplit>
__global__ void __launch_bounds__(f32::kMaxThreads, 1)
lstm_recurrence_f32_kernel(const float* __restrict__ xp,
                           const float* __restrict__ wh, float forget_bias,
                           float* __restrict__ out, int batch, int timesteps,
                           int hidden, int reverse, int tile) {
  constexpr bool kCluster = kSplit > 1;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int units = f32::units_of(hidden, kSplit);
  // W_h's H rows, the h ring, no x ring (the spare row only)
  const f32::Smem sm = f32::carve(f32_smem, hidden, 0, hidden, units, tile);
  const int rank =
      kCluster ? static_cast<int>(f32::cg::this_cluster().block_rank()) : 0;
  const int tid = threadIdx.x;
  const int ul = tid % units;
  const int w0 = (tid / units) * kR;
  const int u = rank * units + ul;  // this thread's unit
  const bool live = u < hidden;     // not a padded unit
  const int gates = 4 * hidden;
  const long long b0 =
      static_cast<long long>(blockIdx.x / kSplit) * tile + w0;
  long long row[kR];  // each window's (b, 0, 0) in xp, clamped to the batch
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long b = b0 + r < batch ? b0 + r : batch - 1;
    row[r] = b * timesteps * gates;
  }
  const int ux = live ? u : hidden - 1;  // a padded unit reads a live one's
  float* peer_h[kSplit];
  if constexpr (kCluster) {
#pragma unroll
    for (int p = 0; p < kSplit; ++p) {
      peer_h[p] = f32::cg::this_cluster().map_shared_rank(sm.h, p);
    }
  } else {
    peer_h[0] = sm.h;
  }

  // prologue: the CTA's W_h rows and xp_0; every CTA of the cluster has
  // started before any remote write
  f32::load_weights(sm.w, wh, hidden, f32::packed_units(hidden),
                    rank * units, units);
  float cur[4][kR];
  load_xp(xp, row, reverse ? timesteps - 1 : 0, gates, hidden, ux, cur);
  tc::cp_async_wait_all();
  if constexpr (kCluster) {
    tc::cluster_arrive();
    tc::cluster_wait();
  } else {
    __syncthreads();
  }

  const f32::Infer pol{};
  const float4* w = sm.w + ul;
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;
  for (int step = 0; step < timesteps; ++step) {
    const int t = reverse ? timesteps - 1 - step : step;
    const int s = step & 1;
    float acc[4][kR];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
    if (step > 0) {  // h_{-1} = 0 contributes nothing
      f32::product(sm.h + (s ^ 1) * sm.h_slot + w0, tile, w, units, hidden,
                   acc);
    }
    float h[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      h[r] = pol.cell_h(cur[0][r] + acc[0][r], cur[1][r] + acc[1][r],
                        cur[2][r] + acc[2][r], cur[3][r] + acc[3][r],
                        forget_bias, c[r]);
    }
    const int at = s * sm.h_slot + u * tile + w0;
    if (live) {
#pragma unroll
      for (int p = 0; p < kSplit; ++p) f32::store_vec(peer_h[p] + at, h);
    }
    if constexpr (kCluster) tc::cluster_arrive();
    // h_t to (B, T, H) and xp_{t+1} issued, while the barrier settles
    if (live) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (b0 + r < batch) {
          out[((b0 + r) * timesteps + t) * hidden + u] = h[r];
        }
      }
    }
    if (step + 1 < timesteps) {
      load_xp(xp, row, reverse ? t - 1 : t + 1, gates, hidden, ux, cur);
    }
    if constexpr (kCluster) {
      tc::cluster_wait();
    } else {
      __syncthreads();
    }
  }
}

// a CTA's shared memory: W_h's rows of its units, the h ring, a spare row
template <int kSplit>
size_t smem_of(int hidden, int tile) {
  return f32::smem_bytes(hidden, 0, hidden, kSplit, tile);
}

template <int kSplit>
int clusters(int hidden, int tile, int* n) {
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % kR != 0 || threads > f32::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(tc::cluster_occupancy(
      lstm_recurrence_f32_kernel<kSplit>, threads,
      smem_of<kSplit>(hidden, tile), kSplit, n));
}

template <int kSplit>
int launch(const void* xp, const void* wh, float forget_bias, void* out,
           int batch, int timesteps, int hidden, int reverse, int tile,
           void* stream) {
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % kR != 0 || threads > f32::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_of<kSplit>(hidden, tile);
  auto kernel = lstm_recurrence_f32_kernel<kSplit>;
  const dim3 grid((batch + tile - 1) / tile * kSplit);
  const auto* xf = static_cast<const float*>(xp);
  const auto* wf = static_cast<const float*>(wh);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(tc::launch_cluster(
        kernel, grid, threads, smem, st, kSplit, xf, wf, forget_bias, o,
        batch, timesteps, hidden, reverse, tile));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(xf, wf, forget_bias, o, batch,
                                        timesteps, hidden, reverse, tile);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// xp (B, T, 4H) fp32 gate pre-activations (bias included); wh_packed the
// (H, Hp4, 4) fp32 packing of the (H, 4H) W_h (ops/lstm_layer.py::
// pack_wh); out (B, T, H) fp32. `split` CTAs a cluster (1, 2 or 4), tile a
// multiple of 8, ceil(hidden/split) * tile/8 <= 256 threads (else
// cudaErrorInvalidValue); cudaErrorLaunchOutOfResources where no cluster
// fits. Returns cudaGetLastError() after the launch (0 = success)
int dmt_lstm_layer_f32(const void* xp, const void* wh_packed,
                       float forget_bias, void* out, int batch,
                       int timesteps, int hidden, int reverse, int tile,
                       int split, void* stream) {
#define DMT_LAUNCH(s)                                                     \
  return launch<s>(xp, wh_packed, forget_bias, out, batch, timesteps,     \
                   hidden, reverse, tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of K6 at this shape (clusters of `split`
// CTAs), into *clusters
int dmt_lstm_layer_f32_clusters(int hidden, int tile, int split,
                                int* clusters_out) {
#define DMT_CLUSTERS(s) return clusters<s>(hidden, tile, clusters_out)
  DMT_F32_DISPATCH(split, DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

}  // extern "C"
