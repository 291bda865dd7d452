// The fp32 LSTM layer for Hopper (sm_90a): the fp32 modes of K1
// (bilstm_fused.cu, every layer of a lane in one launch), of K4
// (bilstm_layer.cu, one layer of both lanes a launch), of K5a
// (bilstm_mono_merged.cu, K1's launch with one operand ring), and the
// training forward K2 in both precisions (bilstm_train.cu, every layer of
// a lane in one launch), run one lane of one layer over a tile of windows
// through run_layer below, as the bf16 inference modes run lstm_tc.cuh's.
// Three kernels build their own loops from the pieces below: K5b fp32
// (bilstm_mono_pregemm.cu, two phases a layer), K5c fp32
// (bilstm_mono_wavefront.cu, a CTA group a layer, the layers' steps as a
// wavefront over a stream of tiles) and K6 (lstm_layer.cu, W_h only, over
// precomputed gates). Every kernel that reads a layer's weights holds them
// resident here.
//
// Numerics: each gate pre-activation is one thread's ordered fmaf chain
// from 0: the x rows in ascending k, then the h rows (skipped at t = 0,
// where h is 0), then the bias. K1, K4, K5a, K5b (fp32 gates: the x sum
// stored and reloaded as it is) and K5c run that chain, so K5a-c keep K1
// fp32's bits at every tile, split and thread shape (K6 runs the h rows
// from 0 and adds its precomputed gates after them, JAX's order for that
// function). What follows the
// product is a policy of run_layer (Infer below, or K2's TrainFwd): where
// the weights and bias come from, the cell, and the step's global stores.
// Infer is K1's fp32 contract (lstm_common.cuh::cell<false>): fp32 inputs,
// weights and stored h, exp sigmoids, forget_bias added inside the f
// sigmoid; the packed weights below; the blocked row for the next layer or
// the readout row. K2's contract is bilstm_train.cu's.
//
// Why not the tensor cores: fp32 there is TF32 (or 3xTF32 with hi/lo
// operands, twice the resident weights and h rounded every step), and the
// fp32 parity is 2e-5. The product stays on the CUDA cores.
//
// The CUDA-core bodies this replaces read the layer's TF (in+H, 4H)
// kernel, 320 KB at H=100, from L2 in every block on every step, four
// scalar loads a unit and k for 24 windows' FMAs (K4's time followed those
// reads, K1's did not: PERF.md §6). Here the weights stay in shared memory
// for the whole layer:
//
//   split by units over a thread-block cluster of kSplit CTAs (1, 2 or 4,
//     ops/bilstm_fused.py::f32_shape picks it from what fits): CTA r holds
//     the four gate columns of units r*U .. r*U+U-1 (U = ceil(H/kSplit))
//     of every row k of [Wx; Wh], [k][U][i,j,f,o] (the packing of
//     ops/bilstm_fused.py::f32_pack_layer, (in+H, Hp4, 4) with the units
//     padded to a multiple of 4: zero weights and bias, so a padded unit's
//     h is exactly 0 and is never stored; K2 gathers the same layout from
//     the TF kernels in its prologue). At H=100 in a 2-CTA cluster:
//     200 x 50 x 16 B = 160,000 B a CTA.
//   threads: U x tile/8; thread (u, g) owns unit u for the 8 windows
//     g*8 .. g*8+7, its four gates in registers (32 accumulators) and its
//     8 cell states c. Per row k it loads one 16-byte weight vector (the
//     unit's i, j, f, o; consecutive threads on consecutive units, so a
//     warp's load is conflict-free) and two 16-byte operand vectors (the
//     warp's lanes share one or two window groups: broadcast loads), and
//     issues 32 FMAs; the next row's loads are issued before this row's
//     FMAs.
//   operands [k][window] in shared memory: an h ring of 2 slots [H][tile]
//     and an x ring of 2 slots [in][tile]. Every CTA holds the whole
//     h_{t-1} of its tile: after the cell each thread writes its 8 h
//     values into its own ring slot t&1 and, through distributed shared
//     memory, into every peer's, with 16-byte stores. K5a (kMerged) lays
//     the same bytes out as one operand ring of 2 slots [in+H][tile]: a
//     slot stacks x_t (rows 0..in-1) on h_{t-1} (rows in..in+H-1), so a
//     step is ONE product over in+H rows of one slot, and h_t goes into
//     the h rows of the other slot, beside x_{t+1}.
//   a step t: issue x_{t+1} into the other x slot (cp.async of one blocked
//     row from global memory; at layer 0 register loads through the
//     caller's strides), the product over x_t then h_{t-1}, the cell, h_t
//     into the rings, x_{t+1} completed, the cluster barrier's arrive, the
//     step's global stores (the policy's: the blocked row of h_t for the
//     next layer, the readout row, K2's residuals), the barrier's wait.
//     Two slots a ring make that one barrier enough: no slot is written
//     in the step that reads it, and a CTA writes a peer's slot t&1 in the
//     step in which every CTA reads slot (t-1)&1 (lstm_tc.cuh's argument,
//     the same split).
//   the blocked sequence between layers: per (lane, step, tile) one
//     [H][tile] fp32 block, so a row is one contiguous copy in and out.
//
// What bounds it on an H100: the FMAs, 2 (in+H) 4H FLOP a window, lane,
// layer and step (operations at 67 TFLOP/s), with the step's dependent
// chain (the product, the cell's 3 expf and 2 tanhf, the exchange and the
// barrier) repeated steps x layers times. Measured on an H100 (PERF.md §6):
// the time follows the warps each SM sub-partition issues for (2 at tile
// 40 in 2-CTA clusters, 250 threads); the product is ~3/4 of a step.

#pragma once

#include "lstm_tc.cuh"

namespace dmt {
namespace f32 {

namespace cg = cooperative_groups;

// threads a CTA at most (the launch bound: up to 255 registers a thread)
constexpr int kMaxThreads = 256;
// layer-0 input values a thread prefetches in registers
constexpr int kXRegs = 4;

// units of the packed weights: hidden rounded up to a multiple of 4 (the
// widest split), so every CTA's unit range lies inside them
__host__ __device__ constexpr int packed_units(int hidden) {
  return (hidden + 3) / 4 * 4;
}
// units a CTA of a kSplit cluster owns
__host__ __device__ constexpr int units_of(int hidden, int split) {
  return (hidden + split - 1) / split;
}
// threads a CTA: one a (unit, group of kR windows)
__host__ __device__ constexpr int threads_of(int hidden, int split,
                                             int tile) {
  return units_of(hidden, split) * (tile / kR);
}
// a CTA's shared memory: w_rows + 1 rows of its units' weights
// [rows][U][4], the h ring [2][H][tile], the x ring [2][in_max][tile] and
// a spare row (the product's look-ahead load of row `rows` reads inside
// the buffers)
__host__ __device__ inline size_t smem_bytes(int w_rows, int in_max,
                                             int hidden, int split,
                                             int tile) {
  return (static_cast<size_t>(w_rows) + 1) * units_of(hidden, split) * 16 +
         (2 * static_cast<size_t>(hidden) + 2 * in_max + 1) * tile * 4;
}
// ... holding the widest layer's [Wx; Wh] (K1, K4, K5a, K2)
__host__ __device__ inline size_t smem_bytes(int in_max, int hidden,
                                             int split, int tile) {
  return smem_bytes(in_max + hidden, in_max, hidden, split, tile);
}

struct Smem {
  float4* w;  // [rows][U]: the CTA's units' (i, j, f, o) of each row
  float* h;   // 2 slots of [H][tile]
  float* x;   // 2 slots of [in_max][tile], then the spare row
  int h_slot, x_slot;  // floats a slot
};

// smem_bytes' layout: w_rows + 1 weight rows, then the rings
__device__ inline Smem carve(unsigned char* base, int w_rows, int in_max,
                             int hidden, int units, int tile) {
  Smem s;
  s.w = reinterpret_cast<float4*>(base);
  s.h = reinterpret_cast<float*>(
      base + (static_cast<size_t>(w_rows) + 1) * units * 16);
  s.h_slot = hidden * tile;
  s.x_slot = in_max * tile;
  s.x = s.h + 2 * s.h_slot;
  return s;
}
__device__ inline Smem carve(unsigned char* base, int in_max, int hidden,
                             int units, int tile) {
  return carve(base, in_max + hidden, in_max, hidden, units, tile);
}

struct Layer {
  const float* w;     // this lane's packed (in+H, Hp4, 4) weights (global)
  const float* bias;  // this lane's (Hp4, 4) bias (global)
  int in_dim, hidden, steps, batch, lane, tile;
  long long b0;
  float fb;  // forget_bias
};

// where a layer reads its inputs and writes its outputs, for this CTA; TX
// is the type of the layer-0 windows (float; K2 in bf16 reads bf16)
template <typename TX>
struct LayerIOT {
  // layer 0: the (B, T, F) windows through the caller's strides, the bw
  // lane reading step in_steps-1-t when `reversed`; otherwise null
  const TX* x;
  long long sb, st, sf;
  int reversed, in_steps;
  // later layers: the blocked row ([H][tile]) of step t at
  // seq_in + t*seq_in_t
  const float* seq_in;
  long long seq_in_t;
  // every layer but the last: its rows, the same layout; else null
  float* seq_out;
  long long seq_out_t;
  // the last layer: (B, 2H) fp32 features, written at step out_step only
  float* out;
  int out_step;
};
using LayerIO = LayerIOT<float>;

// x_t[k][w] of a layer-0 tile through the caller's strides (zero past the
// batch)
template <typename TX>
__device__ __forceinline__ float window_value(const LayerIOT<TX>& io,
                                              const Layer& L, int tt, int i) {
  const int k = i / L.tile;
  const long long b = L.b0 + (i - k * L.tile);
  return b < L.batch ? to_f(io.x[b * io.sb + tt * io.st + k * io.sf]) : 0.0f;
}

// x_t into ring slot `slot`: issue (cp.async of the blocked row, or
// register loads at layer 0) ...
template <typename TX>
__device__ __forceinline__ void x_issue(const LayerIOT<TX>& io,
                                        const Layer& L, int t, float* slot,
                                        float (&v)[kXRegs]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = L.in_dim * L.tile;
  if (io.x != nullptr) {
    const int tt = io.reversed ? io.in_steps - 1 - t : t;
#pragma unroll
    for (int j = 0; j < kXRegs; ++j) {
      const int i = tid + j * nt;
      v[j] = i < n ? window_value(io, L, tt, i) : 0.0f;
    }
  } else {
    const float4* src =
        reinterpret_cast<const float4*>(io.seq_in + t * io.seq_in_t);
    float4* dst = reinterpret_cast<float4*>(slot);
    for (int i = tid; i < n / 4; i += nt) tc::cp_async16(dst + i, src + i);
  }
}
// ... and complete it (every thread, before the barrier)
template <typename TX>
__device__ __forceinline__ void x_complete(const LayerIOT<TX>& io,
                                           const Layer& L,
                                           int t, float* slot,
                                           const float (&v)[kXRegs]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (io.x != nullptr) {
    const int n = L.in_dim * L.tile;
#pragma unroll
    for (int j = 0; j < kXRegs; ++j) {
      const int i = tid + j * nt;
      if (i < n) slot[i] = v[j];
    }
    // inputs wider than the registers hold load here
    const int tt = io.reversed ? io.in_steps - 1 - t : t;
    for (int i = tid + kXRegs * nt; i < n; i += nt) {
      slot[i] = window_value(io, L, tt, i);
    }
  } else {
    tc::cp_async_wait_all();
  }
}

// cp.async rows 0..rows-1 of the CTA's units u0 .. u0+units-1 of a
// layer-lane's packed weights ((rows, hp4, 4) fp32 in global memory) into
// dst as [rows][units]
__device__ __forceinline__ void load_weights(float4* dst, const float* w,
                                             int rows, int hp4, int u0,
                                             int units) {
  const float4* src = reinterpret_cast<const float4*>(w);
  for (int i = threadIdx.x; i < rows * units; i += blockDim.x) {
    const int k = i / units;
    tc::cp_async16(dst + i, src + static_cast<long long>(k) * hp4 + u0 +
                                (i - k * units));
  }
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[kR]) {
#pragma unroll
  for (int q = 0; q < kR / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// acc[g][r] += sum over k < rows of w[k][g] * op[k][r], one fmaf a term in
// ascending k. op: row 0 at this thread's first window (rows `tile`
// floats apart); w: row 0 at this thread's unit (rows `units` vectors
// apart). Row k+1's loads are issued before row k's FMAs (row `rows` is
// read and not used: the buffers' spare rows)
__device__ __forceinline__ void product(const float* __restrict__ op,
                                        int tile,
                                        const float4* __restrict__ w,
                                        int units, int rows,
                                        float (&acc)[4][kR]) {
  float4 wn = w[0];
  float xn[kR];
  load_row(op, xn);
#pragma unroll 4  // faster than 2 on an H100; 1 is much slower (PERF.md §6)
  for (int k = 0; k < rows; ++k) {
    const float4 wk = wn;
    float xk[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) xk[r] = xn[r];
    wn = w[(k + 1) * units];
    load_row(op + (k + 1) * tile, xn);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[0][r] = fmaf(wk.x, xk[r], acc[0][r]);
      acc[1][r] = fmaf(wk.y, xk[r], acc[1][r]);
      acc[2][r] = fmaf(wk.z, xk[r], acc[2][r]);
      acc[3][r] = fmaf(wk.w, xk[r], acc[3][r]);
    }
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kR]) {
#pragma unroll
  for (int q = 0; q < kR / 4; ++q) {
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// K1's and K4's policy for run_layer: the f32_pack_layer weights and bias
// (L.w, L.bias), the exp-sigmoid cell, and the step's global stores: the
// blocked row of h_t for the next layer, or the readout row (a policy has
// these three members; K2's is bilstm_train.cu::TrainFwd)
struct Infer {
  // the CTA's units u0 .. u0+units-1 of every row into dst (cp.async; the
  // caller waits) and unit u's (i, j, f, o) bias
  __device__ __forceinline__ void weights(float4* dst, const Layer& L,
                                          int u0, int units) const {
    load_weights(dst, L.w, L.in_dim + L.hidden, packed_units(L.hidden), u0,
                 units);
  }
  __device__ __forceinline__ float4 bias(const Layer& L, int u) const {
    return reinterpret_cast<const float4*>(L.bias)[u];
  }
  __device__ __forceinline__ float cell_h(float gi, float gj, float gf,
                                          float go, float fb,
                                          float& c) const {
    return cell<false>(gi, gj, gf, go, fb, c);
  }
  // unit u's h_t of windows w0 .. w0+kR-1 of the tile (u a live unit)
  template <typename TX>
  __device__ __forceinline__ void stores(const LayerIOT<TX>& io,
                                         const Layer& L, int t, int u, int w0,
                                         const float (&h)[kR],
                                         const float (&c)[kR]) const {
    if (io.seq_out != nullptr) {
      store_vec(io.seq_out + t * io.seq_out_t + u * L.tile + w0, h);
    }
    if (io.out != nullptr && t == io.out_step) {
      const long long b0 = L.b0 + w0;
      float* o = io.out + L.lane * L.hidden + u;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (b0 + r < L.batch) o[(b0 + r) * 2 * L.hidden] = h[r];
      }
    }
  }
};

// One layer of one lane over L.steps steps for the CTA's tile (kSplit > 1:
// this CTA's units, the peers of the cluster holding the others). Starts
// with a barrier of the whole cluster (the previous layer's reads of this
// CTA's buffers are over, and every peer has started) and ends with one.
// kMerged: K5a's operand ring (the header), the same chain
template <int kSplit, typename TX, typename Policy = Infer,
          bool kMerged = false>
__device__ __forceinline__ void run_layer(const Smem& sm, const Layer& L,
                                          const LayerIOT<TX>& io,
                                          const Policy& pol = Policy()) {
  constexpr bool kCluster = kSplit > 1;
  const int tid = threadIdx.x;
  const int rank =
      kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int units = units_of(L.hidden, kSplit);
  const int ul = tid % units;
  const int w0 = (tid / units) * kR;
  const int u = rank * units + ul;  // this thread's unit
  const bool live = u < L.hidden;   // not a padded unit
  // x_t at x_ring + (t&1) x_stride; h_t at h_ring + slot x h_stride, slot
  // t&1 (the h ring) or (t+1)&1 (kMerged: the operand slot of step t+1,
  // its rows from in on; the two rings' bytes are contiguous)
  float* const x_ring = kMerged ? sm.h : sm.x;
  float* const h_ring = kMerged ? sm.h + L.in_dim * L.tile : sm.h;
  const int x_stride = kMerged ? sm.h_slot + sm.x_slot : sm.x_slot;
  const int h_stride = kMerged ? x_stride : sm.h_slot;
  // every CTA's h ring (this one's too), where the cell's h goes
  float* peer_h[kSplit];
  if constexpr (kCluster) {
#pragma unroll
    for (int p = 0; p < kSplit; ++p) {
      peer_h[p] = cg::this_cluster().map_shared_rank(h_ring, p);
    }
  } else {
    peer_h[0] = h_ring;
  }

  // prologue: the CTA's weights, x_0. A peer stores its units of a row
  // after its step's arrive, so row t is seen after step t+1's barrier;
  // at one step a layer (T = 1) nothing follows the previous layer's
  // stores of row 0 before this read of it but a barrier here
  if constexpr (kCluster) {
    if (L.steps == 1 && io.x == nullptr) {
      tc::cluster_arrive();
      tc::cluster_wait();
    }
  }
  pol.weights(sm.w, L, rank * units, units);
  const float4 bias = pol.bias(L, u);
  {
    float v[kXRegs];
    x_issue(io, L, 0, x_ring, v);
    x_complete(io, L, 0, x_ring, v);
    tc::cp_async_wait_all();
  }
  if constexpr (kCluster) {
    tc::cluster_arrive();
    tc::cluster_wait();
  } else {
    __syncthreads();
  }

  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;
  const float4* wx = sm.w + ul;
  const float4* wh = wx + L.in_dim * units;

  for (int t = 0; t < L.steps; ++t) {
    const int s = t & 1;
    float* x_next = x_ring + (s ^ 1) * x_stride;
    float xv[kXRegs];
    if (t + 1 < L.steps) x_issue(io, L, t + 1, x_next, xv);

    float acc[4][kR];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
    if constexpr (kMerged) {
      // [x_t; h_{t-1}] . [Wx; Wh] in one pass (h_{-1} = 0: x rows only)
      product(x_ring + s * x_stride + w0, L.tile, wx, units,
              t > 0 ? L.in_dim + L.hidden : L.in_dim, acc);
    } else {
      product(x_ring + s * x_stride + w0, L.tile, wx, units, L.in_dim, acc);
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        product(h_ring + (s ^ 1) * h_stride + w0, L.tile, wh, units,
                L.hidden, acc);
      }
    }
    float h[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      h[r] = pol.cell_h(acc[0][r] + bias.x, acc[1][r] + bias.y,
                        acc[2][r] + bias.z, acc[3][r] + bias.w, L.fb, c[r]);
    }
    const int at = (kMerged ? s ^ 1 : s) * h_stride + u * L.tile + w0;
    if (live) {
#pragma unroll
      for (int p = 0; p < kSplit; ++p) store_vec(peer_h[p] + at, h);
    }
    if (t + 1 < L.steps) x_complete(io, L, t + 1, x_next, xv);
    if constexpr (kCluster) tc::cluster_arrive();

    // the step's global stores, while the barrier settles
    if (live) pol.stores(io, L, t, u, w0, h, c);
    if constexpr (kCluster) {
      tc::cluster_wait();
    } else {
      __syncthreads();
    }
  }
}

// runtime split -> F(kSplit)
#define DMT_F32_DISPATCH(split, F)                                \
  switch (split) {                                                \
    case 1: F(1); case 2: F(2); case 4: F(4);                     \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// Every layer of one lane for one tile, a cluster of kSplit CTAs (each its
// units): the body of K1's fp32 kernel (bilstm_fused.cu) and, kMerged, of
// K5a's (bilstm_mono_merged.cu). Grid (ceil(B / tile) * kSplit, 2),
// blockIdx.y the lane; T//2+1 steps a layer (the readout cone); w and bias
// the f32_pack_layer packing, [layer][lane]; ws the blocked rows between
// layers, (tiles, 2, steps, H * tile), each layer overwriting the one
// before in place: its step t writes row t, which every CTA of the
// cluster read in step t-1's prefetch, before that step's barrier
template <int kSplit, bool kMerged>
__device__ __forceinline__ void run_stack(
    const float* __restrict__ x, long long stride_b, long long stride_t,
    long long stride_f, int batch, int timesteps, int in_dim, int hidden,
    int num_layers, const float* __restrict__ w,
    const float* __restrict__ bias, float forget_bias,
    float* __restrict__ ws, float* __restrict__ out, int tile) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tile_i = blockIdx.x / kSplit;
  const int widest = in_dim > hidden ? in_dim : hidden;
  const Smem sm = carve(f32_smem, widest, hidden, units_of(hidden, kSplit),
                        tile);
  const int hp4 = packed_units(hidden);
  // this tile's rows of the workspace: (tiles, 2, steps, H * tile)
  const long long row = static_cast<long long>(hidden) * tile;
  float* rows = ws + (static_cast<long long>(tile_i) * 2 + lane) * steps * row;

  Layer L;
  L.w = w;
  L.bias = bias;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.tile = tile;
  L.b0 = static_cast<long long>(tile_i) * tile;
  L.fb = forget_bias;
  for (int layer = 0; layer < num_layers; ++layer) {
    L.in_dim = layer == 0 ? in_dim : hidden;
    const long long lane_w = static_cast<long long>(L.in_dim + hidden) * hp4 * 4;
    const bool last = layer == num_layers - 1;
    LayerIO io;
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
    Layer here = L;
    here.w += lane * lane_w;
    here.bias += lane * hp4 * 4;
    run_layer<kSplit, float, Infer, kMerged>(sm, here, io);
    L.w += 2 * lane_w;  // [layer][lane]
    L.bias += 2 * hp4 * 4;
  }
}

// the launch of a run_stack kernel: `split` CTAs a cluster (1, 2 or 4),
// tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256 threads (else
// cudaErrorInvalidValue); cudaErrorLaunchOutOfResources where no cluster
// fits. Returns cudaGetLastError() after the launch (0 = success)
template <int kSplit, typename... Params>
int launch_stack(void (*kernel)(Params...), const void* x,
                 long long stride_b, long long stride_t, long long stride_f,
                 int batch, int timesteps, int in_dim, int hidden,
                 int num_layers, const void* w, const void* bias,
                 float forget_bias, void* ws, void* out, int tile,
                 void* stream) {
  const int threads = threads_of(hidden, kSplit, tile);
  if (tile % kR != 0 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int widest = in_dim > hidden ? in_dim : hidden;
  const size_t smem = smem_bytes(widest, hidden, kSplit, tile);
  const dim3 grid((batch + tile - 1) / tile * kSplit, 2);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* wsf = static_cast<float*>(ws);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(tc::launch_cluster(
        kernel, grid, threads, smem, st, kSplit, xf, stride_b, stride_t,
        stride_f, batch, timesteps, in_dim, hidden, num_layers, wf, bf,
        forget_bias, wsf, o, tile));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(
        xf, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, wf, bf, forget_bias, wsf, o, tile);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace f32
}  // namespace dmt
