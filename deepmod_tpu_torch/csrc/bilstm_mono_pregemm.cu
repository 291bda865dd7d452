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
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh's pieces): 64 windows
//   of one lane a work item, 256 threads (two warpgroups, each owning half
//   of the gate columns in tc_gate_columns' permutation).
//   persistent grid: one CTA per resident slot (SMs x blocks an SM), each
//     looping over the (tile, lane) items, so the workspaces are sized per
//     slot, not per block: a gate buffer of steps x 256 x Hp values (1.17
//     MB fp32 at H=100, T=21: 154.6 MB over 132 slots, where the fp32
//     kernel's, one a block, is 9.2 GB at 262,144 windows) and the
//     inter-layer rows, steps x 64 x Hp bf16 (146 KB a slot).
//   projection: per layer, for every step t, ONE wgmma chain x_t @ Wx
//     (m64n(2Hp)k16, ceil(in/8)/2 k-tiles; the 64 x steps rows of the
//     layer's GEMM taken 64 at a time, x_{t+1} prefetched while the chain
//     runs), no bias; each thread stores its accumulator fragment to the
//     gate buffer in fragment order (group p of thread tid at (p * 256 +
//     tid) * 8), fp32 or rounded to bf16 (RNE, where JAX's astype rounds).
//     Only Wx is resident then; Wh takes the same shared memory after it.
//   recurrence: the accumulator starts as the thread's stored gx_t row
//     (contiguous 16- and 32-byte loads, each thread reading back only
//     what it wrote, so no barrier or fence between the phases), the
//     chain adds h_{t-1} @ Wh on top (scale-d = 1, ceil(Hp/8)/2 k-tiles,
//     half of K5a's [h; x] chain; none at t = 0, where h is 0), then the
//     bias and the cell: gx + h Wh + b, JAX's association. Each group's
//     gx_{t+1} loads right after its cell and nothing waits for them
//     before the next step's chain (bf16 gates widened after the
//     barrier), so the loads run under the remaining groups' cells. One
//     barrier a step (the h ring of two).
//   shared memory: h ring, x ring, zero column, the resident weight
//     (max(Hp/8, ceil(in/8)) core columns rounded up to even x 4Hp x 16
//     B: 93,184 B at Hp = 104, 131,072 B at Hp = 128) and the bias:
//     199,680 B at Hp = 128, so K5b needs no cluster at any hidden <= 128.
//
// fp32 (the fp32 core, csrc/lstm_f32.cuh's pieces; both gate stores):
//   persistent grid: one cluster of `split` CTAs a resident slot
//     (ops/bilstm_fused.py::f32_shape's split: 2 at H=100, 4 at
//     H=105-128; the slots from cudaOccupancyMaxActiveClusters, at most
//     the work items), each looping over the (tile, lane) items, `tile`
//     windows of one lane an item, every layer. Thread (u, g) of CTA r
//     owns unit r*U + u for the 8 windows g*8 .. g*8+7, as in K1.
//   workspaces a function of the card, not of the batch: one gate region
//     a CTA, steps x U x 4 x tile values of its own units only, fp32 or
//     RNE-rounded to bf16, each step's in fragment order (a thread's 4 x 8
//     sums as 16-byte vectors, vector q of every thread together, so a
//     warp's access is 512 contiguous bytes) (352 KB a CTA at H=100,
//     T=21, tile 40 in fp32:
//     46.5 MB over 132 CTAs, where the old kernel's, one a block, took
//     9.2 GB at 262,144 windows and would take 148 GB at 4,194,304), and
//     K1's blocked rows between layers, one [H][tile] block a step, a
//     slot's (176 KB).
//   phase 1 of a layer: only its Wx rows of the CTA's units are resident
//     (the first `in` rows of f32_pack_layer's (in+H, Hp4, 4) layout);
//     every step's input row of the tile (cp.async of the blocked row, or
//     register loads through the caller's strides at layer 0, into an x
//     ring of two slots) is projected with the core's product, no bias,
//     and stored to the gate region: a product with no chain between
//     steps, one CTA barrier a step for the ring. Each thread reads back
//     only what it wrote, so no fence lies between the phases.
//   phase 2: Wh takes the same shared memory. A step starts the
//     accumulators from its stored row (loaded during the previous step),
//     issues the next step's loads, adds the h rows in ascending k (none
//     at t = 0), then the bias, runs the cell (the core's Infer), writes
//     h_t into every CTA's h ring through distributed shared memory and
//     the blocked row (or the readout) to device memory: one cluster
//     barrier a step, K1's.
//   a cluster barrier opens each phase: the previous layer's row stores
//     (the last step's made after its arrive) are seen by every CTA's
//     cp.async, and phase 2 rewrites the rows that phase 1 read, in place.
//   x is read through the caller's strides (materialized windows or the
//     overlapping window view of a feature block, read in place).
//   What it replaces: a CUDA-core body that read its unit's column of the
//     layer's TF (in+H, 4H) kernel from L2 in both phases, on every step in
//     every block, and a gate workspace a block that grew with the batch.
//
// Numerics: K1's contract (lstm_common.cuh's cell). With fp32 gates the FMA
// chain is K1's (the x-row sum stored in fp32, reloaded, then the h rows),
// so the result has K1's bits; with bf16 gates the stored sum is rounded to
// nearest even (__float2bfloat16_rn), in either precision, as the TPU
// kernel's bf16 gate buffer is.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1 at H=100,
// F=7, T=21, by operations. fp32: the FMAs on the CUDA cores, the weights
// resident; the chain a step runs only H rows of it (in+H in K1), the x
// rows being done ahead in phase 1. The gate region adds 2 x steps x 4H x
// 4 B a window, layer and lane of traffic (fp32 gates; 27.7 GB at 262,144
// windows, the slots' 46.5 MB mostly in the 50 MB L2). In bf16 the product
// runs on the tensor cores and the bound is lstm_tc.cuh's (the cell's
// tanhf); the gate buffer adds 2 x steps x 4Hp x 4 B a window, layer and
// lane of traffic (fp32 gates), 57.6 GB at 262,144 windows, mostly past
// the 50 MB L2.

#include "lstm_f32.cuh"

namespace {

// ---------------------------------------------- fp32: the fp32 core

namespace f32 = dmt::f32;
using dmt::kR;

// a thread's 4 x kR gate sums of one step in its CTA's gate region, as
// 4 x kV 16-byte vectors of G (bf16: rounded to nearest even) in fragment
// order: vector q of thread tid at (q * threads + tid) * 16 B of the
// step's region, so a warp's access is 512 contiguous bytes (p: the
// thread's vector 0, `stride` elements to the next). Read back raw, so
// that nothing waits on the loads until the sums are widened
template <typename G>
struct Gates {
  static constexpr int kV = kR * static_cast<int>(sizeof(G)) / 16;
  static constexpr int kE = 16 / static_cast<int>(sizeof(G));  // a vector
  uint4 raw[4][kV];

  __device__ __forceinline__ static void store(G* p, long long stride,
                                               const float (&acc)[4][kR]) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (sizeof(G) == 4) {
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          reinterpret_cast<float4*>(p + (g * kV + v) * stride)[0] =
              make_float4(acc[g][4 * v], acc[g][4 * v + 1],
                          acc[g][4 * v + 2], acc[g][4 * v + 3]);
        }
      } else {
        dmt::store8(p + g * stride, acc[g]);
      }
    }
  }
  __device__ __forceinline__ void load(const G* p, long long stride) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        raw[g][v] =
            reinterpret_cast<const uint4*>(p + (g * kV + v) * stride)[0];
      }
  }
  // into acc, exactly (bf16 -> fp32 is exact)
  __device__ __forceinline__ void widen(float (&acc)[4][kR]) const {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (sizeof(G) == 4) {
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          acc[g][4 * v] = __uint_as_float(raw[g][v].x);
          acc[g][4 * v + 1] = __uint_as_float(raw[g][v].y);
          acc[g][4 * v + 2] = __uint_as_float(raw[g][v].z);
          acc[g][4 * v + 3] = __uint_as_float(raw[g][v].w);
        }
      } else {
        // store8's bfloat162 pairs: the low half first
        const uint32_t wv[4] = {raw[g][0].x, raw[g][0].y, raw[g][0].z,
                                raw[g][0].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[g][2 * k] = __uint_as_float(wv[k] << 16);
          acc[g][2 * k + 1] = __uint_as_float(wv[k] & 0xffff0000u);
        }
      }
    }
  }
};

// the barrier that opens a phase: the whole cluster's (release / acquire:
// the rows stored before it, in device memory too, are seen after it)
template <bool kCluster>
__device__ __forceinline__ void phase_barrier() {
  if constexpr (kCluster) {
    dmt::tc::cluster_arrive();
    dmt::tc::cluster_wait();
  } else {
    __syncthreads();
  }
}

// One layer of one lane for the CTA's tile in K5b's two phases (the
// header); gx: this thread's vector 0 in its CTA's gate region at step 0,
// gx_t values a step on, gx_v from one of its vectors to the next
template <int kSplit, typename G>
__device__ __forceinline__ void run_layer_pregemm(
    const f32::Smem& sm, float* const (&peer_h)[kSplit], const f32::Layer& L,
    const f32::LayerIO& io, G* gx, long long gx_t, long long gx_v) {
  constexpr bool kCluster = kSplit > 1;
  const int tid = threadIdx.x;
  const int rank =
      kCluster ? static_cast<int>(f32::cg::this_cluster().block_rank()) : 0;
  const int units = f32::units_of(L.hidden, kSplit);
  const int ul = tid % units;
  const int w0 = (tid / units) * kR;
  const int u = rank * units + ul;  // this thread's unit
  const bool live = u < L.hidden;   // not a padded unit
  const int hp4 = f32::packed_units(L.hidden);
  const float4* w = sm.w + ul;
  const f32::Infer pol{};

  // phase 1: gx_t = x_t . Wx for every step, no bias (the barrier first:
  // the last step's rows were stored after its arrive)
  phase_barrier<kCluster>();
  f32::load_weights(sm.w, L.w, L.in_dim, hp4, rank * units, units);
  {
    float v[f32::kXRegs];
    f32::x_issue(io, L, 0, sm.x, v);
    f32::x_complete(io, L, 0, sm.x, v);
    dmt::tc::cp_async_wait_all();
  }
  __syncthreads();
  for (int t = 0; t < L.steps; ++t) {
    const int s = t & 1;
    float* x_next = sm.x + (s ^ 1) * sm.x_slot;
    float xv[f32::kXRegs];
    if (t + 1 < L.steps) f32::x_issue(io, L, t + 1, x_next, xv);
    float acc[4][kR];
    dmt::zero(acc);
    f32::product(sm.x + s * sm.x_slot + w0, L.tile, w, units, L.in_dim, acc);
    Gates<G>::store(gx + t * gx_t, gx_v, acc);
    if (t + 1 < L.steps) f32::x_complete(io, L, t + 1, x_next, xv);
    __syncthreads();
  }

  // phase 2: Wh in Wx's place (every thread's last product is behind the
  // barrier above), the recurrence from the stored rows
  f32::load_weights(sm.w, L.w + static_cast<long long>(L.in_dim) * hp4 * 4,
                    L.hidden, hp4, rank * units, units);
  const float4 bias = pol.bias(L, u);
  Gates<G> next;
  next.load(gx, gx_v);
  dmt::tc::cp_async_wait_all();
  phase_barrier<kCluster>();
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;
  for (int t = 0; t < L.steps; ++t) {
    const int s = t & 1;
    float acc[4][kR];
    next.widen(acc);
    // the next step's row, in flight under this step's product and cell
    if (t + 1 < L.steps) next.load(gx + (t + 1) * gx_t, gx_v);
    if (t > 0) {  // h_{-1} = 0 adds nothing
      f32::product(sm.h + (s ^ 1) * sm.h_slot + w0, L.tile, w, units,
                   L.hidden, acc);
    }
    float h[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      h[r] = pol.cell_h(acc[0][r] + bias.x, acc[1][r] + bias.y,
                        acc[2][r] + bias.z, acc[3][r] + bias.w, L.fb, c[r]);
    }
    const int at = s * sm.h_slot + u * L.tile + w0;
    if (live) {
#pragma unroll
      for (int p = 0; p < kSplit; ++p) f32::store_vec(peer_h[p] + at, h);
    }
    if constexpr (kCluster) dmt::tc::cluster_arrive();
    // the step's global stores, while the barrier settles
    if (live) pol.stores(io, L, t, u, w0, h, c);
    if constexpr (kCluster) {
      dmt::tc::cluster_wait();
    } else {
      __syncthreads();
    }
  }
}

// the persistent grid: cluster `slot` of gridDim.x / kSplit runs items
// slot, slot + slots, ... (item = 2 * tile + lane), every layer
template <int kSplit, typename G>
__global__ void __launch_bounds__(f32::kMaxThreads, 1)
bilstm_pregemm_f32_kernel(const float* __restrict__ x, long long stride_b,
                          long long stride_t, long long stride_f, int batch,
                          int timesteps, int in_dim, int hidden,
                          int num_layers, const float* __restrict__ w,
                          const float* __restrict__ bias, float forget_bias,
                          G* gx_ws, float* seq_ws,
                          float* __restrict__ out, int tile) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int steps = timesteps / 2 + 1;
  const int widest = in_dim > hidden ? in_dim : hidden;
  const int units = f32::units_of(hidden, kSplit);
  // one of Wx and Wh resident at a time
  const f32::Smem sm = f32::carve(f32_smem, widest, widest, hidden, units,
                                  tile);
  const int hp4 = f32::packed_units(hidden);
  const int slot = blockIdx.x / kSplit;
  const int slots = gridDim.x / kSplit;
  const int items = 2 * ((batch + tile - 1) / tile);
  // this slot's rows, (steps, H * tile); this thread's gate values
  const long long row = static_cast<long long>(hidden) * tile;
  float* rows = seq_ws + slot * steps * row;
  const long long gx_t = static_cast<long long>(units) * 4 * tile;
  const long long gx_v = static_cast<long long>(blockDim.x) * Gates<G>::kE;
  G* gx = gx_ws + blockIdx.x * steps * gx_t + threadIdx.x * Gates<G>::kE;
  float* peer_h[kSplit];
  if constexpr (kSplit > 1) {
#pragma unroll
    for (int p = 0; p < kSplit; ++p) {
      peer_h[p] = f32::cg::this_cluster().map_shared_rank(sm.h, p);
    }
  } else {
    peer_h[0] = sm.h;
  }

  for (int item = slot; item < items; item += slots) {
    const int lane = item & 1;  // 0 = fw, 1 = bw
    f32::Layer L;
    L.w = w;
    L.bias = bias;
    L.hidden = hidden;
    L.steps = steps;
    L.batch = batch;
    L.lane = lane;
    L.tile = tile;
    L.b0 = static_cast<long long>(item >> 1) * tile;
    L.fb = forget_bias;
    for (int layer = 0; layer < num_layers; ++layer) {
      L.in_dim = layer == 0 ? in_dim : hidden;
      const long long lane_w =
          static_cast<long long>(L.in_dim + hidden) * hp4 * 4;
      const bool last = layer == num_layers - 1;
      f32::LayerIO io;
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
      f32::Layer here = L;
      here.w += lane * lane_w;
      here.bias += lane * hp4 * 4;
      run_layer_pregemm<kSplit, G>(sm, peer_h, here, io, gx, gx_t, gx_v);
      L.w += 2 * lane_w;  // [layer][lane]
      L.bias += 2 * hp4 * 4;
    }
  }
}

// a CTA's shared memory: the wider of Wx and Wh, the core's rings
template <int kSplit>
size_t smem_f32(int in_dim, int hidden, int tile) {
  const int widest = in_dim > hidden ? in_dim : hidden;
  return f32::smem_bytes(widest, widest, hidden, kSplit, tile);
}

// resident clusters of the kernel at this shape, into *n
template <int kSplit, typename G>
int clusters_f32(int in_dim, int hidden, int tile, int* n) {
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % kR != 0 || threads > f32::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dmt::tc::cluster_occupancy(
      bilstm_pregemm_f32_kernel<kSplit, G>, threads,
      smem_f32<kSplit>(in_dim, hidden, tile), kSplit, n));
}

template <int kSplit, typename G>
int launch_f32(const void* x, long long stride_b, long long stride_t,
               long long stride_f, int batch, int timesteps, int in_dim,
               int hidden, int num_layers, const void* w, const void* bias,
               float forget_bias, void* gx, void* seq_ws, int slots,
               void* out, int tile, void* stream) {
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % kR != 0 || threads > f32::kMaxThreads || slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_f32<kSplit>(in_dim, hidden, tile);
  auto kernel = bilstm_pregemm_f32_kernel<kSplit, G>;
  const dim3 grid(slots * kSplit);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* gxg = static_cast<G*>(gx);
  auto* sq = static_cast<float*>(seq_ws);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(dmt::tc::launch_cluster(
        kernel, grid, threads, smem, st, kSplit, xf, stride_b, stride_t,
        stride_f, batch, timesteps, in_dim, hidden, num_layers, wf, bf,
        forget_bias, gxg, sq, o, tile));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(
        xf, stride_b, stride_t, stride_f, batch, timesteps, in_dim, hidden,
        num_layers, wf, bf, forget_bias, gxg, sq, o, tile);
    return static_cast<int>(cudaGetLastError());
  }
}

// ------------------------------------------------- bf16: the tensor cores

// shared bytes of the one resident weight (Wx, then Wh): the wider of the
// two in core columns, rounded up to even (a zero partner column)
__host__ __device__ inline size_t pregemm_weight_bytes(int hp, int nx_max) {
  int cols = hp / 8 > nx_max ? hp / 8 : nx_max;
  cols += cols & 1;
  return static_cast<size_t>(cols) * 4 * hp * 16;
}

// a thread's accumulator fragment <-> the gate buffer row of one step:
// group p (8 values) of thread tid at (p * kThreads + tid) * 8
template <int kHp, bool kGateBf16>
__device__ __forceinline__ void store_gates(const float (&acc)[kHp],
                                            void* row) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kHp / 8; ++p) {
    const int i = p * dmt::tc::kThreads + tid;
    if constexpr (kGateBf16) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = acc[8 * p + k];
      dmt::store8(static_cast<__nv_bfloat16*>(row) + 8 * i, v);
    } else {
      float4* d = static_cast<float4*>(row) + 2 * i;
      d[0] = make_float4(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2],
                         acc[8 * p + 3]);
      d[1] = make_float4(acc[8 * p + 4], acc[8 * p + 5], acc[8 * p + 6],
                         acc[8 * p + 7]);
    }
  }
}
// issues the loads of group p into the accumulator and does not wait for
// them: fp32 gates straight into acc[8p..8p+7], bf16 gates as their four
// raw 32-bit words into acc[8p..8p+3], widened by widen_gates after the
// step's barrier. Converting a load's value at once stalls the cell on
// the load's latency (clock64 stamps on an H100: a recurrence step's cell
// took ~17,500 cycles that way against ~7,700).
template <int kHp, bool kGateBf16>
__device__ __forceinline__ void load_gate_group(float (&acc)[kHp], int p,
                                                const void* row) {
  const int i = p * dmt::tc::kThreads + threadIdx.x;
  if constexpr (kGateBf16) {
    const uint4 w = static_cast<const uint4*>(row)[i];
    acc[8 * p] = __uint_as_float(w.x);
    acc[8 * p + 1] = __uint_as_float(w.y);
    acc[8 * p + 2] = __uint_as_float(w.z);
    acc[8 * p + 3] = __uint_as_float(w.w);
  } else {
    const float4* f = static_cast<const float4*>(row) + 2 * i;
    const float4 a = f[0];
    const float4 b = f[1];
    acc[8 * p] = a.x;
    acc[8 * p + 1] = a.y;
    acc[8 * p + 2] = a.z;
    acc[8 * p + 3] = a.w;
    acc[8 * p + 4] = b.x;
    acc[8 * p + 5] = b.y;
    acc[8 * p + 6] = b.z;
    acc[8 * p + 7] = b.w;
  }
}
// bf16 gates: each group's four raw words (store8's bfloat162 pairs, the
// low half first) -> its eight fp32 values, exactly
template <int kHp>
__device__ __forceinline__ void widen_gates(float (&acc)[kHp]) {
#pragma unroll
  for (int p = 0; p < kHp / 8; ++p) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(acc[8 * p + k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[8 * p + 2 * k] = __uint_as_float(w[k] << 16);
      acc[8 * p + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// one template a gate dtype, each with its own registers and schedule
// (with the dtype a runtime flag, fp32 gates took 46.8 ms at 262,144
// windows on an H100)
template <int kHp, bool kGateBf16>
__global__ void __launch_bounds__(dmt::tc::kThreads, 1)
bilstm_pregemm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         long long stride_b, long long stride_t,
                         long long stride_f, int batch, int timesteps,
                         int in_dim, int hidden, int num_layers, int nx_max,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, float fb_term,
                         void* gx_ws,
                         __nv_bfloat16* seq_ws, float* __restrict__ out) {
  namespace tc = dmt::tc;
  using bf16 = __nv_bfloat16;
  constexpr int kT = tc::kThreads;
  constexpr int kN = 2 * kHp;
  constexpr int kGroups = kHp / 8;
  constexpr int kNh = kHp / 8;
  constexpr int kNkh = (kNh + 1) / 2;  // k-tiles of the h chain
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int steps = timesteps / 2 + 1;
  const int items = 2 * ((batch + tc::kRows - 1) / tc::kRows);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int unit0 = wg * (kHp / 2) + (tid & 3);  // unit of group p: + 4p
  const tc::Smem sm =
      tc::carve(tc_smem, kHp, nx_max, pregemm_weight_bytes(kHp, nx_max));
  // this slot's workspaces: the gate rows and the inter-layer rows
  const size_t gx_row = static_cast<size_t>(kT) * kHp * (kGateBf16 ? 2 : 4);
  unsigned char* gx =
      static_cast<unsigned char*>(gx_ws) + blockIdx.x * steps * gx_row;
  const long long row = static_cast<long long>(tc::kRows) * kHp;
  bf16* rows = seq_ws + blockIdx.x * steps * row;
  const uint32_t w_lbo = 4 * kHp * 16;
  const uint32_t w_base = tc::smem_addr(sm.w) + wg * (kN / 8) * 128;
  const uint32_t zero_col = tc::smem_addr(sm.zero);
  for (int i = tid; i < tc::kColBytes / 16; i += kT) {
    reinterpret_cast<uint4*>(sm.zero)[i] = make_uint4(0, 0, 0, 0);
  }

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int lane = item & 1;  // 0 = fw, 1 = bw
    tc::Layer L;
    L.hidden = hidden;
    L.steps = steps;
    L.batch = batch;
    L.lane = lane;
    L.b0 = static_cast<long long>(item >> 1) * tc::kRows;
    L.fb = fb_term;
    const bf16* wl = w;
    const float* bl = bias;
    for (int layer = 0; layer < num_layers; ++layer) {
      L.in_dim = layer == 0 ? in_dim : hidden;
      const long long lane_w = tc::weight_bytes(kHp, L.in_dim) / 2;
      const bf16* lw = wl + lane * lane_w;  // [layer][lane]
      const int nx = tc::x_cols(L.in_dim);
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
      float acc[kHp];

      // the projection: gx_t = x_t @ Wx for every step, no bias (Wx: the
      // packing's core columns after Wh's)
      tc::load_weights<kT>(sm.w, lw, kHp, kNh, nx, 0, 1, nx & 1);
      {
        bf16 v[tc::kXRegs];
        tc::x_issue<kT>(io, L, 0, sm.x, nx, v);
        tc::x_complete<kT>(io, L, 0, sm.x, nx, v);
      }
      tc::cp_async_wait_all();
      tc::step_barrier<false>();
      for (int t = 0; t < steps; ++t) {
        const int s = t & 1;
        const uint32_t x_cur = tc::smem_addr(sm.x + s * sm.x_slot);
        tc::chain<kN>(
            acc,
            [&](int cc) {
              return cc < nx ? x_cur + cc * tc::kColBytes : zero_col;
            },
            w_base, w_lbo, (nx + 1) / 2, 0);
        bf16 xv[tc::kXRegs];
        unsigned char* x_next = sm.x + (s ^ 1) * sm.x_slot;
        if (t + 1 < steps) tc::x_issue<kT>(io, L, t + 1, x_next, nx, xv);
        tc::wgmma_wait_all();
        tc::fence_acc(acc);
        store_gates<kHp, kGateBf16>(acc, gx + t * gx_row);
        if (t + 1 < steps) tc::x_complete<kT>(io, L, t + 1, x_next, nx, xv);
        tc::step_barrier<false>();
      }

      // the recurrence: Wh resident in Wx's place, acc from gx_t
      tc::load_weights<kT>(sm.w, lw, kHp, 0, kNh, 0, 1, kNh & 1);
      const float4* b4 = reinterpret_cast<const float4*>(bl + lane * kHp * 4);
      for (int u = tid; u < kHp; u += kT) sm.bias[u] = b4[u];
#pragma unroll
      for (int p = 0; p < kGroups; ++p) {
        load_gate_group<kHp, kGateBf16>(acc, p, gx);
      }
      tc::cp_async_wait_all();
      tc::step_barrier<false>();
      float c[2 * kGroups];
#pragma unroll
      for (int i = 0; i < 2 * kGroups; ++i) c[i] = 0.0f;
      for (int t = 0; t < steps; ++t) {
        const int s = t & 1;
        if constexpr (kGateBf16) widen_gates<kHp>(acc);
        if (t > 0) {  // h_{-1} = 0 adds nothing
          const uint32_t h_prev = tc::smem_addr(sm.h + (s ^ 1) * sm.h_slot);
          tc::chain<kN>(
              acc,
              [&](int cc) {
                return cc < kNh ? h_prev + cc * tc::kColBytes : zero_col;
              },
              w_base, w_lbo, kNkh, 1);
          // while the tensor cores run: h_{t-1} out for the next layer
          if (!last) {
            tc::store_row<kHp, kT>(rows + (t - 1) * row,
                                   sm.h + (s ^ 1) * sm.h_slot);
          }
          tc::wgmma_wait_all();
          tc::fence_acc(acc);
        }
        unsigned char* h_cur = sm.h + s * sm.h_slot;
        const bool emit = last && t == steps - 1;
        // the next step's row; the last step reloads its own (the value is
        // never used), so the loads in the unrolled cell loop need no
        // condition: with one, the cell took ~10,000 more cycles a step
        const unsigned char* gx_next =
            gx + (t + 1 < steps ? t + 1 : t) * gx_row;
#pragma unroll
        for (int p = 0; p < kGroups; ++p) {
          const int u = unit0 + 4 * p;
          bf16 v0 = dmt::from_f<bf16>(0.0f), v1 = dmt::from_f<bf16>(0.0f);
          if (wg * (kHp / 2) + 4 * p < hidden) {  // warp-uniform
            tc::cell_pair(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2],
                          acc[8 * p + 3], acc[8 * p + 4], acc[8 * p + 5],
                          acc[8 * p + 6], acc[8 * p + 7], sm.bias[u],
                          fb_term, c[2 * p], c[2 * p + 1], v0, v1);
          }
          tc::put_h(h_cur, u, row0, v0, v1);
          if (emit && u < hidden) {
            const long long b = L.b0 + row0;
            float* o = out + lane * hidden + u;
            if (b < batch) o[b * 2 * hidden] = dmt::to_f(v0);
            if (b + 8 < batch) o[(b + 8) * 2 * hidden] = dmt::to_f(v1);
          }
          load_gate_group<kHp, kGateBf16>(acc, p, gx_next);
        }
        tc::step_barrier<false>();
      }
      if (!last) {
        tc::store_row<kHp, kT>(rows + (steps - 1) * row,
                               sm.h + ((steps - 1) & 1) * sm.h_slot);
      }
      // the next projection rewrites the weights and rings, and reads the
      // rows just stored
      __syncthreads();
      wl += 2 * lane_w;
      bl += 2 * kHp * 4;
    }
  }
}

// resident slots of the bf16 kernel at this shape (SMs x blocks an SM,
// at most the work items): the wrapper's workspaces hold that many
template <int kHp, bool kGateBf16>
int slots_tc(int batch, int in_dim, int hidden, int* slots) {
  namespace tc = dmt::tc;
  const int nx_max = tc::x_cols(in_dim > hidden ? in_dim : hidden);
  const size_t smem = tc::smem_bytes(kHp, nx_max,
                                     pregemm_weight_bytes(kHp, nx_max));
  auto kernel = bilstm_pregemm_tc_kernel<kHp, kGateBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      tc::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = 2 * ((batch + tc::kRows - 1) / tc::kRows);
  *slots = items < sms * per_sm ? items : sms * per_sm;
  return 0;
}

template <int kHp, bool kGateBf16>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* gx, void* seq_ws, int slots, void* out,
              void* stream) {
  namespace tc = dmt::tc;
  const int nx_max = tc::x_cols(in_dim > hidden ? in_dim : hidden);
  const size_t smem = tc::smem_bytes(kHp, nx_max,
                                     pregemm_weight_bytes(kHp, nx_max));
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bilstm_pregemm_tc_kernel<kHp, kGateBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<slots, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), stride_b, stride_t, stride_f,
      batch, timesteps, in_dim, hidden, num_layers, nx_max,
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      fb_term, gx, static_cast<__nv_bfloat16*>(seq_ws),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fp32 mode, the fp32 core on a persistent grid of `slots` clusters of
// `split` CTAs (1, 2 or 4): x is fp32; w and bias are the f32_pack_layer
// packing of ops/bilstm_fused.py (per [layer][lane] the (in+H, Hp4, 4)
// fp32 weights and the (Hp4, 4) bias); gx: slots * split * (T//2+1) *
// ceil(hidden/split) * 4 * tile gate values, fp32, or bf16 when gate_bf16
// is set; seq_ws: slots * (T//2+1) * hidden * tile fp32; slots from
// dmt_bilstm_pregemm_f32_clusters, at most the 2 * ceil(B/tile) items.
// Tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256 threads (else
// cudaErrorInvalidValue); cudaErrorLaunchOutOfResources where no cluster
// fits. Returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_pregemm_f32(const void* x, long long stride_b,
                           long long stride_t, long long stride_f, int batch,
                           int timesteps, int in_dim, int hidden,
                           int num_layers, const void* w, const void* bias,
                           float forget_bias, void* gx, int gate_bf16,
                           void* seq_ws, int slots, void* out, int tile,
                           int split, void* stream) {
#define DMT_LAUNCH(s)                                                     \
  return gate_bf16                                                        \
             ? launch_f32<s, __nv_bfloat16>(                              \
                   x, stride_b, stride_t, stride_f, batch, timesteps,     \
                   in_dim, hidden, num_layers, w, bias, forget_bias, gx,  \
                   seq_ws, slots, out, tile, stream)                      \
             : launch_f32<s, float>(x, stride_b, stride_t, stride_f,      \
                                    batch, timesteps, in_dim, hidden,     \
                                    num_layers, w, bias, forget_bias, gx, \
                                    seq_ws, slots, out, tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the fp32 kernel at this shape and gate
// dtype (clusters of `split` CTAs), into *clusters: the persistent grid's
// slots before the cap by the work items
int dmt_bilstm_pregemm_f32_clusters(int in_dim, int hidden, int tile,
                                    int split, int gate_bf16,
                                    int* clusters) {
#define DMT_CLUSTERS(s)                                                      \
  return gate_bf16 ? clusters_f32<s, __nv_bfloat16>(in_dim, hidden, tile,    \
                                                    clusters)                \
                   : clusters_f32<s, float>(in_dim, hidden, tile, clusters)
  DMT_F32_DISPATCH(split, DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

// bf16 mode, the tensor-core kernel, 64 windows a work item: x is bf16; w
// and bias are the tensor-core packing of ops/bilstm_fused.py (per
// [layer][lane] the padded, gate-permuted (Kp, 4Hp) bf16 weights in core
// columns, Wh's first, and the (Hp, 4) fp32 bias, i/f/o pre-halved);
// half_forget_bias is 0.5 * forget_bias. gx: slots * (T//2+1) * 256 * Hp
// gate values, fp32, or bf16 when gate_bf16 is set; seq_ws: slots *
// (T//2+1) * 64 * Hp bf16; slots from dmt_bilstm_pregemm_bf16_slots (the
// grid). Hp = hidden rounded up to 8, at most 128 (else
// cudaErrorInvalidValue)
int dmt_bilstm_pregemm_bf16(const void* x, long long stride_b,
                            long long stride_t, long long stride_f,
                            int batch, int timesteps, int in_dim, int hidden,
                            int num_layers, const void* w, const void* bias,
                            float half_forget_bias, void* gx, int gate_bf16,
                            void* seq_ws, int slots, void* out,
                            void* stream) {
#define DMT_LAUNCH(hp)                                                      \
  return gate_bf16                                                          \
             ? launch_tc<hp, true>(x, stride_b, stride_t, stride_f, batch,  \
                                   timesteps, in_dim, hidden, num_layers,   \
                                   w, bias, half_forget_bias, gx, seq_ws,   \
                                   slots, out, stream)                      \
             : launch_tc<hp, false>(x, stride_b, stride_t, stride_f, batch, \
                                    timesteps, in_dim, hidden, num_layers,  \
                                    w, bias, half_forget_bias, gx, seq_ws,  \
                                    slots, out, stream)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_LAUNCH)
#undef DMT_LAUNCH
}

// the persistent grid of the bf16 kernel for this shape and gate dtype,
// into *slots; returns a CUDA error code (0 = success)
int dmt_bilstm_pregemm_bf16_slots(int batch, int in_dim, int hidden,
                                  int gate_bf16, int* slots) {
#define DMT_SLOTS(hp)                                                  \
  return gate_bf16 ? slots_tc<hp, true>(batch, in_dim, hidden, slots)  \
                   : slots_tc<hp, false>(batch, in_dim, hidden, slots)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_SLOTS)
#undef DMT_SLOTS
}

}  // extern "C"
