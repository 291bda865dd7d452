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
// fp32 design (K1's thread layout, csrc/bilstm_fused.cu):
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
// in L2 or shared memory at a smaller tile (fp32). In bf16 the product
// runs on the tensor cores and the bound is lstm_tc.cuh's (the cell's
// tanhf); the gate buffer adds 2 x steps x 4Hp x 4 B a window, layer and
// lane of traffic (fp32 gates), 57.6 GB at 262,144 windows, mostly past
// the 50 MB L2.

#include "lstm_tc.cuh"

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
