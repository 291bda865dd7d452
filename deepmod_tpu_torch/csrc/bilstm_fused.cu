// Whole-stack BiLSTM center features for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// bilstm_fused_center_mono (Pallas body _mono_kernel, with _make_cell,
// _cell_tail and _prescale_ifo). It computes the same function, not the
// same schedule: (B, T, F) windows -> (B, 2H) fp32 [fw; bw] hidden states
// at the center step, for odd T, where every layer of each lane stops at
// step T//2 (the readout cone: the fw and bw stacks never exchange state
// before the final concat, so the center readout depends only on steps
// 0..T//2 of each lane at every depth). The bw lane reads x time-reversed.
// x is read through explicit strides, so the same kernel serves
// materialized windows (stride_b = T*F) and the overlapping window view of
// a (rows, F) feature block (stride_b = F): the window build of the
// compact transfer path is folded into these loads. Two bodies:
//
// fp32, the fp32 core (csrc/lstm_f32.cuh; tensor cores in fp32 would mean
// TF32, which breaks the 2e-5 parity):
//   grid (ceil(B / tile) * split, 2): blockIdx.y is the lane, and one
//     cluster of `split` CTAs (1, 2 or 4) runs all layers of that lane for
//     `tile` windows, T//2+1 steps per layer; each layer's weights resident
//     in shared memory, split by units over the cluster, h exchanged
//     through distributed shared memory, one cluster barrier a step
//     (lstm_f32.cuh's header). Thread (u, g) owns unit u for 8 windows,
//     its four gates and its cell states in registers.
//   the inter-layer rows go to a device-memory workspace from the wrapper,
//     blocked ([H][tile] a row), one row a step, overwritten in place by
//     the next layer: its step t writes row t, which every CTA of the
//     cluster read in step t-1's prefetch, before that step's barrier
//     (K5a bf16's workspace, bilstm_mono_merged.cu).
//   Numerics: sigmoid = 1/(1+expf(-x)), forget_bias added inside the f
//   sigmoid, fp32 weights and sequences, accurate expf/tanhf; each gate one
//   ordered fmaf chain, x rows then h rows, so the result has K5a fp32's
//   bits.
//
// bf16, on the tensor cores (csrc/lstm_tc.cuh's pieces): K1's two-dot
// step, h_{t-1} . Wh and x_t . Wx as two wgmma chains, where K5a
// (bilstm_mono_merged.cu) runs one over [h; x].
//   block: one lane of a 64-window tile (the wgmma M), 256 threads (two
//     warpgroups, each half of the gate columns), all layers; a layer's
//     padded, gate-permuted weights (ops/bilstm_fused.py::tc_pack_layer,
//     K5a's packing: Wh's Hp/8 core columns, then Wx's) resident in
//     shared memory. Inter-layer rows go to a blocked bf16 workspace from
//     the wrapper, as K5a's do.
//   the two chains: the h chain is ceil(Hp/16) k-tiles over Wh's columns
//     (an odd count pairs its last with the zero column); the x chain
//     starts at Wh's last even core column, pairing it with the zero
//     column where Hp/8 is odd (so Wh's odd last column counts in the h
//     chain only), and ends on a second zero column where its count is
//     odd. At Hp 104: 7 h k-tiles, and 7 x k-tiles at layers 1-2 (1 at
//     layer 0, F=7), against K5a's 13 merged. The zero column lies between
//     the h and x rings and the second after the x ring, so every pair's
//     second column is at a positive offset from its first (the
//     descriptor's leading byte offset).
//   a step t: the x chain (scale-d 0) then the h chain into one
//     accumulator; while they run, h_{t-1} out to the workspace and
//     x_{t+1} in (cp.async, or register loads through the caller's strides
//     at layer 0); wait; bias + cell in registers; h_t into the other ring
//     slot; x_{t+1} completed; fence.proxy.async; one barrier. The rings
//     and that one barrier are K5a's (lstm_tc.cuh's header): no slot is
//     written in the step that reads it.
//   no lookahead: issuing step t+1's x chain during step t's cell, so that
//     only the h chain stays on the dependent path, was built and
//     measured on an H100 (clock64 stamps, PERF.md): a wgmma issue holds
//     its warpgroup ~70-100 cycles (the warpgroup arrive before it and the
//     issue itself), so the x chain's 7 issues cost the cell about what
//     they took off the wait, whether issued in two column halves after
//     each half's cell or one k-tile after each 4-unit group's cell; the
//     halves also need an accumulator a half (ptxas serializes every
//     wgmma of a kernel whose wgmma write parts of one array, C7511), and
//     the x ring a barrier more a step. Both ran 8-9% slower than this
//     step; two accumulator sets do not fit beside c in 255 registers at
//     Hp 104, and would meet the same issue cost.
//   Numerics: K1's bf16 contract (lstm_common.cuh::cell<true>): bf16 x,
//     weights and stored h, fp32 accumulation and fp32 c, i/f/o columns
//     pre-halved, sigmoid as 0.5*tanhf+0.5, 0.5*forget_bias added in the
//     original association; the center row rounded through bf16.
//
// What bounds it on an H100: per window 8.92 MFLOP at H=100, F=7, T=21
// against 7-294 bytes of input and 800 of output, so operations, and 33
// dependent steps a lane: fp32 FMAs on the CUDA cores in fp32 (the
// exchange and the cluster barrier on the step's dependent path). On the
// tensor cores a step is the two chains
// (14 k-tiles at Hp 104, one more than K5a's merged 13; 16 = 16 at Hp
// 128) plus the cell's tanhf (5 a unit and window), serially.

#include "lstm_f32.cuh"

namespace {

// ---------------------------------------------- fp32: the fp32 core

// one lane of one tile, every layer, a cluster of kSplit CTAs (each its
// units): lstm_f32.cuh::run_stack
template <int kSplit>
__global__ void __launch_bounds__(dmt::f32::kMaxThreads, 1)
bilstm_center_f32_kernel(const float* __restrict__ x, long long stride_b,
                         long long stride_t, long long stride_f, int batch,
                         int timesteps, int in_dim, int hidden,
                         int num_layers, const float* __restrict__ w,
                         const float* __restrict__ bias, float forget_bias,
                         float* __restrict__ ws, float* __restrict__ out,
                         int tile) {
  dmt::f32::run_stack<kSplit, false>(x, stride_b, stride_t, stride_f, batch,
                                     timesteps, in_dim, hidden, num_layers,
                                     w, bias, forget_bias, ws, out, tile);
}

// ---------------------------------------------- bf16: the tensor cores

namespace tc = dmt::tc;

// K1's shared memory: lstm_tc.cuh's h ring, then a zero column, the x
// ring and a second zero column (the pairs the two chains read: (h last,
// zero), (zero, x first), (x last, zero) lie at positive offsets), then the
// layer's weights and bias
struct K1Smem {
  unsigned char* h;  // 2 slots of hp/8 columns
  unsigned char* zero;
  unsigned char* x;  // 2 slots of nx_max columns
  unsigned char* zero_end;
  unsigned char* w;
  float4* bias;
  int h_slot, x_slot;
};

__host__ __device__ inline size_t k1_smem_bytes(int hp, int nx_max,
                                                size_t w_bytes) {
  return tc::smem_bytes(hp, nx_max, w_bytes) + tc::kColBytes;
}

__device__ inline K1Smem carve_k1(unsigned char* base, int hp, int nx_max,
                                  size_t w_bytes) {
  K1Smem s;
  s.h_slot = hp / 8 * tc::kColBytes;
  s.x_slot = nx_max * tc::kColBytes;
  s.h = base;
  s.zero = s.h + 2 * s.h_slot;
  s.x = s.zero + tc::kColBytes;
  s.zero_end = s.x + 2 * s.x_slot;
  s.w = s.zero_end + tc::kColBytes;
  s.bias = reinterpret_cast<float4*>(s.w + w_bytes);
  return s;
}

// One layer of one lane over L.steps steps for the block's 64 windows
// under K1's two-dot step (the header above); kSplit = 2: this CTA's half
// of the units, the peer CTA of the cluster holding the other. Starts and
// ends with every thread at a barrier.
template <int kHp, int kSplit>
__device__ __forceinline__ void run_layer_k1(const K1Smem& sm,
                                             const tc::Layer& L,
                                             const tc::LayerIO& io) {
  constexpr int kT = tc::threads_of(kSplit);
  constexpr bool kCluster = kSplit > 1;
  constexpr int kN = 2 * kHp;       // gate columns a warpgroup
  constexpr int kGroups = kHp / 8;  // 4-unit groups a warpgroup
  constexpr int kNh = kHp / 8;      // core columns of h
  constexpr int kKh = (kNh + 1) / 2;  // k-tiles of the h chain
  const int tid = threadIdx.x;
  const int rank =
      kCluster ? static_cast<int>(tc::cg::this_cluster().block_rank()) : 0;
  const int half = kCluster ? rank : tid >> 7;  // tc_gate_columns' warpgroup
  const int row0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int unit0 = half * (kHp / 2) + (tid & 3);  // unit of group p: + 4p
  const int nx = tc::x_cols(L.in_dim);
  const int nk_all = tc::k_tiles(kHp, L.in_dim);
  // the x chain starts at Wh's last even core column cb: where Hp/8 is
  // odd, column cb (Wh's last) meets the zero column, so it counts in the
  // h chain only
  const int cb = kNh & ~1;
  const int nkx = (kNh + nx + 1) / 2 - cb / 2;
  unsigned char* peer_h =
      kCluster ? tc::cg::this_cluster().map_shared_rank(sm.h, rank ^ 1)
               : nullptr;

  // prologue: weights and bias of the layer, h_{-1} = 0, the zero
  // columns, x_0
  {
    tc::load_weights<kT>(sm.w, L.w, kHp, 0, 2 * nk_all, rank, kSplit, false);
    const float4* b = reinterpret_cast<const float4*>(L.bias);
    for (int u = tid; u < kHp; u += kT) sm.bias[u] = b[u];
    const uint4 z = make_uint4(0, 0, 0, 0);
    uint4* h1 = reinterpret_cast<uint4*>(sm.h + sm.h_slot);
    for (int i = tid; i < sm.h_slot / 16; i += kT) h1[i] = z;
    for (int i = tid; i < tc::kColBytes / 16; i += kT) {
      reinterpret_cast<uint4*>(sm.zero)[i] = z;
      reinterpret_cast<uint4*>(sm.zero_end)[i] = z;
    }
    __nv_bfloat16 v[tc::kXRegs];
    tc::x_issue<kT>(io, L, 0, sm.x, nx, v);
    tc::x_complete<kT>(io, L, 0, sm.x, nx, v);
    tc::cp_async_wait_all();
    tc::step_barrier<kCluster>();
  }

  float c[2 * kGroups];
#pragma unroll
  for (int i = 0; i < 2 * kGroups; ++i) c[i] = 0.0f;
  float acc[kHp];
#pragma unroll
  for (int i = 0; i < kHp; ++i) acc[i] = 0.0f;

  // this warpgroup's first n core (B is [kc][4Hp/kSplit][8]: the next 8
  // columns 128 B on, the next k core 4Hp/kSplit*16 B on)
  const uint32_t w_lbo = 4 * kHp / kSplit * 16;
  const uint32_t w_base =
      tc::smem_addr(sm.w) + (kCluster ? 0 : half) * (kN / 8) * 128;
  const uint32_t zero = tc::smem_addr(sm.zero);
  const uint32_t zero_end = tc::smem_addr(sm.zero_end);
  const bool readout = io.out != nullptr;

  for (int t = 0; t < L.steps; ++t) {
    const int s = t & 1;
    const uint32_t h_prev = tc::smem_addr(sm.h + (s ^ 1) * sm.h_slot);
    const uint32_t x_cur = tc::smem_addr(sm.x + s * sm.x_slot);

    // the two dots: acc = x_t . Wx, then acc += h_{t-1} . Wh
    tc::chain<kN>(
        acc,
        [&](int p) {
          const int cc = cb + p;
          return cc < kNh        ? zero
                 : cc < kNh + nx ? x_cur + (cc - kNh) * tc::kColBytes
                                 : zero_end;
        },
        w_base + cb * w_lbo, w_lbo, nkx, 0);
    tc::chain<kN>(
        acc,
        [&](int cc) { return cc < kNh ? h_prev + cc * tc::kColBytes : zero; },
        w_base, w_lbo, kKh, 1);

    // while the tensor cores run: h_{t-1} out, x_{t+1} in
    if (io.seq_out != nullptr && t > 0) {
      tc::store_row<kHp, kT>(io.seq_out + (t - 1) * io.seq_out_t,
                             sm.h + (s ^ 1) * sm.h_slot, rank, kSplit);
    }
    __nv_bfloat16 xv[tc::kXRegs];
    unsigned char* x_next = sm.x + (s ^ 1) * sm.x_slot;
    if (t + 1 < L.steps) tc::x_issue<kT>(io, L, t + 1, x_next, nx, xv);

    tc::wgmma_wait_all();
    tc::fence_acc(acc);

    // the cell: rows row0 and row0+8 of units unit0 + 4p
    unsigned char* h_cur = sm.h + s * sm.h_slot;
    const bool emit = readout && t == io.out_step;
#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      const int u = unit0 + 4 * p;
      __nv_bfloat16 v0 = dmt::from_f<__nv_bfloat16>(0.0f);
      __nv_bfloat16 v1 = v0;
      if (half * (kHp / 2) + 4 * p < L.hidden) {  // warp-uniform
        tc::cell_pair(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2],
                      acc[8 * p + 3], acc[8 * p + 4], acc[8 * p + 5],
                      acc[8 * p + 6], acc[8 * p + 7], sm.bias[u], L.fb,
                      c[2 * p], c[2 * p + 1], v0, v1);
      }
      tc::put_h(h_cur, u, row0, v0, v1);
      if constexpr (kCluster) {
        tc::put_h(peer_h + s * sm.h_slot, u, row0, v0, v1);
      }
      if (emit && u < L.hidden) {
        const long long b = L.b0 + row0;
        float* o = io.out + L.lane * L.hidden + u;
        if (b < L.batch) o[b * 2 * L.hidden] = dmt::to_f(v0);
        if (b + 8 < L.batch) o[(b + 8) * 2 * L.hidden] = dmt::to_f(v1);
      }
    }

    if (t + 1 < L.steps) tc::x_complete<kT>(io, L, t + 1, x_next, nx, xv);
    tc::step_barrier<kCluster>();
  }

  if (io.seq_out != nullptr) {
    tc::store_row<kHp, kT>(io.seq_out + (L.steps - 1) * io.seq_out_t,
                           sm.h + ((L.steps - 1) & 1) * sm.h_slot, rank,
                           kSplit);
  }
  // the next layer's prologue rewrites this CTA's buffers only; a peer
  // writes into them again after that prologue's cluster barrier
  __syncthreads();
}

// one lane of one 64-window tile, every layer (Hp > 104: this CTA's half
// of the units, a 2-CTA cluster a tile-lane)
template <int kHp>
__global__ void __launch_bounds__(tc::threads_of(tc::split_of(kHp)), 1)
bilstm_center_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        long long stride_b, long long stride_t,
                        long long stride_f, int batch, int timesteps,
                        int in_dim, int hidden, int num_layers, int nx_max,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, float fb_term,
                        __nv_bfloat16* __restrict__ ws,
                        float* __restrict__ out) {
  constexpr int kSplit = tc::split_of(kHp);
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tile = blockIdx.x / kSplit;
  const size_t w_max =
      tc::weight_bytes(kHp, in_dim > hidden ? in_dim : hidden) / kSplit;
  const K1Smem sm = carve_k1(tc_smem, kHp, nx_max, w_max);
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
    run_layer_k1<kHp, kSplit>(sm, here, io);
    L.w += 2 * lane_w;  // [layer][lane]
    L.bias += 2 * kHp * 4;
  }
}

template <int kHp>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* ws, void* out, void* stream) {
  constexpr int kSplit = tc::split_of(kHp);
  const int widest = in_dim > hidden ? in_dim : hidden;
  const int nx_max = tc::x_cols(widest);
  const size_t smem =
      k1_smem_bytes(kHp, nx_max, tc::weight_bytes(kHp, widest) / kSplit);
  auto kernel = bilstm_center_tc_kernel<kHp>;
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

}  // namespace

extern "C" {

const char* dmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 mode, the fp32 core: x is fp32; w and bias are the f32_pack_layer
// packing of ops/bilstm_fused.py (per [layer][lane] the (in+H, Hp4, 4)
// fp32 weights and the (Hp4, 4) bias); ws is an fp32 workspace of
// ceil(B/tile) * 2 * (T//2+1) * H * tile elements. `split` CTAs a cluster
// (1, 2 or 4), tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256
// threads (else cudaErrorInvalidValue); cudaErrorLaunchOutOfResources
// where no cluster fits. Returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_center_f32(const void* x, long long stride_b,
                          long long stride_t, long long stride_f, int batch,
                          int timesteps, int in_dim, int hidden,
                          int num_layers, const void* w, const void* bias,
                          float forget_bias, void* ws, void* out, int tile,
                          int split, void* stream) {
#define DMT_LAUNCH(s)                                                     \
  return dmt::f32::launch_stack<s>(                                       \
      bilstm_center_f32_kernel<s>, x, stride_b, stride_t, stride_f,        \
      batch, timesteps, in_dim, hidden, num_layers, w, bias,              \
      forget_bias, ws, out, tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// bf16 mode, the tensor-core kernel, 64 windows a block: x is bf16; w and
// bias are the tensor-core packing of ops/bilstm_fused.py (K5a's: per
// [layer][lane] the padded, gate-permuted (Kp, 4Hp) bf16 weights in core
// columns and the (Hp, 4) fp32 bias, i/f/o pre-halved); ws is a bf16
// workspace of ceil(B/64) * 2 * (T//2+1) * 64 * Hp elements;
// half_forget_bias is 0.5 * forget_bias. Hp = hidden rounded up to 8, at
// most 128 (else cudaErrorInvalidValue); Hp 112-128 launch 2-CTA clusters
// (cudaErrorLaunchOutOfResources where none fits)
int dmt_bilstm_center_bf16(const void* x, long long stride_b,
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

}  // extern "C"
