// The tensor-core LSTM layer for Hopper (sm_90a): the bf16 mode of K5a
// (bilstm_mono_merged.cu) and of K4 (bilstm_layer.cu) run one lane of one
// layer over a 64-window tile through run_layer below; the bf16 modes of
// K1 (bilstm_fused.cu: two chains a step, x then h), K5b
// (bilstm_mono_pregemm.cu) and K5c (bilstm_mono_wavefront.cu) build their
// own step loops from the same pieces.
//
// Numerics: K1's bf16 contract (lstm_common.cuh::cell<true>, unchanged):
// bf16 x, weights and stored h; fp32 accumulation (the tensor cores' fp32
// accumulator) and fp32 c; i/f/o columns pre-halved by the wrapper,
// sigmoid as 0.5*tanhf+0.5, 0.5*forget_bias added in the original
// association; the readout row rounded through bf16.
//
// Design:
//   block: 256 threads, two consumer warpgroups; 64 windows (the wgmma M)
//     of one lane. Each step is ONE product [h_{t-1}; x_t] @ [Wh; Wx] of
//     64 x Kp by Kp x 4Hp: each warpgroup issues a chain of Kp/16
//     m64n(2Hp)k16 wgmma over its half of the gate columns, A and B read
//     from shared memory, the sum in registers.
//   padding: H -> Hp, a multiple of 8, with zero weight columns and zero
//     bias, so a padded unit's h is exactly 0 (i = 0.5, j = tanh 0 = 0, c
//     stays 0). K = Hp + 8*ceil(in/8), zero-padded to a multiple of 16.
//   gate permutation (ops/bilstm_fused.py::tc_gate_columns): warpgroup w
//     owns units w*Hp/2 .. w*Hp/2+Hp/2-1; per 4 units an 8-column chunk of
//     (i, j) pairs, then one of (f, o) pairs. A thread's accumulator
//     fragment (d[4c..4c+1] row g cols 8c+2q, 8c+2q+1; d[4c+2..4c+3] row
//     g+8) then holds all four gates of unit w*Hp/2+4p+q for rows g and
//     g+8 in acc[8p..8p+7], and the cell runs in registers: no shuffle, no
//     shared-memory round trip.
//   shared memory, every operand K-major in 8-wide core columns without
//     swizzle: a core column is 64 rows x 8 bf16, row-major (1 KB; eight
//     core matrices of 8 rows x 16 B, 128 B apart). A = [h_{t-1}; x_t;
//     zero] is a list of core columns from three buffers (h ring of 2, x
//     ring of 2, one zero column), in that address order, so a k-tile's
//     second column lies at a positive offset from its first (the
//     descriptor's leading byte offset) even where it straddles two
//     buffers. B (the layer's weights, [kc][n][8]) is loaded once a layer
//     and stays: 208 x 416 x 2 B = 173,056 B at H=100 after layer 0.
//   a step: the wgmma chain; while it runs, h_{t-1} is copied to the
//     output sequence (16-byte stores of the ring slot) and x_{t+1} is
//     prefetched (cp.async from a blocked sequence, or register loads
//     through the caller's strides at layer 0); wait; bias + cell; h_t
//     written into the other ring slot; fence.proxy.async; one barrier.
//     The rings make that one barrier enough: no slot is written in the
//     step that reads it.
//   the blocked sequence (inter-layer rows): per (lane, step, tile) one
//     64 x Hp block in the A-column layout, so a row is one contiguous
//     copy in and out.
//
// Hp 112-128 (hidden 105-128, up to the JAX fused kernels' LANE = 128):
// a layer's weights after the first are 16 Hp^2 = 262,144 B at Hp = 128,
// more than one block's 232,448 B. The layer-lane is then split by units
// over a 2-CTA thread-block cluster (kSplit = 2): CTA r holds exactly the
// gate columns of warpgroup r above (Kp x 2Hp, 131,072 B at Hp = 128; the
// packing is unchanged), runs ONE warpgroup (128 threads) with the
// m64n(2Hp)k16 chain over the full [h_{t-1}; x_t] and the cell of its
// Hp/2 units, and writes each h value into its own h ring and into the
// peer's, through distributed shared memory. One cluster barrier
// (barrier.cluster arrive.release / wait.acquire) ends the step; the
// two-slot rings keep the one-barrier argument above across the pair,
// since a CTA writes the peer's slot t&1 in the step in which both read
// slot (t-1)&1. Why this and not Wx streamed by TMA with Wh resident: the
// split keeps the packing, the step and its one barrier as they are and
// halves each SM's chain, at the cost of a second SM a tile.
//
// What bounds it on an H100: the cell's tanhf (5 a unit and window, about
// 3 us a step per SM at P1's measured rate) before the product (11 MFLOP a
// step at Hp=104, ~1.5 us at the tensor cores' peak). Left for later: two
// tiles a block in ping-pong, so one tile's product hides under the
// other's cell.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "lstm_common.cuh"

namespace dmt {
namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // windows a block: the wgmma M
constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kColBytes = kRows * 8 * 2;  // one core column
// largest padded hidden size: the JAX fused kernels' LANE (128)
constexpr int kMaxHp = 128;
// largest Hp whose layer weights after the first (16 Hp^2 bytes) and rings
// fit the 227 KB of one block; wider layers split over a 2-CTA cluster
constexpr int kMaxHpOneBlock = 104;

__host__ __device__ constexpr int padded_hidden(int hidden) {
  return (hidden + 7) / 8 * 8;
}
// CTAs that share one layer-lane's gate columns (split by units)
__host__ __device__ constexpr int split_of(int hp) {
  return hp > kMaxHpOneBlock ? 2 : 1;
}
// threads a CTA of a split: one warpgroup for each gate-column half it owns
__host__ __device__ constexpr int threads_of(int split) {
  return kThreads / split;
}
// core columns of the layer input, and k-tiles of [h; x] (16 wide)
__host__ __device__ constexpr int x_cols(int in_dim) { return (in_dim + 7) / 8; }
__host__ __device__ constexpr int k_tiles(int hp, int in_dim) {
  return (hp / 8 + x_cols(in_dim) + 1) / 2;
}
// bytes of one lane's layer weights: Kp x 4Hp bf16
__host__ __device__ inline size_t weight_bytes(int hp, int in_dim) {
  return static_cast<size_t>(k_tiles(hp, in_dim)) * 16 * 4 * hp * 2;
}
// the block's shared memory: h ring, x ring, zero column, weights, bias
__host__ __device__ inline size_t smem_bytes(int hp, int nx_max,
                                             size_t w_bytes) {
  return 2 * static_cast<size_t>(hp / 8) * kColBytes +
         2 * static_cast<size_t>(nx_max) * kColBytes + kColBytes + w_bytes +
         16 * static_cast<size_t>(hp);
}

struct Smem {
  unsigned char* h;  // 2 slots of hp/8 columns
  unsigned char* x;  // 2 slots of nx_max columns
  unsigned char* zero;
  unsigned char* w;
  float4* bias;  // (i, j, f, o) of each padded unit
  int h_slot, x_slot;  // bytes a slot
};

__device__ inline Smem carve(unsigned char* base, int hp, int nx_max,
                             size_t w_bytes) {
  Smem s;
  s.h_slot = hp / 8 * kColBytes;
  s.x_slot = nx_max * kColBytes;
  s.h = base;
  s.x = s.h + 2 * s.h_slot;
  s.zero = s.x + 2 * s.x_slot;
  s.w = s.zero + kColBytes;
  s.bias = reinterpret_cast<float4*>(s.w + w_bytes);
  return s;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (the next core matrix along K) and stride byte offset (the next 8
// rows along M or N), each in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the same for writes into any shared memory of the cluster (this thread's
// stores into a peer CTA's rings through distributed shared memory)
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the cluster barrier in two halves (lstm_f32.cuh ends a step so, with the
// global stores of the step between them): every thread's shared-memory
// writes before the arrive, remote ones included, are seen by every thread
// of the cluster after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the barrier that ends a step: the block's, or the whole cluster's
// (barrier.cluster.arrive.release + wait.acquire: every CTA's shared-memory
// writes before it, remote ones included, are seen by every CTA after it)
template <bool kCluster>
__device__ __forceinline__ void step_barrier() {
  if constexpr (kCluster) {
    fence_async_all();
    cg::this_cluster().sync();
  } else {
    fence_async_smem();
    __syncthreads();
  }
}

// wgmma.m64nNk16.f32.bf16.bf16 with both operands in shared memory (K-major,
// no transpose); d holds N/2 fp32 a thread; scale_d == 0 overwrites d
#define DMT_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DMT_ACC_16 DMT_ACC8(0)
#define DMT_ACC_32 DMT_ACC_16, DMT_ACC8(8)
#define DMT_ACC_48 DMT_ACC_32, DMT_ACC8(16)
#define DMT_ACC_64 DMT_ACC_48, DMT_ACC8(24)
#define DMT_ACC_80 DMT_ACC_64, DMT_ACC8(32)
#define DMT_ACC_96 DMT_ACC_80, DMT_ACC8(40)
#define DMT_ACC_112 DMT_ACC_96, DMT_ACC8(48)
#define DMT_ACC_128 DMT_ACC_112, DMT_ACC8(56)
#define DMT_ACC_144 DMT_ACC_128, DMT_ACC8(64)
#define DMT_ACC_160 DMT_ACC_144, DMT_ACC8(72)
#define DMT_ACC_176 DMT_ACC_160, DMT_ACC8(80)
#define DMT_ACC_192 DMT_ACC_176, DMT_ACC8(88)
#define DMT_ACC_208 DMT_ACC_192, DMT_ACC8(96)
#define DMT_ACC_224 DMT_ACC_208, DMT_ACC8(104)
#define DMT_ACC_240 DMT_ACC_224, DMT_ACC8(112)
#define DMT_ACC_256 DMT_ACC_240, DMT_ACC8(120)
#define DMT_REG_16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define DMT_REG_32 DMT_REG_16 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define DMT_REG_48 DMT_REG_32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define DMT_REG_64 DMT_REG_48 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define DMT_REG_80 DMT_REG_64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define DMT_REG_96 DMT_REG_80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define DMT_REG_112 DMT_REG_96 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define DMT_REG_128 DMT_REG_112 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define DMT_REG_144 DMT_REG_128 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define DMT_REG_160 DMT_REG_144 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define DMT_REG_176 DMT_REG_160 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define DMT_REG_192 DMT_REG_176 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define DMT_REG_208 DMT_REG_192 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define DMT_REG_224 \
  DMT_REG_208 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define DMT_REG_240 \
  DMT_REG_224 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define DMT_REG_256 \
  DMT_REG_240 ", %120, %121, %122, %123, %124, %125, %126, %127"
// IA, IB, IS: the operand numbers of desc_a, desc_b and scale_d (N/2 ..)
#define DMT_WGMMA_CASE(N, IA, IB, IS)                                       \
  if constexpr (kN == N) {                                                  \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                   \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"        \
        DMT_REG_##N "}, %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"            \
        : DMT_ACC_##N                                                       \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));                          \
  }

template <int kN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2],
                                           uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  static_assert(kN % 16 == 0 && kN >= 16 && kN <= 2 * kMaxHp,
                "N = 2 Hp, Hp a multiple of 8 up to kMaxHp");
  DMT_WGMMA_CASE(16, 8, 9, 10)
  DMT_WGMMA_CASE(32, 16, 17, 18)
  DMT_WGMMA_CASE(48, 24, 25, 26)
  DMT_WGMMA_CASE(64, 32, 33, 34)
  DMT_WGMMA_CASE(80, 40, 41, 42)
  DMT_WGMMA_CASE(96, 48, 49, 50)
  DMT_WGMMA_CASE(112, 56, 57, 58)
  DMT_WGMMA_CASE(128, 64, 65, 66)
  DMT_WGMMA_CASE(144, 72, 73, 74)
  DMT_WGMMA_CASE(160, 80, 81, 82)
  DMT_WGMMA_CASE(176, 88, 89, 90)
  DMT_WGMMA_CASE(192, 96, 97, 98)
  DMT_WGMMA_CASE(208, 104, 105, 106)
  DMT_WGMMA_CASE(224, 112, 113, 114)
  DMT_WGMMA_CASE(240, 120, 121, 122)
  DMT_WGMMA_CASE(256, 128, 129, 130)
}

#undef DMT_WGMMA_CASE

// One chain: acc (+)= sum over nk k-tiles of A(2j, 2j+1) @ B k-tile j.
// col(c) is the shared address of A's core column c; B is [kc][n][8] from
// w_base with w_lbo bytes between k core columns; scale0 == 0 overwrites
// acc with the first product. Commits; the caller waits.
template <int kN, typename ColFn>
__device__ __forceinline__ void chain(float (&acc)[kN / 2], ColFn col,
                                      uint32_t w_base, uint32_t w_lbo,
                                      int nk, int scale0) {
  fence_acc(acc);
  wgmma_fence();
  for (int j = 0; j < nk; ++j) {
    const uint32_t a0 = col(2 * j);
    const uint32_t a1 = col(2 * j + 1);
    wgmma_bf16<kN>(acc, make_desc(a0, a1 - a0, 128),
                   make_desc(w_base + 2 * j * w_lbo, w_lbo, 128),
                   j > 0 || scale0 != 0);
  }
  wgmma_commit();
}

// ------------------------------------------------------------ one layer

// where a layer reads its inputs and writes its outputs, for this block
struct LayerIO {
  // layer 0: the (B, T, F) windows through the caller's strides, the bw
  // lane reading step in_steps-1-t when `reversed`; otherwise null
  const bf16* x;
  long long sb, st, sf;
  int reversed, in_steps;
  // later layers: the blocked sequence row of step t at seq_in + t*seq_in_t
  const bf16* seq_in;
  long long seq_in_t;
  // every layer but the last: its rows, the same layout; else null
  bf16* seq_out;
  long long seq_out_t;
  // the last layer: (B, 2H) fp32 features, written at step out_step only
  float* out;
  int out_step;
};

struct Layer {
  const bf16* w;      // this lane's [kc][4Hp][8] weights (global)
  const float* bias;  // this lane's (Hp, 4) bias (global)
  int in_dim, hidden, steps, batch, lane;
  long long b0;
  float fb;  // 0.5 * forget_bias
};

// x_t of a layer-0 tile, through the caller's strides: slot s of the
// 64 x 8*nx block (zero past the batch and past in_dim)
__device__ __forceinline__ bf16 window_value(const LayerIO& io, const Layer& L,
                                             int tt, int s, int width) {
  const int row = s / width;
  const int f = s - row * width;
  const long long b = L.b0 + row;
  bf16 v = from_f<bf16>(0.0f);
  if (b < L.batch && f < L.in_dim) {
    v = io.x[b * io.sb + tt * io.st + f * io.sf];
  }
  return v;
}
__device__ __forceinline__ void put_window_value(unsigned char* slot, int s,
                                                 int width, bf16 v) {
  const int row = s / width;
  const int f = s - row * width;
  reinterpret_cast<bf16*>(slot + (f >> 3) * kColBytes)[row * 8 + (f & 7)] = v;
}

constexpr int kXRegs = 4;  // layer-0 values a thread prefetches in registers

// x_{t} into ring slot `slot`: issue (cp.async or register loads) ...
template <int kT>
__device__ __forceinline__ void x_issue(const LayerIO& io, const Layer& L,
                                        int t, unsigned char* slot, int nx,
                                        bf16 (&v)[kXRegs]) {
  const int tid = threadIdx.x;
  if (io.x != nullptr) {
    const int width = 8 * nx;
    const int tt = io.reversed ? io.in_steps - 1 - t : t;
#pragma unroll
    for (int k = 0; k < kXRegs; ++k) {
      const int s = tid + k * kT;
      v[k] = s < kRows * width ? window_value(io, L, tt, s, width)
                               : from_f<bf16>(0.0f);
    }
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(io.seq_in + t * io.seq_in_t);
    const int n16 = nx * kColBytes / 16;
    for (int i = tid; i < n16; i += kT) {
      cp_async16(slot + 16 * i, src + i);
    }
  }
}
// ... and complete it (every thread, before the fence and the barrier)
template <int kT>
__device__ __forceinline__ void x_complete(const LayerIO& io, const Layer& L,
                                           int t, unsigned char* slot, int nx,
                                           const bf16 (&v)[kXRegs]) {
  const int tid = threadIdx.x;
  if (io.x != nullptr) {
    const int width = 8 * nx;
    const int n = kRows * width;
#pragma unroll
    for (int k = 0; k < kXRegs; ++k) {
      const int s = tid + k * kT;
      if (s < n) put_window_value(slot, s, width, v[k]);
    }
    // inputs wider than the registers hold (in_dim > 16) load here
    const int tt = io.reversed ? io.in_steps - 1 - t : t;
    for (int s = tid + kXRegs * kT; s < n; s += kT) {
      put_window_value(slot, s, width, window_value(io, L, tt, s, width));
    }
  } else {
    cp_async_wait_all();
  }
}

// copy the h ring slot (one blocked row, Hp/8 columns) to global memory;
// the `parts` CTAs of a split each copy every parts-th 16-byte piece
template <int kHp, int kT>
__device__ __forceinline__ void store_row(bf16* dst, const unsigned char* slot,
                                          int part = 0, int parts = 1) {
  const uint4* src = reinterpret_cast<const uint4*>(slot);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = part + parts * static_cast<int>(threadIdx.x);
       i < kHp / 8 * kColBytes / 16; i += parts * kT) {
    d[i] = src[i];
  }
}

// cp.async core columns kc0 .. kc0+ncols-1 of a layer-lane's packed
// weights ([kc][4Hp][8] bf16 in global memory) into dst as [kc][n][8],
// taking the n = 4Hp/parts gate columns from part*n on (a CTA's half of
// a split); with `pad` one zeroed core column follows (an odd count's
// k-tile partner). 16-byte pieces: one gate column's 8 k values.
template <int kT>
__device__ __forceinline__ void load_weights(unsigned char* dst,
                                             const bf16* w, int hp, int kc0,
                                             int ncols, int part, int parts,
                                             bool pad) {
  const int n = 4 * hp / parts;
  const uint4* src = reinterpret_cast<const uint4*>(w);
  for (int i = threadIdx.x; i < ncols * n; i += kT) {
    const int kc = i / n;
    cp_async16(dst + 16 * i,
               src + static_cast<long long>(kc0 + kc) * 4 * hp + part * n +
                   (i - kc * n));
  }
  if (pad) {
    uint4* z = reinterpret_cast<uint4*>(dst) + ncols * n;
    for (int i = threadIdx.x; i < n; i += kT) z[i] = make_uint4(0, 0, 0, 0);
  }
}

// bf16 h of unit u for rows row and row + 8 into a ring slot
__device__ __forceinline__ void put_h(unsigned char* slot, int u, int row,
                                      bf16 v0, bf16 v1) {
  bf16* col = reinterpret_cast<bf16*>(slot + (u >> 3) * kColBytes);
  col[row * 8 + (u & 7)] = v0;
  col[(row + 8) * 8 + (u & 7)] = v1;
}

// the cell of a thread's 4-unit group p: gates acc[8p..8p+7] (rows row0
// and row0+8 of unit u) plus the bias; updates c0, c1, returns h in bf16
__device__ __forceinline__ void cell_pair(float a0, float a1, float a2,
                                          float a3, float a4, float a5,
                                          float a6, float a7, float4 bb,
                                          float fb, float& c0, float& c1,
                                          bf16& v0, bf16& v1) {
  v0 = from_f<bf16>(
      cell<true>(a0 + bb.x, a1 + bb.y, a4 + bb.z, a5 + bb.w, fb, c0));
  v1 = from_f<bf16>(
      cell<true>(a2 + bb.x, a3 + bb.y, a6 + bb.z, a7 + bb.w, fb, c1));
}

// One layer of one lane over L.steps steps for the block's 64 windows
// (kSplit = 2: this CTA's half of the units, the peer CTA of the cluster
// holding the other). Starts and ends with every thread at a barrier;
// leaves shared memory free for the next layer.
template <int kHp, int kSplit>
__device__ __forceinline__ void run_layer(const Smem& sm, const Layer& L,
                                          const LayerIO& io) {
  constexpr int kT = threads_of(kSplit);
  constexpr bool kCluster = kSplit > 1;
  constexpr int kN = 2 * kHp;       // gate columns a warpgroup
  constexpr int kGroups = kHp / 8;  // 4-unit groups a warpgroup
  constexpr int kNh = kHp / 8;      // core columns of h
  const int tid = threadIdx.x;
  const int rank = kCluster ? static_cast<int>(cg::this_cluster().block_rank())
                            : 0;
  const int half = kCluster ? rank : tid >> 7;  // tc_gate_columns' warpgroup
  const int row0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int unit0 = half * (kHp / 2) + (tid & 3);  // unit of group p: + 4p
  const int nx = x_cols(L.in_dim);
  const int nc = kNh + nx;  // core columns of [h; x]; one more is zero
  const int nk = k_tiles(kHp, L.in_dim);
  // the peer's h ring (distributed shared memory) in a split
  unsigned char* peer_h =
      kCluster ? cg::this_cluster().map_shared_rank(sm.h, rank ^ 1) : nullptr;

  // prologue: weights and bias of the layer, h_{-1} = 0, the zero column,
  // x_0
  {
    load_weights<kT>(sm.w, L.w, kHp, 0, 2 * nk, rank, kSplit, false);
    const float4* b = reinterpret_cast<const float4*>(L.bias);
    for (int u = tid; u < kHp; u += kT) sm.bias[u] = b[u];
    const uint4 z = make_uint4(0, 0, 0, 0);
    uint4* h1 = reinterpret_cast<uint4*>(sm.h + sm.h_slot);
    for (int i = tid; i < sm.h_slot / 16; i += kT) h1[i] = z;
    for (int i = tid; i < kColBytes / 16; i += kT) {
      reinterpret_cast<uint4*>(sm.zero)[i] = z;
    }
    bf16 v[kXRegs];
    x_issue<kT>(io, L, 0, sm.x, nx, v);
    x_complete<kT>(io, L, 0, sm.x, nx, v);
    cp_async_wait_all();
    step_barrier<kCluster>();
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
  const uint32_t w_base = smem_addr(sm.w) + (kCluster ? 0 : half) * (kN / 8) * 128;
  const uint32_t zero_col = smem_addr(sm.zero);
  const bool readout = io.out != nullptr;

  for (int t = 0; t < L.steps; ++t) {
    const int s = t & 1;
    const uint32_t h_prev = smem_addr(sm.h + (s ^ 1) * sm.h_slot);
    const uint32_t x_cur = smem_addr(sm.x + s * sm.x_slot);

    chain<kN>(
        acc,
        [&](int cc) {
          return cc < kNh  ? h_prev + cc * kColBytes
                 : cc < nc ? x_cur + (cc - kNh) * kColBytes
                           : zero_col;
        },
        w_base, w_lbo, nk, 0);

    // while the tensor cores run: h_{t-1} out, x_{t+1} in
    if (io.seq_out != nullptr && t > 0) {
      store_row<kHp, kT>(io.seq_out + (t - 1) * io.seq_out_t,
                         sm.h + (s ^ 1) * sm.h_slot, rank, kSplit);
    }
    bf16 xv[kXRegs];
    unsigned char* x_next = sm.x + (s ^ 1) * sm.x_slot;
    if (t + 1 < L.steps) x_issue<kT>(io, L, t + 1, x_next, nx, xv);

    wgmma_wait_all();
    fence_acc(acc);

    // the cell: rows row0 and row0+8 of units unit0 + 4p
    unsigned char* h_cur = sm.h + s * sm.h_slot;
    const bool emit = readout && t == io.out_step;
#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      const int u = unit0 + 4 * p;
      bf16 v0 = from_f<bf16>(0.0f), v1 = from_f<bf16>(0.0f);
      if (half * (kHp / 2) + 4 * p < L.hidden) {  // warp-uniform
        cell_pair(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2], acc[8 * p + 3],
                  acc[8 * p + 4], acc[8 * p + 5], acc[8 * p + 6],
                  acc[8 * p + 7], sm.bias[u], L.fb, c[2 * p], c[2 * p + 1],
                  v0, v1);
      }
      put_h(h_cur, u, row0, v0, v1);
      if (kCluster) put_h(peer_h + s * sm.h_slot, u, row0, v0, v1);
      if (emit && u < L.hidden) {
        const long long b = L.b0 + row0;
        float* o = io.out + L.lane * L.hidden + u;
        if (b < L.batch) o[b * 2 * L.hidden] = to_f(v0);
        if (b + 8 < L.batch) o[(b + 8) * 2 * L.hidden] = to_f(v1);
      }
    }

    if (t + 1 < L.steps) x_complete<kT>(io, L, t + 1, x_next, nx, xv);
    step_barrier<kCluster>();
  }

  if (io.seq_out != nullptr) {
    store_row<kHp, kT>(io.seq_out + (L.steps - 1) * io.seq_out_t,
                       sm.h + ((L.steps - 1) & 1) * sm.h_slot, rank, kSplit);
  }
  // the next layer's prologue rewrites this CTA's buffers only; a peer
  // writes into them again after that prologue's cluster barrier
  __syncthreads();
}

// ------------------------------------------------------------ launching

// the launch configuration of a grid in clusters of (cluster, 1, 1) CTAs
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                int cluster)
      : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// how many clusters of `cluster` CTAs of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters
template <typename... Params>
inline cudaError_t cluster_occupancy(void (*kernel)(Params...), int threads,
                                     size_t smem, int cluster,
                                     int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const ClusterLaunch c(dim3(cluster), threads, smem, nullptr, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &c.cfg);
}

// a launch in clusters of (cluster, 1, 1); a cluster shape the card cannot
// place (no cluster fits an SM group) is refused with
// cudaErrorLaunchOutOfResources before the launch, never run another way
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid,
                                  int threads, size_t smem,
                                  cudaStream_t stream, int cluster,
                                  Args... args) {
  int clusters = 0;
  cudaError_t err = cluster_occupancy(kernel, threads, smem, cluster,
                                      &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  const ClusterLaunch c(grid, threads, smem, stream, cluster);
  return cudaLaunchKernelEx(&c.cfg, kernel, static_cast<Params>(args)...);
}

// runtime Hp -> the kernel instantiated for it: F(kHp) for Hp = 8 .. 128
#define DMT_TC_DISPATCH(hp, F)                                         \
  switch (hp) {                                                        \
    case 8: F(8); case 16: F(16); case 24: F(24); case 32: F(32);      \
    case 40: F(40); case 48: F(48); case 56: F(56); case 64: F(64);    \
    case 72: F(72); case 80: F(80); case 88: F(88); case 96: F(96);    \
    case 104: F(104); case 112: F(112); case 120: F(120);              \
    case 128: F(128);                                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);           \
  }

}  // namespace tc
}  // namespace dmt
