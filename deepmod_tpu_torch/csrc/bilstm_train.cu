// BiLSTM training kernels for Hopper (sm_90a): the forward that keeps the
// BPTT residuals (K2), the BPTT recurrence (K3) and K3's weight-gradient
// product.
//
// Replaces the TPU kernels deepmod_tpu/ops/bilstm_fused_train.py::
// _run_fwd_layer (Pallas body _fwd_kernel) and ::_run_bwd_layer (Pallas
// body _bwd_kernel, under the custom VJP of bilstm_fused_center_train).
// They compute the same functions, not the same schedule. Sequences are
// laid out (lane, step, window, feature): lane 0 is fw, lane 1 is bw, and
// the bw lane's layer-0 input is already time-reversed by the wrapper.
// For odd T every layer stops after T//2+1 steps (the readout cone); for
// even T all T steps run.
//
// Numerics follow the TPU kernels' contract in both precisions:
//   sigmoid(v) = 0.5*tanhf(0.5*v)+0.5, with forget_bias added whole inside
//   the f sigmoid; fp32 weights, fp32 products and fp32 h/c carries. The
//   storage type T (float, or bf16 in bf16 mode) applies only to what is
//   stored: the layer inputs, the h and c residual sequences and the dh/dx
//   streams. The next layer reads the stored (rounded) h rows, while the
//   recurrence itself carries h in fp32; the backward recomputes the gates
//   from the stored rows. Accurate expf/tanhf (no fast-math).
//
// K2, train_fwd_kernel, on the fp32 core (csrc/lstm_f32.cuh, which K1
//   and K4 fp32 run too): grid (ceil(B / tile) * split, 2), blockIdx.y the
//   lane; a cluster of `split` CTAs (1, 2 or 4: 2 at H=100, 4 at
//   H=105-128; ops/bilstm_fused_train.py::fwd_shape) runs ALL layers of
//   its lane for `tile` windows (one launch for the whole stack, where the
//   TPU launches once per layer). Each layer's [Wx; Wh] stays resident in
//   shared memory for the layer's steps, split by units over the cluster,
//   h exchanged through distributed shared memory, one cluster barrier a
//   step (lstm_f32.cuh's header); thread (u, g) owns unit u for 8 windows,
//   its four gates and its c in registers.
//   The trainer's batch is small (2,048 windows, 2 lanes), so the launch
//   shape is K2's own: at H=100 tile 32 in 2-CTA clusters, 200 threads a
//   CTA, so that batch 2048 needs 128 clusters, two nearly full waves of
//   the 66 the card holds (chip_smoke.py's sweep; PERF.md §6). What the
//   core leaves to its policy is TrainFwd below:
//   - the weights: the prologue of each layer gathers the CTA's units of
//     the TF (in+H, 4H) kernel into the core's [k][U][i,j,f,o] layout
//     with 4-byte cp.async copies (four a unit and row, once a layer and
//     CTA): the weights change on every Adam step, so nothing repacks
//     them on the host;
//   - the cell: the train contract above;
//   - the stores, between the step barrier's arrive and wait: h_t and c_t
//     of every window into the residuals (layers, 2, steps, B, H) in T
//     (consecutive threads on consecutive units), and the stored h_t
//     (rounded to T) as the blocked [H][tile] fp32 row of the workspace
//     that the next layer reads through the core's x ring. The workspace
//     (tiles, 2, steps, H * tile) is overwritten in place by the next
//     layer, as in K1 fp32: its step t writes row t, which every CTA of
//     the cluster read in step t-1's prefetch, before that step's barrier.
//   Layer 0 reads the wrapper's (2, steps, B, F) inputs in T through the
//   core's strided register path.
// K3, one call a layer for both lanes, four kernels on the CUDA cores:
//   0. rows_kernel: the operand rows [x_t; h_{t-1}; 1] in fp32, one dense
//      (steps*B) x (in+H+1) matrix the two products below read;
//   1. the gate pre-activations of every step, [x_t; h_{t-1}] . W + b, as
//      one (steps*B) x (in+H) by (in+H) x 4H product: they depend on the
//      stored rows only, not on the backward carries, so they leave the
//      dependent chain;
//   2. train_bwd_kernel, the recurrence: time runs in reverse with the dh
//      and dc carries in fp32 registers; a step is the cell's backward
//      (da of each unit and window, to shared and global memory) and
//      dh_{t-1} = da_t . Wh^T. A block holds 32 windows of one lane, grid
//      (ceil(B / 32), 2): 128 blocks at batch 2048, one an SM. Wh^T
//      (166,400 B at H=100) is staged once in shared memory, so the step
//      reads no weight from L2; 4 threads share a cell of 8 units x 8
//      windows of the product, a quarter of the gates each, 64 FMAs for
//      every 16 floats read (see train_bwd_kernel). The trade: 32 windows
//      a block fill 128 of 132 SMs at batch 2048 (64 would fill half), and
//      each staged weight feeds 32 windows where the first cut re-read
//      all of W and W^T from L2 every step for 16. Above H = 104 Wh^T no
//      longer fits beside the da buffer and is read from a global copy;
//   3. dx = da . Wx^T, a (steps*B) x 4H by 4H x in product;
//   4. dW = sum over (t, b) of [x_t; h_{t-1}; 1]^T da_t, the (in+H+1) x 4H
//      product whose last row is the bias gradient, in 128 x 128 output
//      tiles of 8 x 8 register patches, split over ordered row ranges so
//      that 2 lanes x tiles x splits fill the card; sum_splits_kernel adds
//      the ranges in order. No atomics: two runs give the same bits.
//   The products are one register-tiled kernel (gemm_kernel) over dense
//   fp32 operands, with an epilogue each.
//
// What bounds them on an H100: at H=100, 3 layers, T=21, F=7 a window
// costs 8.92 MFLOP in K2 and about 26.8 MFLOP in K3 (gate recompute, the
// dh/dx products and the dW product), all fp32 FMAs on the CUDA cores,
// against a few kB of sequence traffic: they are bound by operations
// (67 TFLOP/s fp32), and the 11 dependent steps a layer set the latency
// floor of the recurrences. Tensor cores are out: tf32 or bf16 inputs
// would change the fp32 contract. K2's step follows the FMA instructions
// the busiest SM sub-partition issues (2 of the CTA's 7 warps at tile
// 32); PERF.md holds the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_f32.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_tanh(float v) {
  return 0.5f * tanhf(0.5f * v) + 0.5f;
}

// ------------------------------------------------------------------ K2

namespace f32 = dmt::f32;

// 4 bytes from global into shared memory with no register in between
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   dmt::tc::smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// K2's policy of the fp32 core (lstm_f32.cuh::run_layer; its Infer is
// K1's and K4's): L.w and L.bias are the layer-lane's TF (in+H, 4H) kernel
// and (4H) bias; T is the storage type
template <typename T>
struct TrainFwd {
  T* hs;  // this layer-lane's (steps, B, H) h sequence
  T* cs;  // and its c sequence

  // rows 0 .. in+H-1 of units u0 .. u0+units-1 into dst as [k][units]
  // (i, j, f, o) vectors, gathered from the TF columns g*H + u (a warp's
  // threads on consecutive units: four coalesced reads a row); zeros past
  // the hidden width. The caller waits for the copies.
  __device__ __forceinline__ void weights(float4* dst, const f32::Layer& L,
                                          int u0, int units) const {
    const int hidden = L.hidden;
    const int n = (L.in_dim + hidden) * units;
    float* d = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = i / units;
      const int u = u0 + (i - k * units);
      float* e = d + 4 * i;
      if (u < hidden) {
        const float* src = L.w + static_cast<long long>(k) * 4 * hidden + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) cp_async4(e + g, src + g * hidden);
      } else {
        *reinterpret_cast<float4*>(e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  __device__ __forceinline__ float4 bias(const f32::Layer& L, int u) const {
    if (u >= L.hidden) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* b = L.bias + u;
    return make_float4(b[0], b[L.hidden], b[2 * L.hidden], b[3 * L.hidden]);
  }
  // the train cell (forget_bias added after the f bias, as the TPU kernel
  // does)
  __device__ __forceinline__ float cell_h(float gi, float gj, float gf,
                                          float go, float fb,
                                          float& c) const {
    const float si = sigmoid_tanh(gi);
    const float sj = tanhf(gj);
    const float sf = sigmoid_tanh(gf + fb);
    const float so = sigmoid_tanh(go);
    c = c * sf + si * sj;
    return tanhf(c) * so;
  }
  // unit u's h_t and c_t of windows w0 .. w0+kR-1 of the tile
  template <typename TX>
  __device__ __forceinline__ void stores(const f32::LayerIOT<TX>& io,
                                         const f32::Layer& L, int t, int u,
                                         int w0, const float (&h)[dmt::kR],
                                         const float (&c)[dmt::kR]) const {
    if (io.seq_out != nullptr) {  // the next layer reads the stored h
      float hr[dmt::kR];
#pragma unroll
      for (int r = 0; r < dmt::kR; ++r) hr[r] = to_f(from_f<T>(h[r]));
      f32::store_vec(io.seq_out + t * io.seq_out_t + u * L.tile + w0, hr);
    }
    const long long b0 = L.b0 + w0;
    const long long at =
        (static_cast<long long>(t) * L.batch + b0) * L.hidden + u;
#pragma unroll
    for (int r = 0; r < dmt::kR; ++r) {
      if (b0 + r < L.batch) {
        hs[at + r * L.hidden] = from_f<T>(h[r]);
        cs[at + r * L.hidden] = from_f<T>(c[r]);
      }
    }
  }
};

// one lane of one tile, every layer, a cluster of kSplit CTAs (each its
// units)
template <int kSplit, typename T>
__global__ void __launch_bounds__(dmt::f32::kMaxThreads, 1)
train_fwd_kernel(const T* __restrict__ xin, int batch, int steps, int in_dim,
                 int hidden, int num_layers, const float* __restrict__ w,
                 const float* __restrict__ bias, float forget_bias,
                 T* __restrict__ hs, T* __restrict__ cs,
                 float* __restrict__ ws, int tile) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tile_i = blockIdx.x / kSplit;
  const int widest = in_dim > hidden ? in_dim : hidden;
  const f32::Smem sm = f32::carve(f32_smem, widest, hidden,
                                  f32::units_of(hidden, kSplit), tile);
  // this tile-lane's rows of the workspace: (tiles, 2, steps, H * tile)
  const long long row = static_cast<long long>(hidden) * tile;
  float* rows = ws + (static_cast<long long>(tile_i) * 2 + lane) * steps * row;
  const long long gates = 4 * hidden;
  const long long seq = static_cast<long long>(steps) * batch * hidden;

  f32::Layer L;
  // [lane][layer] TF kernels, flat; bias (2, layers, 4H)
  L.w = w + lane * ((in_dim + hidden) * gates +
                    (num_layers - 1) * 2 * hidden * gates);
  L.bias = bias + lane * num_layers * gates;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.tile = tile;
  L.b0 = static_cast<long long>(tile_i) * tile;
  L.fb = forget_bias;
  for (int layer = 0; layer < num_layers; ++layer) {
    L.in_dim = layer == 0 ? in_dim : hidden;
    f32::LayerIOT<T> io;
    // layer 0: the (2, steps, B, F) inputs, the bw lane already reversed
    io.x = layer == 0 ? xin + lane * steps * static_cast<long long>(batch) *
                                  in_dim
                      : nullptr;
    io.sb = in_dim;
    io.st = static_cast<long long>(batch) * in_dim;
    io.sf = 1;
    io.reversed = 0;
    io.in_steps = steps;
    io.seq_in = rows;
    io.seq_in_t = row;
    io.seq_out = layer == num_layers - 1 ? nullptr : rows;
    io.seq_out_t = row;
    io.out = nullptr;
    io.out_step = -1;
    const long long at = (layer * 2LL + lane) * seq;
    f32::run_layer<kSplit>(sm, L, io, TrainFwd<T>{hs + at, cs + at});
    L.w += (L.in_dim + hidden) * gates;
    L.bias += gates;
  }
}

template <int kSplit, typename T>
int launch_fwd(const void* xin, int batch, int steps, int in_dim, int hidden,
               int num_layers, const void* w, const void* bias,
               float forget_bias, void* hs, void* cs, void* ws, int tile,
               void* stream) {
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % dmt::kR != 0 || threads > f32::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int widest = in_dim > hidden ? in_dim : hidden;
  const size_t smem = f32::smem_bytes(widest, hidden, kSplit, tile);
  auto kernel = train_fwd_kernel<kSplit, T>;
  const dim3 grid((batch + tile - 1) / tile * kSplit, 2);
  const auto* x = static_cast<const T*>(xin);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* h = static_cast<T*>(hs);
  auto* c = static_cast<T*>(cs);
  auto* wsf = static_cast<float*>(ws);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(dmt::tc::launch_cluster(
        kernel, grid, threads, smem, st, kSplit, x, batch, steps, in_dim,
        hidden, num_layers, wf, bf, forget_bias, h, c, wsf, tile));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(x, batch, steps, in_dim, hidden,
                                        num_layers, wf, bf, forget_bias, h,
                                        c, wsf, tile);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int kSplit>
int clusters_fwd(int in_dim, int hidden, int tile, int* n) {
  const int widest = in_dim > hidden ? in_dim : hidden;
  return static_cast<int>(dmt::tc::cluster_occupancy(
      train_fwd_kernel<kSplit, float>, f32::threads_of(hidden, kSplit, tile),
      f32::smem_bytes(widest, hidden, kSplit, tile), kSplit, n));
}

// ------------------------------------------------------------------ K3

// The recurrence's block: kBwdTile windows of one lane, in cells of 8
// units x kBwdR windows, 4 threads a cell: 2 * (H rounded up to 8)
// threads, rounded up to whole warps (256 at H = 128)
constexpr int kBwdTile = 32;
constexpr int kBwdR = 8;
constexpr int kBwdMaxThreads = 256;

__device__ __forceinline__ void load8f(const float* p, float (&v)[kBwdR]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the operand rows [x_t; h_{t-1}; 1; 0 ..] of every sequence row n = t*B +
// b in fp32, (2, steps*B, kp), kp = in+H+1 rounded up to 4 (h_{-1} = 0):
// the gate and dW products then read one dense matrix in 16-byte loads
template <typename T>
__global__ void rows_kernel(const T* __restrict__ x, const T* __restrict__ h,
                            float* __restrict__ out, long long rows,
                            int batch, int in_dim, int hidden, int kp) {
  const long long total = 2 * rows * kp;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / kp;  // lane * rows + n
    const int k = static_cast<int>(i - r * kp);
    const long long n = r % rows;
    float v = 0.0f;
    if (k < in_dim) {
      v = to_f(x[r * in_dim + k]);
    } else if (k < in_dim + hidden) {
      if (n >= batch) v = to_f(h[(r - batch) * hidden + (k - in_dim)]);
    } else if (k == in_dim + hidden) {
      v = 1.0f;  // the bias row of dW
    }
    out[i] = v;
  }
}

// BPTT of one layer, both lanes (blockIdx.y): the gate pre-activations of
// every step come precomputed (the gate product below), so the dependent
// chain a step is the cell's backward and dh_{t-1} = da_t . Wh^T only.
//
// The block's threads: a cell (ug, wg) is 8 units x 8 windows, and 4
// threads share it: lanes c, c+8, c+16, c+24 of one warp (q = lane >> 3),
// so the 8 lanes of a quarter-warp read one row of each shared buffer
// with no bank conflict. The cell's backward: thread q owns units
// ug*8+2q, ug*8+2q+1 for the 8 windows, and writes their da to shared
// memory ([4H][32] fp32) and to global memory. The product: thread q sums
// the gates g = 4i+q of its cell's 8 x 8 outputs (64 FMAs for every 16
// floats read from shared memory), then the 4 threads reduce-scatter
// their partial sums by shuffles, in a fixed order, so that thread q ends
// with dh of its own 2 units x 8 windows: the carry stays in the thread
// that uses it. The first cut gave each thread 2 units x 8 windows of the
// product as well (16 FMAs for 10 floats): its shared-memory reads, not
// its FMAs, set the step time.
//
// Wh^T ([4H][hp8] fp32, hp8 = H rounded up to 8, zero past H) sits in
// shared memory when kWhShared (H <= 104 beside the da buffer), else it
// is read from the wrapper's global copy `wht`. Windows past the batch
// and units past H load zeros, so their da is exactly 0 and no branch
// guards the cell.
template <typename T, bool kWhShared>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
train_bwd_kernel(const float* __restrict__ gates, const T* __restrict__ cs,
                 const T* __restrict__ dh_in, const float* __restrict__ w,
                 const float* __restrict__ wht, float forget_bias,
                 float* __restrict__ da, int batch, int steps, int in_dim,
                 int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kBwdTile;
  const int n_gates = 4 * hidden;
  const int hp8 = (hidden + 7) / 8 * 8;
  float* das = reinterpret_cast<float*>(smem_raw);  // [4H][kBwdTile]
  const int q = (threadIdx.x >> 3) & 3;
  const int cell = (threadIdx.x >> 5) * 8 + (threadIdx.x & 7);
  const int wg = cell & 3;   // windows wg*8 ..
  const int ug = cell >> 2;  // units ug*8 ..
  const bool live = ug * 8 < hp8;  // the last warp's spare cells idle
  const int w0 = wg * kBwdR;
  const int u0 = ug * 8 + 2 * q;  // this lane's units in the cell's backward

  const float* wh;  // this lane's Wh^T, [4H][hp8]
  if constexpr (kWhShared) {
    float* whs = das + static_cast<size_t>(n_gates) * kBwdTile;
    // Wh: rows in_dim .. in_dim+H-1 of the (in+H, 4H) kernel; read along
    // the gates (coalesced), written transposed
    const float* wl = w + static_cast<size_t>(lane) * (in_dim + hidden) *
                              n_gates +
                      static_cast<size_t>(in_dim) * n_gates;
    for (int i = threadIdx.x; i < hp8 * n_gates; i += blockDim.x) {
      const int u = i / n_gates;
      const int g = i - u * n_gates;
      whs[static_cast<size_t>(g) * hp8 + u] =
          u < hidden ? wl[static_cast<size_t>(u) * n_gates + g] : 0.0f;
    }
    wh = whs;
  } else {
    wh = wht + static_cast<size_t>(lane) * n_gates * hp8;
  }

  const size_t seq = static_cast<size_t>(steps) * batch;
  const float* gl = gates + lane * seq * n_gates;
  const T* cl = cs + lane * seq * hidden;
  const T* dhl = dh_in + lane * seq * hidden;
  float* dal = da + lane * seq * n_gates;
  float dh_c[2][kBwdR], dc_c[2][kBwdR];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int r = 0; r < kBwdR; ++r) {
      dh_c[k][r] = 0.0f;
      dc_c[k][r] = 0.0f;
    }
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int u = u0 + k;
      const bool real = u < hidden;
      const int uc = real ? u : 0;  // a valid address for the spare units
      float gv[4][kBwdR], c_t[kBwdR], c_p[kBwdR], dv[kBwdR];
#pragma unroll
      for (int r = 0; r < kBwdR; ++r) {
        const long long b = b0 + w0 + r;
        const bool valid = real && b < batch;
        const size_t row = static_cast<size_t>(t) * batch + (valid ? b : 0);
        const float* gr = gl + row * n_gates + uc;
#pragma unroll
        for (int g = 0; g < 4; ++g) gv[g][r] = valid ? gr[g * hidden] : 0.0f;
        const size_t off = row * hidden + uc;
        c_t[r] = valid ? to_f(cl[off]) : 0.0f;
        c_p[r] = valid && t > 0
                     ? to_f(cl[off - static_cast<size_t>(batch) * hidden])
                     : 0.0f;
        dv[r] = valid ? to_f(dhl[off]) : 0.0f;
      }
      float dav[4][kBwdR];
#pragma unroll
      for (int r = 0; r < kBwdR; ++r) {
        const float ig = sigmoid_tanh(gv[0][r]);
        const float jg = tanhf(gv[1][r]);
        const float fg = sigmoid_tanh(gv[2][r] + forget_bias);
        const float og = sigmoid_tanh(gv[3][r]);
        const float dh_total = dv[r] + dh_c[k][r];
        const float tanh_c = tanhf(c_t[r]);
        const float d_o = dh_total * tanh_c;
        const float dc =
            dc_c[k][r] + dh_total * og * (1.0f - tanh_c * tanh_c);
        dc_c[k][r] = dc * fg;
        dav[0][r] = dc * jg * ig * (1.0f - ig);
        dav[1][r] = dc * ig * (1.0f - jg * jg);
        dav[2][r] = dc * c_p[r] * fg * (1.0f - fg);
        dav[3][r] = d_o * og * (1.0f - og);
      }
      if (real) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float4* d = reinterpret_cast<float4*>(
              das + static_cast<size_t>(g * hidden + u) * kBwdTile + w0);
          d[0] = make_float4(dav[g][0], dav[g][1], dav[g][2], dav[g][3]);
          d[1] = make_float4(dav[g][4], dav[g][5], dav[g][6], dav[g][7]);
        }
#pragma unroll
        for (int r = 0; r < kBwdR; ++r) {
          const long long b = b0 + w0 + r;
          if (b < batch) {
            float* dst =
                dal + (static_cast<size_t>(t) * batch + b) * n_gates + u;
#pragma unroll
            for (int g = 0; g < 4; ++g) dst[g * hidden] = dav[g][r];
          }
        }
      }
    }
    __syncthreads();

    // this lane's quarter of the gates for the cell's 8 units x 8 windows
    float acc[8][kBwdR];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < kBwdR; ++r) acc[i][r] = 0.0f;
    if (live) {
#pragma unroll 2
      for (int g = q; g < n_gates; g += 4) {
        float dvv[kBwdR], wv[8];
        load8f(das + static_cast<size_t>(g) * kBwdTile + w0, dvv);
        load8f(wh + static_cast<size_t>(g) * hp8 + ug * 8, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < kBwdR; ++r)
            acc[i][r] = fmaf(wv[i], dvv[r], acc[i][r]);
      }
    }
    // reduce-scatter over the 4 threads of the cell: thread q keeps units
    // 4*(q>>1) .. +3 after the first exchange, then 2q, 2q+1
    const int h1 = q >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < kBwdR; ++r) {
        const float keep = h1 ? acc[i + 4][r] : acc[i][r];
        const float give = h1 ? acc[i][r] : acc[i + 4][r];
        acc[i][r] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
      }
    const int h2 = q & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < kBwdR; ++r) {
        const float keep = h2 ? acc[i + 2][r] : acc[i][r];
        const float give = h2 ? acc[i][r] : acc[i + 2][r];
        dh_c[i][r] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
      }
    // the next step overwrites da
    __syncthreads();
  }
}

// ------------------------------------------- K3's products (CUDA cores)
//
// C = A B tiled for the CUDA cores: a block of 256 threads owns a kBM x
// kBN output tile, each thread a kTM x kTN register patch (8 x 8 for the
// gate and dW products: 16 shared-memory floats feed 64 FMAs). 4H = 400
// columns take four 128-wide tiles, 512 computed: on an H100, 128 x 80
// tiles (8 x 5 patches, scalar B loads) and 128 x 64 tiles (8 x 4) that
// compute fewer spare columns measured 15-40% slower. A and B are
// dense fp32 matrices read in 16-byte loads, through shared memory in
// chunks of kBK = 8 of the sum index, double buffered: the next chunk's
// loads are issued into registers before the current chunk's FMAs and
// stored after them, so one barrier a chunk separates the two buffers.
// Every output is one thread's fmaf chain over its sum range in index
// order; the dW product splits the steps*B rows into `splits` ordered
// ranges (blockIdx.z = lane * splits + split) that sum_splits_kernel adds
// in order: no atomics, the same bits every run. At most 128 registers a
// thread, so two blocks share an SM.
constexpr int kGemmThreads = 256;
constexpr int kBK = 8;

// a dense fp32 operand: element (r, c) of lane l at p[l * lane_stride + r
// * ld + c], c running along memory; ld, lane_stride and cols multiples
// of 4
struct Mat {
  const float* p;
  long long lane_stride, ld, rows, cols;
};

// 4 consecutive elements of row r from column c, zero at r >= rlim or c
// >= clim
__device__ __forceinline__ float4 ld4(const Mat& x, int lane, long long r,
                                      long long c, long long rlim,
                                      long long clim) {
  if (r < rlim && c < clim) {
    return *reinterpret_cast<const float4*>(x.p + lane * x.lane_stride +
                                            r * x.ld + c);
  }
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the position of value i of thread t's patch along a tile of kB: with 8
// values, two runs of 4 half a tile apart (conflict-free 16-byte loads)
template <int kT, int kB>
__device__ __forceinline__ int patch(int t, int i) {
  if constexpr (kT == 8) {
    return t * 4 + (i & 3) + (i >> 2) * (kB / 2);
  } else {
    return t * kT + i;
  }
}

template <int kT, int kB>
__device__ __forceinline__ void frag(const float* row, int t,
                                     float (&v)[kT]) {
  if constexpr (kT == 8) {
    const float4 p = *reinterpret_cast<const float4*>(row + t * 4);
    const float4 q = *reinterpret_cast<const float4*>(row + kB / 2 + t * 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else if constexpr (kT == 4) {
    const float4 p = *reinterpret_cast<const float4*>(row + t * 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
  } else {
#pragma unroll
    for (int i = 0; i < kT; ++i) v[i] = row[t * kT + i];
  }
}

__device__ __forceinline__ void put4_t(float* col0, int stride, float4 v) {
  col0[0] = v.x;
  col0[stride] = v.y;
  col0[2 * stride] = v.z;
  col0[3 * stride] = v.w;
}

// A (M x K): kAK, stored M rows x K columns (along k), else K rows x M
// columns (along m); B (K x N): kBKc, stored N rows x K columns, else K
// rows x N columns. Epi::put(lane, split, m, n, value) writes an output.
template <int kBM, int kBN, int kTM, int kTN, bool kAK, bool kBKc,
          typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_kernel(Mat a, Mat b, Epi epi, long long n_m, int n_n, long long k_len,
            long long per_split, int splits) {
  constexpr int kTx = kBN / kTN;
  static_assert((kBM / kTM) * kTx == kGemmThreads, "one patch a thread");
  constexpr int kFA = (2 * kBM + kGemmThreads - 1) / kGemmThreads;
  constexpr int kFB = (2 * kBN + kGemmThreads - 1) / kGemmThreads;
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int lane = blockIdx.z / splits;
  const int split = blockIdx.z - lane * splits;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long lo = split * per_split;
  const long long hi = lo + per_split < k_len ? lo + per_split : k_len;
  const int tid = threadIdx.x;
  const int ty = tid / kTx;
  const int tx = tid - ty * kTx;
  float4 ra[kFA], rb[kFB];

  auto fetch = [&](long long k0) {
#pragma unroll
    for (int j = 0; j < kFA; ++j) {
      const int e = tid + j * kGemmThreads;
      if (e < 2 * kBM) {
        if constexpr (kAK) {
          ra[j] = ld4(a, lane, m0 + (e >> 1), k0 + (e & 1) * 4, n_m,
                      hi < a.cols ? hi : a.cols);
        } else {
          ra[j] = ld4(a, lane, k0 + e / (kBM / 4), m0 + e % (kBM / 4) * 4,
                      hi < a.rows ? hi : a.rows, a.cols);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFB; ++j) {
      const int e = tid + j * kGemmThreads;
      if (e < 2 * kBN) {
        if constexpr (kBKc) {
          rb[j] = ld4(b, lane, n0 + (e >> 1), k0 + (e & 1) * 4, b.rows,
                      hi < b.cols ? hi : b.cols);
        } else {
          rb[j] = ld4(b, lane, k0 + e / (kBN / 4), n0 + e % (kBN / 4) * 4,
                      hi < b.rows ? hi : b.rows, b.cols);
        }
      }
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kFA; ++j) {
      const int e = tid + j * kGemmThreads;
      if (e < 2 * kBM) {
        if constexpr (kAK) {
          put4_t(&As[buf][(e & 1) * 4][e >> 1], kBM, ra[j]);
        } else {
          *reinterpret_cast<float4*>(
              &As[buf][e / (kBM / 4)][e % (kBM / 4) * 4]) = ra[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFB; ++j) {
      const int e = tid + j * kGemmThreads;
      if (e < 2 * kBN) {
        if constexpr (kBKc) {
          put4_t(&Bs[buf][(e & 1) * 4][e >> 1], kBN, rb[j]);
        } else {
          *reinterpret_cast<float4*>(
              &Bs[buf][e / (kBN / 4)][e % (kBN / 4) * 4]) = rb[j];
        }
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  if (lo < hi) {
    fetch(lo);
    put(0);
    __syncthreads();
    int buf = 0;
    for (long long k0 = lo; k0 < hi; k0 += kBK) {
      const bool more = k0 + kBK < hi;
      if (more) fetch(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM], bv[kTN];
        frag<kTM, kBM>(&As[buf][kk][0], ty, av);
        frag<kTN, kBN>(&Bs[buf][kk][0], tx, bv);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) put(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + patch<kTM, kBM>(ty, i);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + patch<kTN, kBN>(tx, j);
      if (m < n_m && n < n_n) epi.put(lane, split, m, n, acc[i][j]);
    }
  }
}

// the gate pre-activations, (2, steps*B, 4H): the product plus the bias.
// (Their nonlinearities stay in the recurrence: applied here, in the
// product's epilogue, they cost the product more than they saved the
// recurrence on an H100.)
struct GatesEpi {
  float* out;
  const float* bias;  // (2, 4H)
  long long rows;
  int n_gates;
  __device__ void put(int lane, int, long long m, int n, float v) const {
    out[(lane * rows + m) * n_gates + n] = v + bias[lane * n_gates + n];
  }
};

// dx (2, steps*B, in) in the storage type
template <typename T>
struct DxEpi {
  T* dx;
  long long rows;
  int in_dim;
  __device__ void put(int lane, int, long long m, int n, float v) const {
    dx[(lane * rows + m) * in_dim + n] = from_f<T>(v);
  }
};

// a split's dW partial, (splits, 2, in+H+1, 4H)
struct DwEpi {
  float* out;
  long long m_all;
  int n_gates;
  __device__ void put(int lane, int split, long long m, int n,
                      float v) const {
    out[((static_cast<long long>(split) * 2 + lane) * m_all + m) * n_gates +
        n] = v;
  }
};

// dw[i] = sum over s = 0 .. splits-1 of partial[s][i], in that order
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, int n_out,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) {
    sum += partial[static_cast<size_t>(s) * n_out + i];
  }
  dw[i] = sum;
}

template <int kBM, int kBN, int kTM, int kTN, bool kAK, bool kBKc,
          typename Epi>
cudaError_t launch_gemm(const Mat& a, const Mat& b, const Epi& epi,
                        long long n_m, int n_n, long long k_len,
                        long long per_split, int splits, cudaStream_t s) {
  const dim3 grid((n_n + kBN - 1) / kBN,
                  static_cast<unsigned>((n_m + kBM - 1) / kBM), 2 * splits);
  gemm_kernel<kBM, kBN, kTM, kTN, kAK, kBKc, Epi>
      <<<grid, kGemmThreads, 0, s>>>(a, b, epi, n_m, n_n, k_len, per_split,
                                     splits);
  return cudaGetLastError();
}

// the rows of a dW split: steps*B over `splits`, rounded up to kBK
inline long long dw_rows_per_split(long long rows, int splits) {
  const long long per = (rows + splits - 1) / splits;
  return (per + kBK - 1) / kBK * kBK;
}

template <typename T>
int launch_bwd(const void* xin, const void* hs, const void* cs,
               const void* dh, const void* w, const void* wht,
               const void* bias, float forget_bias, void* dx, void* rows_buf,
               void* gates, void* da, void* dw, void* partial, int splits,
               int batch, int steps, int in_dim, int hidden, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(steps) * batch;
  const int n_gates = 4 * hidden;
  const int kp = (in_dim + hidden + 1 + 3) / 4 * 4;
  const auto* wf = static_cast<const float*>(w);
  auto* rows_f = static_cast<float*>(rows_buf);
  auto* gates_f = static_cast<float*>(gates);
  auto* da_f = static_cast<float*>(da);
  const long long w_lane = static_cast<long long>(in_dim + hidden) * n_gates;

  // 0. [x_t; h_{t-1}; 1] in fp32
  {
    const long long total = 2 * rows * kp;
    const long long blocks = (total + 255) / 256;
    rows_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, s>>>(static_cast<const T*>(xin),
                                  static_cast<const T*>(hs), rows_f, rows,
                                  batch, in_dim, hidden, kp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mat rows_m{rows_f, rows * kp, kp, rows, kp};
  const Mat da_m{da_f, rows * n_gates, n_gates, rows, n_gates};

  // 1. every step's gate pre-activations (independent of the carries)
  err = launch_gemm<128, 128, 8, 8, true, false>(
      rows_m, Mat{wf, w_lane, n_gates, in_dim + hidden, n_gates},
      GatesEpi{gates_f, static_cast<const float*>(bias), rows, n_gates},
      rows, n_gates, kp, kp, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. the recurrence
  const int hp8 = (hidden + 7) / 8 * 8;
  const bool shared = wht == nullptr;
  const size_t smem =
      static_cast<size_t>(n_gates) * kBwdTile * sizeof(float) +
      (shared ? static_cast<size_t>(n_gates) * hp8 * sizeof(float) : 0);
  auto kernel = shared ? train_bwd_kernel<T, true> : train_bwd_kernel<T, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((batch + kBwdTile - 1) / kBwdTile, 2),
           dim3((2 * hp8 + 31) / 32 * 32), smem, s>>>(
      gates_f, static_cast<const T*>(cs), static_cast<const T*>(dh), wf,
      static_cast<const float*>(wht), forget_bias, da_f, batch, steps,
      in_dim, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. dx = da . Wx^T (Wx: the first in_dim rows of W, along the gates)
  const Mat wx{wf, w_lane, n_gates, in_dim, n_gates};
  const DxEpi<T> dx_epi{static_cast<T*>(dx), rows, in_dim};
  err = in_dim <= 16
            ? launch_gemm<128, 16, 8, 1, true, true>(da_m, wx, dx_epi, rows,
                                                     in_dim, n_gates, n_gates,
                                                     1, s)
            : launch_gemm<128, 64, 8, 4, true, true>(da_m, wx, dx_epi, rows,
                                                     in_dim, n_gates, n_gates,
                                                     1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4. dW and db: [x; h; 1]^T da split over ordered row ranges, then
  // summed in order
  const int m_all = in_dim + hidden + 1;
  float* dw_out = static_cast<float*>(splits > 1 ? partial : dw);
  err = launch_gemm<128, 128, 8, 8, false, false>(
      rows_m, da_m, DwEpi{dw_out, m_all, n_gates}, m_all, n_gates, rows,
      dw_rows_per_split(rows, splits), splits, s);
  if (splits == 1 || err != cudaSuccess) return static_cast<int>(err);
  const int n_out = 2 * m_all * n_gates;
  sum_splits_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(
      dw_out, static_cast<float*>(dw), n_out, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2: xin (2, steps, B, in) in the storage type; w the fp32 TF kernels of
// every [lane][layer], flat; bias (2, layers, 4H) fp32; hs, cs (layers, 2,
// steps, B, H) in the storage type; ws the fp32 workspace (ceil(B/tile),
// 2, steps, H * tile) when layers > 1. `split` CTAs a cluster (1, 2 or
// 4), tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256 threads
// (else cudaErrorInvalidValue); cudaErrorLaunchOutOfResources where no
// cluster fits. Returns the launch's error (0 = success).
int dmt_bilstm_train_fwd_f32(const void* xin, int batch, int steps,
                             int in_dim, int hidden, int num_layers,
                             const void* w, const void* bias,
                             float forget_bias, void* hs, void* cs, void* ws,
                             int tile, int split, void* stream) {
#define DMT_LAUNCH(s)                                                       \
  return launch_fwd<s, float>(xin, batch, steps, in_dim, hidden,           \
                              num_layers, w, bias, forget_bias, hs, cs, ws, \
                              tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

int dmt_bilstm_train_fwd_bf16(const void* xin, int batch, int steps,
                              int in_dim, int hidden, int num_layers,
                              const void* w, const void* bias,
                              float forget_bias, void* hs, void* cs, void* ws,
                              int tile, int split, void* stream) {
#define DMT_LAUNCH(s)                                                   \
  return launch_fwd<s, __nv_bfloat16>(xin, batch, steps, in_dim, hidden, \
                                      num_layers, w, bias, forget_bias,  \
                                      hs, cs, ws, tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of K2 at this shape (a cluster of
// `split` CTAs), into *n
int dmt_bilstm_train_fwd_clusters(int in_dim, int hidden, int tile,
                                  int split, int* n) {
#define DMT_CLUSTERS(s) return clusters_fwd<s>(in_dim, hidden, tile, n)
  DMT_F32_DISPATCH(split, DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

// K3 for one layer, both lanes: xin (2, steps, B, in), hs, cs, dh (2,
// steps, B, H) in the storage type; w (2, in+H, 4H), bias (2, 4H) fp32;
// wht null when H <= 104 (Wh^T staged in shared memory), else Wh^T as (2,
// 4H, H rounded up to 8) fp32, zero-padded. Writes dx (2, steps, B, in)
// in the storage type, the scratch rows (2, steps*B, in+H+1 rounded up to
// 4) fp32, gates and da (2, steps, B, 4H) fp32 and dw (2, in+H+1, 4H)
// fp32 (last row: the bias gradient). The dW product sums `splits`
// ordered ranges of the steps*B rows into the scratch partial (splits, 2,
// in+H+1, 4H) fp32 (unused when splits is 1), then adds them in order.
// Launches the row build, the gate product, the recurrence, the dx
// product and the dW product (and the split sum); returns the first CUDA
// error (0 = success).
int dmt_bilstm_train_bwd_f32(const void* xin, const void* hs, const void* cs,
                             const void* dh, const void* w, const void* wht,
                             const void* bias, float forget_bias, void* dx,
                             void* rows, void* gates, void* da, void* dw,
                             void* partial, int splits, int batch, int steps,
                             int in_dim, int hidden, void* stream) {
  return launch_bwd<float>(xin, hs, cs, dh, w, wht, bias, forget_bias, dx,
                           rows, gates, da, dw, partial, splits, batch,
                           steps, in_dim, hidden, stream);
}

int dmt_bilstm_train_bwd_bf16(const void* xin, const void* hs,
                              const void* cs, const void* dh, const void* w,
                              const void* wht, const void* bias,
                              float forget_bias, void* dx, void* rows,
                              void* gates, void* da, void* dw, void* partial,
                              int splits, int batch, int steps, int in_dim,
                              int hidden, void* stream) {
  return launch_bwd<__nv_bfloat16>(xin, hs, cs, dh, w, wht, bias,
                                   forget_bias, dx, rows, gates, da, dw,
                                   partial, splits, batch, steps, in_dim,
                                   hidden, stream);
}

}  // extern "C"
