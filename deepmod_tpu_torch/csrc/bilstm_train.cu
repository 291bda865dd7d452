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
// K2, train_fwd_kernel: grid (ceil(B / tile_b), 2), blockIdx.y the lane;
//   one block runs ALL layers of its lane for tile_b windows (one launch
//   for the whole stack, where the TPU launches once per layer). Thread
//   (u, g) owns hidden unit u for the kR windows g*kR .. g*kR+kR-1 and
//   computes all four gates of that unit, so c stays in registers. Shared
//   memory holds an fp32 h carry [H][tile_b], one sequence buffer
//   [steps][H][tile_b] in T that layer L reads at row t (layer L-1's
//   stored h_t) and, after a barrier, overwrites with its own stored h_t,
//   and the staged layer-0 inputs. Every step's h and c go to global
//   memory as the residuals (layers, 2, steps, B, H).
// K3, train_bwd_kernel: one launch per layer serves both lanes, grid
//   (ceil(B / tile_b), 2). Time runs in reverse with the dh and dc carries
//   in fp32 registers. Per step the block stages x_t and the stored
//   h_{t-1} in shared memory; each thread recomputes its unit's gates,
//   forms the four gate gradients da for its windows and writes them to
//   shared memory and to global memory (2, steps, B, 4H) fp32; after a
//   barrier each thread forms dh_{t-1} for its unit and dx_t for row u
//   (u < in) from the transposed kernel. Capped at 80 registers a thread
//   so that two 400-thread blocks share an SM and batch 2048 runs in one
//   wave.
// K3's weight-gradient pass, train_dw_kernel: dW[lane] = sum over (t, b)
//   of [x_t; h_{t-1}; 1]^T da_t, an (in+H+1, 4H) fp32 product whose last
//   row is the bias gradient. One 32x32 output tile per block, summing a
//   contiguous range of the steps*B rows in a fixed order; the wrapper
//   splits the rows into up to 8 ranges so that enough blocks are in
//   flight to hide the load latency, and sum_splits_kernel adds the
//   ranges in order. No atomics: two runs give the same bits.
//
// What bounds them on an H100: at H=100, 3 layers, T=21, F=7 a window
// costs 8.92 MFLOP in K2 and about 26.8 MFLOP in K3 (gate recompute, the
// dh/dx products and the dW product), all fp32 FMAs on the CUDA cores,
// against a few kB of sequence traffic: they are bound by operations
// (67 TFLOP/s fp32), and the 11 dependent steps a layer set the latency
// floor of the recurrences. Left for later: tensor-core products (wgmma on
// 64-window tiles; tf32 or bf16 inputs would change the fp32 contract),
// the weights in shared memory, register-tiled dW products, and fusing
// the dW product into the recurrence. PERF.md holds the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 4;  // windows per thread
constexpr int kMaxThreads = 512;
constexpr int kBwdRegs = 80;
constexpr int kTile = 32;       // dW output tile (rows and columns)
constexpr int kChunk = 32;      // (t, b) rows per shared-memory chunk
constexpr int kDwThreads = 256;

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

// kR consecutive values from shared memory as floats (16-byte aligned for
// float, 8-byte for bf16)
__device__ __forceinline__ void load_r(const float* p, float (&v)[kR]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_r(const __nv_bfloat16* p,
                                       float (&v)[kR]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]);
  const float2 b = __bfloat1622float2(h2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store_r(float* p, const float (&v)[kR]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_r(__nv_bfloat16* p,
                                        const float (&v)[kR]) {
  uint2 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
  h2[0] = __floats2bfloat162_rn(v[0], v[1]);
  h2[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float sigmoid_tanh(float v) {
  return 0.5f * tanhf(0.5f * v) + 0.5f;
}

// acc[g][r] += sum_k src[k * src_stride + r] * w[k * 4H + g * H] over
// `rows` rows; w points at the thread's unit column of a TF (rows, 4H)
// fp32 kernel
template <typename S>
__device__ __forceinline__ void accumulate(const S* src, int src_stride,
                                           const float* __restrict__ w,
                                           int rows, int hidden,
                                           float (&acc)[4][kR]) {
  const int row = 4 * hidden;
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float xv[kR];
    load_r(src + static_cast<size_t>(k) * src_stride, xv);
    const float* wk = w + static_cast<size_t>(k) * row;
    const float wi = __ldg(wk);
    const float wj = __ldg(wk + hidden);
    const float wf = __ldg(wk + 2 * hidden);
    const float wo = __ldg(wk + 3 * hidden);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[0][r] = fmaf(wi, xv[r], acc[0][r]);
      acc[1][r] = fmaf(wj, xv[r], acc[1][r]);
      acc[2][r] = fmaf(wf, xv[r], acc[2][r]);
      acc[3][r] = fmaf(wo, xv[r], acc[3][r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
train_fwd_kernel(const T* __restrict__ xin, int batch, int steps, int in_dim,
                 int hidden, int num_layers, const float* __restrict__ w,
                 const float* __restrict__ bias, float forget_bias,
                 T* __restrict__ hs, T* __restrict__ cs, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  float* hc = reinterpret_cast<float*>(smem_raw);  // [hidden][tile_b]
  T* seq = reinterpret_cast<T*>(hc + static_cast<size_t>(hidden) * tile_b);
  // seq: [steps][hidden][tile_b]; xs: [steps][in_dim][tile_b]
  T* xs = seq + static_cast<size_t>(steps) * hidden * tile_b;

  // stage this lane's layer-0 inputs, reading consecutive features with
  // consecutive threads; windows past the batch read zeros and are never
  // written out
  const T* xl = xin + static_cast<size_t>(lane) * steps * batch * in_dim;
  const int n_stage = steps * tile_b * in_dim;
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) {
    const int k = i % in_dim;
    const int wi = (i / in_dim) % tile_b;
    const int t = i / (in_dim * tile_b);
    const long long b = b0 + wi;
    T v = from_f<T>(0.0f);
    if (b < batch) v = xl[(static_cast<size_t>(t) * batch + b) * in_dim + k];
    xs[(static_cast<size_t>(t) * in_dim + k) * tile_b + wi] = v;
  }

  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const int gates = 4 * hidden;
  const size_t lane_w =
      static_cast<size_t>(in_dim + hidden) * gates +
      static_cast<size_t>(num_layers - 1) * 2 * hidden * gates;
  const float* wl = w + lane * lane_w;
  const float* bl = bias + static_cast<size_t>(lane) * num_layers * gates;
  const size_t seq_elems = static_cast<size_t>(steps) * batch * hidden;
  __syncthreads();

  for (int layer = 0; layer < num_layers; ++layer) {
    const int lin = layer == 0 ? in_dim : hidden;
    const T* src = layer == 0 ? xs : seq;
    const float bi = bl[u];
    const float bj = bl[hidden + u];
    const float bf = bl[2 * hidden + u];
    const float bo = bl[3 * hidden + u];
    T* hl = hs + (static_cast<size_t>(layer) * 2 + lane) * seq_elems;
    T* cl = cs + (static_cast<size_t>(layer) * 2 + lane) * seq_elems;
    float c[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) c[r] = 0.0f;

    for (int t = 0; t < steps; ++t) {
      float acc[4][kR];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
      accumulate(src + static_cast<size_t>(t) * lin * tile_b + w0, tile_b,
                 wl + u, lin, hidden, acc);
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        accumulate(hc + w0, tile_b,
                   wl + static_cast<size_t>(lin) * gates + u, hidden, hidden,
                   acc);
      }
      // every thread has read row t and the carry before either changes
      __syncthreads();
      float h[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float si = sigmoid_tanh(acc[0][r] + bi);
        const float sj = tanhf(acc[1][r] + bj);
        const float sf = sigmoid_tanh(acc[2][r] + bf + forget_bias);
        const float so = sigmoid_tanh(acc[3][r] + bo);
        c[r] = c[r] * sf + si * sj;
        h[r] = tanhf(c[r]) * so;
      }
      // the fp32 carry for this layer's next step, the stored (rounded)
      // row for the next layer
      store_r(hc + static_cast<size_t>(u) * tile_b + w0, h);
      store_r(seq + (static_cast<size_t>(t) * hidden + u) * tile_b + w0, h);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long b = b0 + w0 + r;
        if (b < batch) {
          const size_t off = (static_cast<size_t>(t) * batch + b) * hidden + u;
          hl[off] = from_f<T>(h[r]);
          cl[off] = from_f<T>(c[r]);
        }
      }
      __syncthreads();
    }
    wl += static_cast<size_t>(lin + hidden) * gates;
    bl += gates;
  }
}

// at most 80 registers a thread (kMaxThreads of them fit a block): two
// 400-thread blocks (H=100, tile_b 16) then fit an SM, so the 256 blocks
// of batch 2048 run in one wave
template <typename T>
__global__ void __maxnreg__(kBwdRegs)
train_bwd_kernel(const T* __restrict__ xin, const T* __restrict__ hs,
                 const T* __restrict__ cs, const T* __restrict__ dh_in,
                 const float* __restrict__ w, const float* __restrict__ wt,
                 const float* __restrict__ bias, float forget_bias,
                 T* __restrict__ dx, float* __restrict__ da, int batch,
                 int steps, int in_dim, int hidden, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int gates = 4 * hidden;
  const int rows = in_dim + hidden;
  float* das = reinterpret_cast<float*>(smem_raw);       // [4H][tile_b]
  float* xs = das + static_cast<size_t>(gates) * tile_b;  // [in][tile_b]
  float* hp = xs + static_cast<size_t>(in_dim) * tile_b;  // [H][tile_b]

  const size_t seq_h = static_cast<size_t>(steps) * batch * hidden;
  const size_t seq_x = static_cast<size_t>(steps) * batch * in_dim;
  const T* xl = xin + lane * seq_x;
  const T* hl = hs + lane * seq_h;
  const T* cl = cs + lane * seq_h;
  const T* dhl = dh_in + lane * seq_h;
  T* dxl = dx + lane * seq_x;
  float* dal = da + lane * static_cast<size_t>(steps) * batch * gates;
  const float* wl = w + static_cast<size_t>(lane) * rows * gates;
  const float* wtl = wt + static_cast<size_t>(lane) * gates * rows;
  const float* bl = bias + static_cast<size_t>(lane) * gates;

  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const bool has_x = u < in_dim;  // the wrapper ensures in_dim <= hidden
  const float bi = bl[u];
  const float bj = bl[hidden + u];
  const float bf = bl[2 * hidden + u];
  const float bo = bl[3 * hidden + u];
  float dh_carry[kR], dc_carry[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    dh_carry[r] = 0.0f;
    dc_carry[r] = 0.0f;
  }

  for (int t = steps - 1; t >= 0; --t) {
    // stage x_t and the stored h_{t-1} (zero at t = 0) as fp32
    for (int i = threadIdx.x; i < in_dim * tile_b; i += blockDim.x) {
      const int k = i % in_dim;
      const int wi = i / in_dim;
      const long long b = b0 + wi;
      xs[static_cast<size_t>(k) * tile_b + wi] =
          b < batch ? to_f(xl[(static_cast<size_t>(t) * batch + b) * in_dim + k])
                    : 0.0f;
    }
    for (int i = threadIdx.x; i < hidden * tile_b; i += blockDim.x) {
      const int k = i % hidden;
      const int wi = i / hidden;
      const long long b = b0 + wi;
      hp[static_cast<size_t>(k) * tile_b + wi] =
          (t > 0 && b < batch)
              ? to_f(hl[(static_cast<size_t>(t - 1) * batch + b) * hidden + k])
              : 0.0f;
    }
    __syncthreads();

    // recompute the gates from (x_t, h_{t-1})
    float acc[4][kR];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
    accumulate(xs + w0, tile_b, wl + u, in_dim, hidden, acc);
    accumulate(hp + w0, tile_b, wl + static_cast<size_t>(in_dim) * gates + u,
               hidden, hidden, acc);
    float dav[4][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long b = b0 + w0 + r;
      const bool valid = b < batch;
      const size_t off = (static_cast<size_t>(t) * batch + b) * hidden + u;
      const float ig = sigmoid_tanh(acc[0][r] + bi);
      const float jg = tanhf(acc[1][r] + bj);
      const float fg = sigmoid_tanh(acc[2][r] + bf + forget_bias);
      const float og = sigmoid_tanh(acc[3][r] + bo);
      const float c_t = valid ? to_f(cl[off]) : 0.0f;
      const float c_prev =
          (valid && t > 0) ? to_f(cl[off - static_cast<size_t>(batch) * hidden])
                           : 0.0f;
      const float dh_total = (valid ? to_f(dhl[off]) : 0.0f) + dh_carry[r];
      const float tanh_c = tanhf(c_t);
      const float d_o = dh_total * tanh_c;
      const float dc = dc_carry[r] + dh_total * og * (1.0f - tanh_c * tanh_c);
      const float di = dc * jg;
      const float dj = dc * ig;
      const float df = dc * c_prev;
      dc_carry[r] = dc * fg;
      dav[0][r] = di * ig * (1.0f - ig);
      dav[1][r] = dj * (1.0f - jg * jg);
      dav[2][r] = df * fg * (1.0f - fg);
      dav[3][r] = d_o * og * (1.0f - og);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      store_r(das + (static_cast<size_t>(g) * hidden + u) * tile_b + w0,
              dav[g]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long b = b0 + w0 + r;
      if (b < batch) {
        float* dst = dal + (static_cast<size_t>(t) * batch + b) * gates + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) dst[g * hidden] = dav[g][r];
      }
    }
    __syncthreads();

    // dh_{t-1} = da . W_h^T for unit u, dx_t = da . W_x^T for row u
    float ah[kR], ax[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ah[r] = 0.0f;
      ax[r] = 0.0f;
    }
#pragma unroll 4
    for (int g = 0; g < gates; ++g) {
      float dv[kR];
      load_r(das + static_cast<size_t>(g) * tile_b + w0, dv);
      const float* wg = wtl + static_cast<size_t>(g) * rows;
      const float wh = __ldg(wg + in_dim + u);
#pragma unroll
      for (int r = 0; r < kR; ++r) ah[r] = fmaf(dv[r], wh, ah[r]);
      if (has_x) {
        const float wx = __ldg(wg + u);
#pragma unroll
        for (int r = 0; r < kR; ++r) ax[r] = fmaf(dv[r], wx, ax[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) dh_carry[r] = ah[r];
    if (has_x) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long b = b0 + w0 + r;
        if (b < batch) {
          dxl[(static_cast<size_t>(t) * batch + b) * in_dim + u] =
              from_f<T>(ax[r]);
        }
      }
    }
    // the next step overwrites the staged rows and da
    __syncthreads();
  }
}

// dw[lane][k][g] = sum over n = t*batch + b of A[n][k] * da[lane][n][g],
// A[n] = [x_t; h_{t-1} (0 at t = 0); 1]. Grid (ceil((in+H+1)/32),
// ceil(4H/32), 2 * splits): blockIdx.z = lane * splits + split. Each block
// owns one 32x32 output tile of one lane and sums, in order, the rows of
// its split (a contiguous range of n); 256 threads each own a 2x2 patch.
// With splits > 1 the block writes its partial sum to out[split] and
// sum_splits_kernel adds the splits in order; with one split out is dw.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
train_dw_kernel(const T* __restrict__ xin, const T* __restrict__ hs,
                const float* __restrict__ da, float* __restrict__ out,
                int batch, int steps, int in_dim, int hidden, int splits) {
  __shared__ __align__(16) float as[kChunk][kTile];
  __shared__ __align__(16) float ds[kChunk][kTile];
  const int lane = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int k0 = blockIdx.x * kTile;
  const int g0 = blockIdx.y * kTile;
  const int gates = 4 * hidden;
  const int rows = in_dim + hidden + 1;
  const long long n_rows = static_cast<long long>(steps) * batch;
  const long long per_split =
      (n_rows + static_cast<long long>(splits) * kChunk - 1) /
      (static_cast<long long>(splits) * kChunk) * kChunk;
  const long long n_begin = split * per_split;
  const long long n_end =
      n_begin + per_split < n_rows ? n_begin + per_split : n_rows;
  const T* xl = xin + static_cast<size_t>(lane) * n_rows * in_dim;
  const T* hl = hs + static_cast<size_t>(lane) * n_rows * hidden;
  const float* dal = da + static_cast<size_t>(lane) * n_rows * gates;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (long long n0 = n_begin; n0 < n_end; n0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile; i += kDwThreads) {
      const int nn = i / kTile;
      const int kk = i % kTile;
      const long long n = n0 + nn;
      const int k = k0 + kk;
      float v = 0.0f;
      if (n < n_end && k < rows) {
        if (k < in_dim) {
          v = to_f(xl[n * in_dim + k]);
        } else if (k < in_dim + hidden) {
          if (n >= batch) v = to_f(hl[(n - batch) * hidden + (k - in_dim)]);
        } else {
          v = 1.0f;  // the bias row
        }
      }
      as[nn][kk] = v;
      const int g = g0 + kk;
      ds[nn][kk] = (n < n_end && g < gates) ? dal[n * gates + g] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kChunk; ++nn) {
      const float2 a = *reinterpret_cast<const float2*>(&as[nn][ty * 2]);
      const float2 d = *reinterpret_cast<const float2*>(&ds[nn][tx * 2]);
      acc[0][0] = fmaf(a.x, d.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, d.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, d.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, d.y, acc[1][1]);
    }
    __syncthreads();
  }
  float* dst = out + static_cast<size_t>(split) * 2 * rows * gates;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = g0 + tx * 2 + j;
      if (k < rows && g < gates) {
        dst[(static_cast<size_t>(lane) * rows + k) * gates + g] = acc[i][j];
      }
    }
  }
}

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

template <typename T>
int launch_fwd(const void* xin, int batch, int steps, int in_dim, int hidden,
               int num_layers, const void* w, const void* bias,
               float forget_bias, void* hs, void* cs, int tile_b,
               void* stream) {
  const size_t smem = static_cast<size_t>(hidden) * tile_b * sizeof(float) +
                      static_cast<size_t>(steps) * (hidden + in_dim) *
                          tile_b * sizeof(T);
  auto kernel = train_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b, 2);
  const dim3 block(hidden * (tile_b / kR));
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xin), batch, steps, in_dim, hidden, num_layers,
      static_cast<const float*>(w), static_cast<const float*>(bias),
      forget_bias, static_cast<T*>(hs), static_cast<T*>(cs), tile_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* xin, const void* hs, const void* cs,
               const void* dh, const void* w, const void* wt,
               const void* bias, float forget_bias, void* dx, void* da,
               void* dw, void* partial, int splits, int batch, int steps,
               int in_dim, int hidden, int tile_b, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(5 * hidden + in_dim) * tile_b * sizeof(float);
  auto kernel = train_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((batch + tile_b - 1) / tile_b, 2),
           dim3(hidden * (tile_b / kR)), smem, s>>>(
      static_cast<const T*>(xin), static_cast<const T*>(hs),
      static_cast<const T*>(cs), static_cast<const T*>(dh),
      static_cast<const float*>(w), static_cast<const float*>(wt),
      static_cast<const float*>(bias), forget_bias, static_cast<T*>(dx),
      static_cast<float*>(da), batch, steps, in_dim, hidden, tile_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = in_dim + hidden + 1;
  float* dw_out = static_cast<float*>(splits > 1 ? partial : dw);
  train_dw_kernel<T><<<dim3((rows + kTile - 1) / kTile,
                            (4 * hidden + kTile - 1) / kTile, 2 * splits),
                       dim3(kDwThreads), 0, s>>>(
      static_cast<const T*>(xin), static_cast<const T*>(hs),
      static_cast<const float*>(da), dw_out, batch, steps, in_dim, hidden,
      splits);
  if (splits == 1) return static_cast<int>(cudaGetLastError());
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = 2 * rows * 4 * hidden;
  sum_splits_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(
      dw_out, static_cast<float*>(dw), n_out, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2: xin (2, steps, B, in) in the storage type; w the fp32 TF kernels of
// every [lane][layer], flat; bias (2, layers, 4H) fp32; hs, cs (layers, 2,
// steps, B, H) in the storage type. Returns cudaGetLastError() after the
// launch (0 = success).
int dmt_bilstm_train_fwd_f32(const void* xin, int batch, int steps,
                             int in_dim, int hidden, int num_layers,
                             const void* w, const void* bias,
                             float forget_bias, void* hs, void* cs,
                             int tile_b, void* stream) {
  return launch_fwd<float>(xin, batch, steps, in_dim, hidden, num_layers, w,
                           bias, forget_bias, hs, cs, tile_b, stream);
}

int dmt_bilstm_train_fwd_bf16(const void* xin, int batch, int steps,
                              int in_dim, int hidden, int num_layers,
                              const void* w, const void* bias,
                              float forget_bias, void* hs, void* cs,
                              int tile_b, void* stream) {
  return launch_fwd<__nv_bfloat16>(xin, batch, steps, in_dim, hidden,
                                   num_layers, w, bias, forget_bias, hs, cs,
                                   tile_b, stream);
}

// K3 for one layer, both lanes: xin (2, steps, B, in), hs, cs, dh (2,
// steps, B, H) in the storage type; w (2, in+H, 4H), wt (2, 4H, in+H),
// bias (2, 4H) fp32. Writes dx (2, steps, B, in) in the storage type, the
// scratch da (2, steps, B, 4H) fp32 and dw (2, in+H+1, 4H) fp32 (last row:
// the bias gradient). The dW product sums `splits` contiguous ranges of
// the steps*B rows into the scratch partial (splits, 2, in+H+1, 4H) fp32
// (unused when splits is 1), then adds them in order. Launches the
// recurrence, then the dW product; returns the first CUDA error (0 =
// success).
int dmt_bilstm_train_bwd_f32(const void* xin, const void* hs, const void* cs,
                             const void* dh, const void* w, const void* wt,
                             const void* bias, float forget_bias, void* dx,
                             void* da, void* dw, void* partial, int splits,
                             int batch, int steps, int in_dim, int hidden,
                             int tile_b, void* stream) {
  return launch_bwd<float>(xin, hs, cs, dh, w, wt, bias, forget_bias, dx,
                           da, dw, partial, splits, batch, steps, in_dim,
                           hidden, tile_b, stream);
}

int dmt_bilstm_train_bwd_bf16(const void* xin, const void* hs,
                              const void* cs, const void* dh, const void* w,
                              const void* wt, const void* bias,
                              float forget_bias, void* dx, void* da,
                              void* dw, void* partial, int splits, int batch,
                              int steps, int in_dim, int hidden, int tile_b,
                              void* stream) {
  return launch_bwd<__nv_bfloat16>(xin, hs, cs, dh, w, wt, bias, forget_bias,
                                   dx, da, dw, partial, splits, batch, steps,
                                   in_dim, hidden, tile_b, stream);
}

}  // extern "C"
