// One BiLSTM layer, both lanes, for Hopper (sm_90a): the layered kernel.
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::_run_layer
// (Pallas body _layer_kernel), which bilstm_fused_center runs once per
// layer for even T, for T > 25 and when the caller forces the layered
// route. It computes the same function, not the same schedule: one layer
// of the fw and the bw lane over `steps` steps, with the input and
// hidden products in the kernel and c in registers.
//
//   layer 0 reads the (B, T, F) windows through the caller's strides (the
//     overlapping window view of a detect row chunk is read in place),
//     the bw lane time-reversed (step t reads row T-1-t);
//   later layers read the previous layer's (2, steps, B, H) sequences;
//     the bw lane stays in its reversed layout through the stack, so
//     every layer runs time forward;
//   every layer but the last writes its (2, steps, B, H) sequence in the
//     storage type; the last writes only the readout rows, fw at step
//     fw_step and bw at step bw_step, into the (B, 2H) fp32 features
//     (odd T: both the last step T//2; even T: T//2 and T-1-T//2).
//
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh): grid (ceil(B/64), 2),
//   256 threads, lstm_tc.cuh::run_layer over the layer's padded,
//   gate-permuted weights in shared memory (ops/bilstm_fused.py packs
//   them), one [h_{t-1}; x_t] @ [Wh; Wx] wgmma chain a step; x_{t+1} is
//   prefetched during step t (register loads through the caller's strides
//   at layer 0, cp.async of one blocked row after it). Between layers the
//   (2, steps, B, H) sequence is port-internal and blocked: (2, steps,
//   ceil(B/64), 64 * Hp), each tile's row in lstm_tc.cuh's A-column
//   layout, so a row is one contiguous 16-byte copy in and out. Hidden
//   105-128 (Hp 112-128): a 2-CTA cluster a tile-lane, each CTA 128
//   threads over its half of the units (lstm_tc.cuh, the split).
//
// fp32 design (simple first, fast later):
//   grid (ceil(B / tile_b), 2): blockIdx.y is the lane, one launch a
//     layer serves both lanes, as the TPU kernel does.
//   threads: hidden * tile_b / 8; thread (u, g) owns hidden unit u for 8
//     windows and computes its four gates as dot products over [x_t;
//     h_{t-1}] against the TF (in+H, 4H) kernel read from global memory
//     (it stays in L2), so the cell update stays in the thread.
//   shared memory: x_t [in][tile_b], staged each step from global memory
//     by the whole block, and h_{t-1} [H][tile_b] in the storage type.
//     Two barriers a step: after the staging (x_t and h_{t-1} complete)
//     and after the products (before h and x are overwritten).
//   the step loop has a runtime bound, so any T runs (the TPU kernel
//     unrolls up to 32 steps and loops beyond).
//
// Numerics are K1's contract (bilstm_fused.cu, lstm_common.cuh::cell):
//   fp32: exp sigmoids, forget_bias added inside the f sigmoid.
//   bf16: bf16 inputs, weights and stored sequences, so h is rounded to
//     bf16 before the h-product; fp32 accumulation and fp32 c; i/f/o
//     columns pre-halved by the wrapper, sigmoid as 0.5*tanhf+0.5, the f
//     gate adding 0.5*forget_bias in the original association. The
//     readout rows leave rounded to the storage type, as the TPU kernel's
//     bf16 output blocks do.
//
// What bounds it on an H100: per window and layer it does 2 lanes x
// steps x 2*(in+H)*4H FLOP (T=20, H=100, F=7: 16.2 MFLOP a window over 3
// layers) and moves 2 x steps x H x 4 B of fp32 sequence between layers,
// so it is bound by operations, with `steps` dependent steps a layer:
// fp32 FMAs on the CUDA cores in fp32; in bf16 the cell's tanhf before the
// tensor cores (lstm_tc.cuh). Left for later: stopping each lane of every
// layer at its readout step (the readout cone for even T).

#include "lstm_tc.cuh"

namespace {

using dmt::accumulate;
using dmt::from_f;
using dmt::kMaxThreads;
using dmt::kR;
using dmt::store8;
using dmt::to_f;

template <typename T, bool kPrescaled>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_layer_kernel(const T* __restrict__ in, long long s_lane,
                    long long s_b, long long s_t, long long s_f,
                    int reverse_bw, int batch, int in_steps, int steps,
                    int in_dim, int hidden, const T* __restrict__ w,
                    long long w_lane, const float* __restrict__ bias,
                    long long b_lane, float fb_term, T* __restrict__ seq_out,
                    float* __restrict__ out, int fw_step, int bw_step,
                    int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_b;
  T* hs = reinterpret_cast<T*>(smem_raw);              // [hidden][tile_b]
  T* xs = hs + static_cast<size_t>(hidden) * tile_b;   // [in_dim][tile_b]

  const T* src = in + lane * s_lane;
  const T* wl = w + lane * w_lane;
  const float* bl = bias + lane * b_lane;
  const bool reversed = lane == 1 && reverse_bw != 0;
  const int out_step = lane == 0 ? fw_step : bw_step;
  const int u = threadIdx.x % hidden;
  const int w0 = (threadIdx.x / hidden) * kR;
  const float bi = bl[u];
  const float bj = bl[hidden + u];
  const float bf = bl[2 * hidden + u];
  const float bo = bl[3 * hidden + u];
  const int n_stage = in_dim * tile_b;
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;

  for (int t = 0; t < steps; ++t) {
    // stage x_t, consecutive threads on consecutive features; windows past
    // the batch read zeros and are never written out
    const T* row = src + (reversed ? in_steps - 1 - t : t) * s_t;
    for (int i = threadIdx.x; i < n_stage; i += blockDim.x) {
      const int k = i % in_dim;
      const int wi = i / in_dim;
      const long long b = b0 + wi;
      T v = from_f<T>(0.0f);
      if (b < batch) v = row[b * s_b + k * s_f];
      xs[k * tile_b + wi] = v;
    }
    __syncthreads();
    float acc[4][kR];
    dmt::zero(acc);
    accumulate(xs + w0, tile_b, wl + u, in_dim, hidden, acc);
    if (t > 0) {  // h_{-1} = 0 contributes nothing
      accumulate(hs + w0, tile_b,
                 wl + static_cast<size_t>(in_dim) * 4 * hidden + u, hidden,
                 hidden, acc);
    }
    // every thread has read x_t and h_{t-1} before either is rewritten
    __syncthreads();
    float h[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      h[r] = dmt::cell<kPrescaled>(acc[0][r] + bi, acc[1][r] + bj,
                                   acc[2][r] + bf, acc[3][r] + bo, fb_term,
                                   c[r]);
    }
    store8(hs + static_cast<size_t>(u) * tile_b + w0, h);
    if (out != nullptr) {
      if (t == out_step) {  // the last layer: only the readout row
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const long long b = b0 + w0 + r;
          if (b < batch) {
            out[b * 2 * hidden + lane * hidden + u] = to_f(from_f<T>(h[r]));
          }
        }
      }
    } else {
      T* dst = seq_out + (static_cast<long long>(lane) * steps + t) *
                             batch * hidden;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long b = b0 + w0 + r;
        if (b < batch) dst[b * hidden + u] = from_f<T>(h[r]);
      }
    }
  }
}

template <typename T, bool kPrescaled>
int launch(const void* in, long long s_lane, long long s_b, long long s_t,
           long long s_f, int reverse_bw, int batch, int in_steps, int steps,
           int in_dim, int hidden, const void* w, long long w_lane,
           const void* bias, long long b_lane, float fb_term, void* seq_out,
           void* out, int fw_step, int bw_step, int tile_b, void* stream) {
  const size_t smem =
      static_cast<size_t>(hidden + in_dim) * tile_b * sizeof(T);
  auto kernel = bilstm_layer_kernel<T, kPrescaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + tile_b - 1) / tile_b, 2);
  const dim3 block(hidden * (tile_b / kR));
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), s_lane, s_b, s_t, s_f, reverse_bw, batch,
      in_steps, steps, in_dim, hidden, static_cast<const T*>(w), w_lane,
      static_cast<const float*>(bias), b_lane, fb_term,
      static_cast<T*>(seq_out), static_cast<float*>(out), fw_step, bw_step,
      tile_b);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 tensor-core kernel: one layer of one lane for a 64-window tile
// (Hp > 104: this CTA's half of the units, a 2-CTA cluster a tile-lane)
template <int kHp>
__global__ void __launch_bounds__(
    dmt::tc::threads_of(dmt::tc::split_of(kHp)), 1)
bilstm_layer_tc_kernel(const __nv_bfloat16* __restrict__ x, long long s_b,
                       long long s_t, long long s_f, int reverse_bw,
                       const __nv_bfloat16* __restrict__ seq_in, int batch,
                       int in_steps, int steps, int in_dim, int hidden,
                       int nx, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, float fb_term,
                       __nv_bfloat16* __restrict__ seq_out,
                       float* __restrict__ out, int fw_step, int bw_step) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tiles = gridDim.x / kSplit;
  const int tile_i = blockIdx.x / kSplit;
  const size_t w_bytes = tc::weight_bytes(kHp, in_dim);
  const tc::Smem sm = tc::carve(tc_smem, kHp, nx, w_bytes / kSplit);
  // blocked rows: (2, steps, tiles, 64 * Hp); this tile's row of step t
  const long long row = static_cast<long long>(tc::kRows) * kHp;
  const long long step_stride = static_cast<long long>(tiles) * row;
  const long long tile = static_cast<long long>(tile_i) * row;

  tc::Layer L;
  L.w = w + lane * static_cast<long long>(w_bytes / 2);
  L.bias = bias + lane * kHp * 4;
  L.in_dim = in_dim;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.b0 = static_cast<long long>(tile_i) * tc::kRows;
  L.fb = fb_term;
  tc::LayerIO io;
  io.x = x;
  io.sb = s_b;
  io.st = s_t;
  io.sf = s_f;
  io.reversed = lane == 1 && reverse_bw != 0;
  io.in_steps = in_steps;
  io.seq_in = seq_in == nullptr
                  ? nullptr
                  : seq_in + lane * in_steps * step_stride + tile;
  io.seq_in_t = step_stride;
  io.seq_out = seq_out == nullptr
                   ? nullptr
                   : seq_out + lane * steps * step_stride + tile;
  io.seq_out_t = step_stride;
  io.out = out;
  io.out_step = lane == 0 ? fw_step : bw_step;
  tc::run_layer<kHp, kSplit>(sm, L, io);
}

template <int kHp>
int launch_tc(const void* x, long long s_b, long long s_t, long long s_f,
              int reverse_bw, const void* seq_in, int batch, int in_steps,
              int steps, int in_dim, int hidden, const void* w,
              const void* bias, float fb_term, void* seq_out, void* out,
              int fw_step, int bw_step, void* stream) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  const int nx = tc::x_cols(in_dim);
  const size_t smem =
      tc::smem_bytes(kHp, nx, tc::weight_bytes(kHp, in_dim) / kSplit);
  auto kernel = bilstm_layer_tc_kernel<kHp>;
  const dim3 grid((batch + tc::kRows - 1) / tc::kRows * kSplit, 2);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sib = static_cast<const __nv_bfloat16*>(seq_in);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const float*>(bias);
  auto* sob = static_cast<__nv_bfloat16*>(seq_out);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(tc::launch_cluster(
        kernel, grid, tc::threads_of(kSplit), smem, st, kSplit, xb, s_b,
        s_t, s_f, reverse_bw, sib, batch, in_steps, steps, in_dim, hidden,
        nx, wb, bb, fb_term, sob, o, fw_step, bw_step));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, tc::kThreads, smem, st>>>(
        xb, s_b, s_t, s_f, reverse_bw, sib, batch, in_steps, steps, in_dim,
        hidden, nx, wb, bb, fb_term, sob, o, fw_step, bw_step);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// One layer, both lanes. `in` is read at in[lane*s_lane + b*s_b + t*s_t +
// f*s_f] (strides in elements; s_lane 0 for the layer-0 windows), the bw
// lane at step in_steps-1-t when reverse_bw. Exactly one of seq_out
// ((2, steps, B, H) in the storage type) and out ((B, 2H) fp32, the last
// layer) is non-null. w: the fw lane's TF (in+H, 4H) kernel, the bw
// lane's w_lane elements further; bias likewise with b_lane. fp32 mode;
// returns cudaGetLastError() after the launch (0 = success)
int dmt_bilstm_layer_f32(const void* in, long long s_lane, long long s_b,
                         long long s_t, long long s_f, int reverse_bw,
                         int batch, int in_steps, int steps, int in_dim,
                         int hidden, const void* w, long long w_lane,
                         const void* bias, long long b_lane,
                         float forget_bias, void* seq_out, void* out,
                         int fw_step, int bw_step, int tile_b, void* stream) {
  return launch<float, false>(in, s_lane, s_b, s_t, s_f, reverse_bw, batch,
                              in_steps, steps, in_dim, hidden, w, w_lane,
                              bias, b_lane, forget_bias, seq_out, out,
                              fw_step, bw_step, tile_b, stream);
}

// bf16 mode, the tensor-core kernel, 64 windows a block. Layer 0 reads x
// (bf16) at x[b*s_b + t*s_t + f*s_f], the bw lane at step in_steps-1-t
// when reverse_bw, and seq_in is null; a later layer reads seq_in (the
// blocked (2, in_steps, ceil(B/64), 64 * Hp) bf16 sequence) and x is
// null. Exactly one of seq_out (blocked, `steps` rows) and out ((B, 2H)
// fp32, the last layer) is non-null. w, bias: this layer's tensor-core
// packing of ops/bilstm_fused.py for both lanes ([lane] the padded,
// gate-permuted (Kp, 4Hp) bf16 weights in core columns; [lane] the (Hp, 4)
// fp32 bias), i/f/o pre-halved; half_forget_bias is 0.5 * forget_bias. Hp
// = hidden rounded up to 8, at most 128 (else cudaErrorInvalidValue);
// Hp 112-128 launch 2-CTA clusters (cudaErrorLaunchOutOfResources where
// none fits)
int dmt_bilstm_layer_bf16(const void* x, long long s_b, long long s_t,
                          long long s_f, int reverse_bw, const void* seq_in,
                          int batch, int in_steps, int steps, int in_dim,
                          int hidden, const void* w, const void* bias,
                          float half_forget_bias, void* seq_out, void* out,
                          int fw_step, int bw_step, void* stream) {
#define DMT_LAUNCH(hp)                                                       \
  return launch_tc<hp>(x, s_b, s_t, s_f, reverse_bw, seq_in, batch,         \
                       in_steps, steps, in_dim, hidden, w, bias,            \
                       half_forget_bias, seq_out, out, fw_step, bw_step,    \
                       stream)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_LAUNCH)
#undef DMT_LAUNCH
}

}  // extern "C"
