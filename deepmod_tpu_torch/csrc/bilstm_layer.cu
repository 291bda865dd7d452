// One BiLSTM layer, both lanes, for Hopper (sm_90a): the layered kernel.
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::_run_layer
// (Pallas body _layer_kernel), which bilstm_fused_center runs once per
// layer for even T, for T > 25 and when the caller forces the layered
// route. It computes the same function, not the same schedule: one layer
// of the fw and the bw lane over the steps of the readout cone, with the
// input and hidden products in the kernel and c in registers.
//
//   layer 0 reads the (B, T, F) windows through the caller's strides (the
//     overlapping window view of a detect row chunk is read in place),
//     the bw lane time-reversed (step t reads row T-1-t);
//   later layers read the previous layer's blocked sequence (below); the
//     bw lane stays in its reversed layout through the stack, so every
//     layer runs time forward;
//   every layer but the last writes its blocked sequence in the storage
//     type; the last writes only the readout rows, fw at step fw_step and
//     bw at step bw_step, into the (B, 2H) fp32 features (odd T: both the
//     last step T//2; even T: T//2 and T-1-T//2);
//   every layer of a lane stops at its readout step (the readout cone: the
//     lanes never exchange state before the final concat, and layer l+1
//     of a lane reads only layer l of the same lane, so the readout
//     depends on steps 0..fw_step of the fw lane and 0..bw_step of the bw
//     lane at every depth): the fw lane runs fw_step+1 steps a layer and
//     the bw lane bw_step+1, one fewer at even T. The wrapper sizes the
//     sequences for fw_step+1 steps (ops/bilstm_fused.py::cone); the JAX
//     kernel runs all T steps at even T, for the same result.
//
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh): grid (ceil(B/64), 2),
//   256 threads, lstm_tc.cuh::run_layer over the layer's padded,
//   gate-permuted weights in shared memory (ops/bilstm_fused.py packs
//   them), one [h_{t-1}; x_t] @ [Wh; Wx] wgmma chain a step; x_{t+1} is
//   prefetched during step t (register loads through the caller's strides
//   at layer 0, cp.async of one blocked row after it). Between layers the
//   sequence is port-internal and blocked: (2, steps,
//   ceil(B/64), 64 * Hp), each tile's row in lstm_tc.cuh's A-column
//   layout, so a row is one contiguous 16-byte copy in and out. Hidden
//   105-128 (Hp 112-128): a 2-CTA cluster a tile-lane, each CTA 128
//   threads over its half of the units (lstm_tc.cuh, the split).
//
// fp32 (csrc/lstm_f32.cuh): grid (ceil(B/tile) * split, 2), one lane of
//   one tile a cluster of `split` CTAs (1, 2 or 4), the layer's weights
//   resident in shared memory split by units over the cluster, h exchanged
//   through distributed shared memory, one cluster barrier a step
//   (lstm_f32.cuh's header); thread (u, g) owns one unit for 8 windows.
//   Between layers the sequence is blocked, (2, steps,
//   ceil(B/tile), H * tile) fp32, each tile's row [H][tile], so a row is
//   one contiguous copy in and out.
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
// What bounds it on an H100: per window, layer and step of a lane it
// does 2 x (in+H) x 4H FLOP (T=20, H=100, F=7: 8.51 MFLOP a window over 3
// layers, the fw lane's 11 steps and the bw lane's 10) and moves H values
// of sequence between layers, so it is bound by operations, with 11
// dependent steps a layer at T=20: fp32 FMAs on the CUDA cores in fp32; in
// bf16 the cell's tanhf before the tensor cores (lstm_tc.cuh).

#include "lstm_f32.cuh"

namespace {

// the fp32 kernel: one layer of one lane for one tile, a cluster of kSplit
// CTAs (each its units); the lane runs out_step + 1 steps (the cone)
template <int kSplit>
__global__ void __launch_bounds__(dmt::f32::kMaxThreads, 1)
bilstm_layer_f32_kernel(const float* __restrict__ x, long long s_b,
                        long long s_t, long long s_f, int reverse_bw,
                        const float* __restrict__ seq_in, int batch,
                        int in_steps, int steps, int in_dim, int hidden,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, float forget_bias,
                        float* __restrict__ seq_out, float* __restrict__ out,
                        int fw_step, int bw_step, int tile) {
  namespace f32 = dmt::f32;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tiles = gridDim.x / kSplit;
  const int tile_i = blockIdx.x / kSplit;
  const f32::Smem sm = f32::carve(f32_smem, in_dim, hidden,
                                  f32::units_of(hidden, kSplit), tile);
  const int hp4 = f32::packed_units(hidden);
  // blocked rows: (2, steps, tiles, H * tile); this tile's row of step t
  const long long row = static_cast<long long>(hidden) * tile;
  const long long step_stride = static_cast<long long>(tiles) * row;
  const long long at = static_cast<long long>(tile_i) * row;

  f32::Layer L;
  L.w = w + lane * static_cast<long long>(in_dim + hidden) * hp4 * 4;
  L.bias = bias + lane * hp4 * 4;
  L.in_dim = in_dim;
  L.hidden = hidden;
  L.batch = batch;
  L.lane = lane;
  L.tile = tile;
  L.b0 = static_cast<long long>(tile_i) * tile;
  L.fb = forget_bias;
  f32::LayerIO io;
  io.out_step = lane == 0 ? fw_step : bw_step;
  L.steps = io.out_step + 1;
  io.x = seq_in == nullptr ? x : nullptr;
  io.sb = s_b;
  io.st = s_t;
  io.sf = s_f;
  io.reversed = lane == 1 && reverse_bw != 0;
  io.in_steps = in_steps;
  io.seq_in = seq_in == nullptr
                  ? nullptr
                  : seq_in + lane * in_steps * step_stride + at;
  io.seq_in_t = step_stride;
  io.seq_out = seq_out == nullptr
                   ? nullptr
                   : seq_out + lane * steps * step_stride + at;
  io.seq_out_t = step_stride;
  io.out = out;
  f32::run_layer<kSplit>(sm, L, io);
}

template <int kSplit>
int launch_f32(const void* x, long long s_b, long long s_t, long long s_f,
               int reverse_bw, const void* seq_in, int batch, int in_steps,
               int steps, int in_dim, int hidden, const void* w,
               const void* bias, float forget_bias, void* seq_out, void* out,
               int fw_step, int bw_step, int tile, void* stream) {
  namespace f32 = dmt::f32;
  const int threads = f32::threads_of(hidden, kSplit, tile);
  if (tile % dmt::kR != 0 || threads > f32::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = f32::smem_bytes(in_dim, hidden, kSplit, tile);
  auto kernel = bilstm_layer_f32_kernel<kSplit>;
  const dim3 grid((batch + tile - 1) / tile * kSplit, 2);
  const auto* xf = static_cast<const float*>(x);
  const auto* sif = static_cast<const float*>(seq_in);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* sof = static_cast<float*>(seq_out);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if constexpr (kSplit > 1) {
    return static_cast<int>(dmt::tc::launch_cluster(
        kernel, grid, threads, smem, st, kSplit, xf, s_b, s_t, s_f,
        reverse_bw, sif, batch, in_steps, steps, in_dim, hidden, wf, bf,
        forget_bias, sof, o, fw_step, bw_step, tile));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(
        xf, s_b, s_t, s_f, reverse_bw, sif, batch, in_steps, steps, in_dim,
        hidden, wf, bf, forget_bias, sof, o, fw_step, bw_step, tile);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int kSplit>
int clusters_f32(int in_dim, int hidden, int tile, int* n) {
  namespace f32 = dmt::f32;
  return static_cast<int>(dmt::tc::cluster_occupancy(
      bilstm_layer_f32_kernel<kSplit>,
      f32::threads_of(hidden, kSplit, tile),
      f32::smem_bytes(in_dim, hidden, kSplit, tile), kSplit, n));
}

// the bf16 tensor-core kernel: one layer of one lane for a 64-window tile,
// the lane's out_step + 1 steps (the cone)
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
  L.steps = (lane == 0 ? fw_step : bw_step) + 1;  // the cone
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

// fp32 mode, the fp32 core (csrc/lstm_f32.cuh), one launch a layer of
// both lanes. Layer 0 reads x at x[b*s_b + t*s_t + f*s_f], the bw lane at
// step in_steps-1-t when reverse_bw, and seq_in is null; a later layer
// reads seq_in (the blocked (2, in_steps, ceil(B/tile), H * tile) fp32
// sequence). Exactly one of seq_out (blocked, `steps` rows a lane) and out
// ((B, 2H) fp32, the last layer) is non-null. w, bias: this layer's
// f32_pack_layer packing of ops/bilstm_fused.py for both lanes ([lane] the
// (in+H, Hp4, 4) fp32 weights, [lane] the (Hp4, 4) bias). The fw lane runs
// fw_step+1 steps, the bw lane bw_step+1. `split` CTAs a cluster (1, 2 or
// 4), tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256 threads
// (else cudaErrorInvalidValue); cudaErrorLaunchOutOfResources where no
// cluster fits
int dmt_bilstm_layer_f32(const void* x, long long s_b, long long s_t,
                         long long s_f, int reverse_bw, const void* seq_in,
                         int batch, int in_steps, int steps, int in_dim,
                         int hidden, const void* w, const void* bias,
                         float forget_bias, void* seq_out, void* out,
                         int fw_step, int bw_step, int tile, int split,
                         void* stream) {
#define DMT_LAUNCH(s)                                                   \
  return launch_f32<s>(x, s_b, s_t, s_f, reverse_bw, seq_in, batch,    \
                          in_steps, steps, in_dim, hidden, w, bias,       \
                          forget_bias, seq_out, out, fw_step, bw_step,    \
                          tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the fp32 kernel at this shape (a
// cluster of `split` CTAs), into *n
int dmt_bilstm_layer_f32_clusters(int in_dim, int hidden, int tile,
                                  int split, int* n) {
#define DMT_CLUSTERS(s) return clusters_f32<s>(in_dim, hidden, tile, n)
  DMT_F32_DISPATCH(split, DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

// bf16 mode, the tensor-core kernel, 64 windows a block. Layer 0 reads x
// (bf16) at x[b*s_b + t*s_t + f*s_f], the bw lane at step in_steps-1-t
// when reverse_bw, and seq_in is null; a later layer reads seq_in (the
// blocked (2, in_steps, ceil(B/64), 64 * Hp) bf16 sequence) and x is
// null. Exactly one of seq_out (blocked, `steps` rows) and out ((B, 2H)
// fp32, the last layer) is non-null; the fw lane runs fw_step+1 steps,
// the bw lane bw_step+1. w, bias: this layer's tensor-core
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
