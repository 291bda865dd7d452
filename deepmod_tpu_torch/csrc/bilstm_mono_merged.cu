// K1's function under the merged-GEMM schedule (K5a), for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_merged_kernel (bilstm_fused_center_mono with merged_gemm=True):
// (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center features, odd T, every
// layer of each lane stopping at step T//2 (the readout cone), the bw lane
// reading x time-reversed. The TPU kernel issues ONE [x_t; h] @ [Wx; Wh]
// product a step instead of two. Two modes:
//
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh): grid (ceil(B/64), 2),
//   256 threads; each layer of the lane runs lstm_tc.cuh::run_layer, one
//   [h_{t-1}; x_t] @ [Wh; Wx] wgmma chain a step with the layer's padded,
//   gate-permuted weights in shared memory (ops/bilstm_fused.py packs
//   them, [layer][lane]). The layer loop and the readout cone (T//2+1
//   steps) stay inside the block; layer 0 reads x through the caller's
//   strides; the inter-layer sequence (11 x 64 x 104 x 2 B = 146 KB at
//   T=21, H=100) does not fit beside the weights, so it lives in a
//   device-memory workspace from the wrapper, one blocked row a step,
//   overwritten in place by the next layer: its step t+1 writes row t,
//   which the prefetch of step t-1 read. 132 resident blocks x 146 KB stay
//   in the 50 MB L2. Hidden 105-128 (Hp 112-128): a 2-CTA cluster a
//   tile-lane, each CTA 128 threads over its half of the units
//   (lstm_tc.cuh, the split), the pair sharing the workspace rows.
//
// fp32 (the fp32 core, csrc/lstm_f32.cuh, run_layer in its merged mode):
//   K1 fp32's launch (bilstm_fused.cu): grid (ceil(B / tile) * split, 2),
//     blockIdx.y the lane, a cluster of `split` CTAs (ops/bilstm_fused.py::
//     f32_shape: 2 at H=100, 4 at H=105-128) running every layer of that
//     lane for `tile` windows; each layer's [Wx; Wh] (f32_pack_layer's
//     rows, already stacked) resident in shared memory, split by units;
//     the inter-layer rows in K1's blocked fp32 workspace.
//   the merged operand: each slot of a ring of two stacks x_t (rows
//     0..in-1) on h_{t-1} (rows in..in+H-1), [in+H][tile]; a step is ONE
//     product over the in+H rows of its slot (the x rows alone at t=0,
//     where h is 0), the TPU kernel's one [x_t; h] @ [Wx; Wh]; x_{t+1}
//     arrives by cp.async (register loads through the caller's strides at
//     layer 0) in the other slot's x rows, and each CTA writes h_t into its
//     own and its peers' h rows of that slot through distributed shared
//     memory; one cluster barrier a step. The ring takes the bytes of K1's
//     h and x rings, so K5a's launch, shared memory and split are K1's.
//   x is read through the caller's strides (materialized windows or the
//     overlapping window view of a feature block, read in place).
//   What it replaces: a CUDA-core body that copied [x_t; h_{t-1}] into an
//     operand buffer (two barriers a step) and read its unit's column of
//     the layer's whole TF (in+H, 4H) kernel, 320 KB at H=100, from L2 on
//     every step in every block with scalar loads.
//
// Numerics: K1's contract (lstm_common.cuh's cell; fp32 exp sigmoids; bf16
// storage with pre-halved i/f/o columns and tanh sigmoids). In fp32 the FMA
// chain is K1's: the x rows, then the h rows, into the same accumulators,
// so the result has K1's bits. In bf16 the tensor cores sum in another
// order: K1's result within the bf16 tolerance, not its bits.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1 at H=100,
// F=7, T=21 (operations, not bytes), with 33 dependent steps a lane. fp32:
// the FMAs on the CUDA cores (67 TFLOP/s), the step's chain (product,
// cell, exchange, barrier) repeated; the weights stay resident, so no step
// reads them from device memory, and the one product a step runs the same
// FMAs as K1's two. bf16: lstm_tc.cuh's note (the cell's tanhf before the
// tensor cores).

#include "lstm_f32.cuh"

namespace {

// ---------------------------------------------- fp32: the fp32 core

// one lane of one tile, every layer, a cluster of kSplit CTAs (each its
// units): lstm_f32.cuh::run_stack with the merged operand ring
template <int kSplit>
__global__ void __launch_bounds__(dmt::f32::kMaxThreads, 1)
bilstm_merged_f32_kernel(const float* __restrict__ x, long long stride_b,
                         long long stride_t, long long stride_f, int batch,
                         int timesteps, int in_dim, int hidden,
                         int num_layers, const float* __restrict__ w,
                         const float* __restrict__ bias, float forget_bias,
                         float* __restrict__ ws, float* __restrict__ out,
                         int tile) {
  dmt::f32::run_stack<kSplit, true>(x, stride_b, stride_t, stride_f, batch,
                                    timesteps, in_dim, hidden, num_layers,
                                    w, bias, forget_bias, ws, out, tile);
}

// ---------------------------------------------- bf16: the tensor cores

// the bf16 tensor-core kernel: one lane of one 64-window tile, every layer
// (Hp > 104: this CTA's half of the units, a 2-CTA cluster a tile-lane)
template <int kHp>
__global__ void __launch_bounds__(
    dmt::tc::threads_of(dmt::tc::split_of(kHp)), 1)
bilstm_merged_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        long long stride_b, long long stride_t,
                        long long stride_f, int batch, int timesteps,
                        int in_dim, int hidden, int num_layers, int nx_max,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, float fb_term,
                        __nv_bfloat16* __restrict__ ws,
                        float* __restrict__ out) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int steps = timesteps / 2 + 1;
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int tile = blockIdx.x / kSplit;
  const size_t w_max =
      tc::weight_bytes(kHp, in_dim > hidden ? in_dim : hidden) / kSplit;
  const tc::Smem sm = tc::carve(tc_smem, kHp, nx_max, w_max);
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
    tc::run_layer<kHp, kSplit>(sm, here, io);
    L.w += 2 * lane_w;  // [layer][lane]
    L.bias += 2 * kHp * 4;
  }
}

template <int kHp>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* ws, void* out, void* stream) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  const int widest = in_dim > hidden ? in_dim : hidden;
  const int nx_max = tc::x_cols(widest);
  const size_t smem =
      tc::smem_bytes(kHp, nx_max, tc::weight_bytes(kHp, widest) / kSplit);
  auto kernel = bilstm_merged_tc_kernel<kHp>;
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

template <int kHp>
int clusters_tc(int in_dim, int hidden, int* clusters) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  const int widest = in_dim > hidden ? in_dim : hidden;
  return static_cast<int>(tc::cluster_occupancy(
      bilstm_merged_tc_kernel<kHp>, tc::threads_of(kSplit),
      tc::smem_bytes(kHp, tc::x_cols(widest),
                     tc::weight_bytes(kHp, widest) / kSplit),
      kSplit, clusters));
}

}  // namespace

extern "C" {

// fp32 mode, the fp32 core with the merged operand ring: K1 fp32's
// arguments (bilstm_fused.cu::dmt_bilstm_center_f32): x is fp32; w and
// bias are the f32_pack_layer packing (per [layer][lane] the (in+H, Hp4,
// 4) fp32 weights and the (Hp4, 4) bias); ws is an fp32 workspace of
// ceil(B/tile) * 2 * (T//2+1) * H * tile elements; `split` CTAs a cluster
// (1, 2 or 4), tile a multiple of 8, ceil(hidden/split) * tile/8 <= 256
// threads (else cudaErrorInvalidValue); cudaErrorLaunchOutOfResources
// where no cluster fits. Returns cudaGetLastError() after the launch (0 =
// success)
int dmt_bilstm_merged_f32(const void* x, long long stride_b,
                          long long stride_t, long long stride_f, int batch,
                          int timesteps, int in_dim, int hidden,
                          int num_layers, const void* w, const void* bias,
                          float forget_bias, void* ws, void* out, int tile,
                          int split, void* stream) {
#define DMT_LAUNCH(s)                                                     \
  return dmt::f32::launch_stack<s>(                                       \
      bilstm_merged_f32_kernel<s>, x, stride_b, stride_t, stride_f,        \
      batch, timesteps, in_dim, hidden, num_layers, w, bias,              \
      forget_bias, ws, out, tile, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// bf16 mode, the tensor-core kernel, 64 windows a block: x is bf16; w and
// bias are the tensor-core packing of ops/bilstm_fused.py (per [layer][lane]
// the padded, gate-permuted (Kp, 4Hp) bf16 weights in core columns and the
// (Hp, 4) fp32 bias, i/f/o pre-halved); ws is a bf16 workspace of
// ceil(B/64) * 2 * (T//2+1) * 64 * Hp elements; half_forget_bias is 0.5 *
// forget_bias. Hp = hidden rounded up to 8, at most 128 (else
// cudaErrorInvalidValue); Hp 112-128 launch 2-CTA clusters
// (cudaErrorLaunchOutOfResources where none fits)
int dmt_bilstm_merged_bf16(const void* x, long long stride_b,
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

// cudaOccupancyMaxActiveClusters of the bf16 kernel at this shape (a
// cluster of 1 CTA up to Hp = 104, of 2 beyond) into *clusters
int dmt_bilstm_merged_bf16_clusters(int in_dim, int hidden, int* clusters) {
#define DMT_CLUSTERS(hp) return clusters_tc<hp>(in_dim, hidden, clusters)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

}  // extern "C"
