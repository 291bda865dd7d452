// K1's function under the layer-wavefront schedule (K5c), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepmod_tpu/ops/bilstm_fused.py::
// _mono_wavefront_kernel (bilstm_fused_center_mono with wavefront=True,
// num_layers <= 3): (B, T, F) windows -> (B, 2H) fp32 [fw; bw] center
// features, odd T, the readout cone, the bw lane reading x time-reversed.
// At wavefront step s, layer L runs step t = s - L, so the num_layers
// chains of a lane are independent within a wavefront step.
//
// bf16 (the tensor-core kernel, csrc/lstm_tc.cuh's pieces): ONE CTA A
//   LAYER, a cluster of num_layers CTAs (1-3) per 64-window tile and lane;
//   grid (tiles * num_layers, 2). CTA L runs layer L at step t = s - L
//   with its [Wh; Wx] resident (173,056 B at Hp = 104) and lstm_tc.cuh's
//   step: one m64n(2Hp)k16 wgmma chain over [h_{t-1}; x_t], the cell in
//   registers. It writes h_t into its own h ring and, through distributed
//   shared memory, into CTA L+1's x ring slot t & 1, where layer L+1 reads
//   it as its x_t one wavefront step later. Layer 0 reads x through the
//   caller's strides (prefetched during the chain); the last layer writes
//   only the center row. One cluster barrier (arrive.release /
//   wait.acquire) ends each wavefront step, steps + num_layers - 1 of them
//   (13 at T=21 with 3 layers); the fp32 argument below carries over
//   slot for slot (one item a cluster: q = t). Hidden 105-128 (Hp
//   112-128) combine this with lstm_tc.cuh's unit split: 2 CTAs a layer,
//   a cluster of 2 * num_layers (6 at most, within the portable 8), each
//   CTA writing its half of h_t into its own and its peer's h ring and
//   into both x rings of layer L+1. The cluster's CTAs sit on num_layers
//   (or 2 num_layers) SMs of one GPC, so a GPC whose SM count the cluster
//   does not divide keeps SMs idle (chip_smoke.py logs
//   cudaOccupancyMaxActiveClusters). tile 64 only.
//
// fp32 (the fp32 core, csrc/lstm_f32.cuh's pieces): ONE CTA GROUP A LAYER
//   in a persistent cluster that streams (tile, lane) items through the
//   layer pipeline.
//   cluster: num_layers x split CTAs (ops/bilstm_fused.py::f32_shape's
//     split: 2 at H=100, so 6 CTAs with 3 layers; 4 at H=105-128, so 12,
//     over the portable 8: the kernel sets
//     cudaFuncAttributeNonPortableClusterSizeAllowed). CTA group L (cluster
//     ranks L*split .. L*split+split-1) holds layer L's [Wx; Wh] rows of
//     its units (f32_pack_layer's packing, [layer][lane]), resident for the
//     whole launch, and the core's h and x rings, sized by the widest layer
//     as K1's CTA is (224,960 B at H=100, tile 40).
//   grid: persistent, `slots` clusters (cudaOccupancyMaxActiveClusters,
//     at most the 2 x ceil(B/tile) items; ops/bilstm_fused.py::f32_slots).
//     The items run lane-major (item i: lane i / tiles, tile i % tiles),
//     and cluster `slot` takes the contiguous run slot * items / slots ..
//     (slot + 1) * items / slots - 1, so its lane changes at most once:
//     each weight is loaded once a cluster (a group reloads its own CTAs'
//     weights when its run crosses into the bw lane), not once a tile. A
//     grid of one cluster an item is the unstreamed form, a cluster a
//     tile-lane.
//   wavefront step s: group L runs the cluster's step q = s - L of its
//     item stream, item j = q / steps, step t = q % steps (n items take
//     n * steps + num_layers - 1 wavefront steps; a group with no q idles
//     to the barrier). Within an item this is K1's step: the product over
//     x_t's rows, then h_{t-1}'s (none at t = 0, where c is zeroed), the
//     bias, the Infer cell. h_t goes into slot q & 1 of its own group's h
//     rings and, through distributed shared memory, of group L+1's x
//     rings; layer 0 reads x through the caller's strides (the core's
//     x_issue into its x ring, the bw lane time-reversed), prefetching
//     step q+1 (the next item's step 0 at an item's end) during step q; the
//     last layer stores only the readout row at t = steps - 1. One cluster
//     barrier a wavefront step: arrive after the ring writes, the readout
//     store, wait.
//   ONE barrier a wavefront step suffices, across item boundaries too,
//     because the slots follow q, the group's count of steps over its item
//     stream, not t (steps is odd, so t & 1 would repeat slot 0 from an
//     item's last step to the next item's first). During step s group L
//     writes slot q & 1 of its h ring and of group L+1's x ring, and
//     nobody reads those: group L reads h slot (q-1) & 1, and group L+1
//     runs its q' = q - 1 and reads x slot (q-1) & 1. Their previous
//     contents (step q-2 of group L) were last read in step s-1, by group
//     L as its h and by group L+1 as its x, before that step's barrier.
//     Every value a group reads in step s was written in step s-1 (group
//     L-1's h at its q' = q, group L's own h at q-1, layer 0's prefetch of
//     step q) behind that barrier. tests/test_torch_mono_schedules.py walks
//     this slot arithmetic over 1-3 layers, odd T 1-25 and 1-3 items a
//     cluster.
//   Its own loop, not a mode of the core's run_layer: the wavefront,
//     the idle steps of fill and drain, the item stream and the
//     distributed-shared-memory path between layers share nothing with
//     run_layer's one layer-lane over a tile but the pieces it calls
//     (product, the Infer cell and stores, x_issue / x_complete,
//     load_weights, store_vec).
//
// Numerics: K1's contract (lstm_common.cuh's cell). Each layer-step is K1
// fp32's fmaf chain on the same stored values (the x rows, then the h
// rows from t=1 on, then the bias), so the result has K1's bits.
//
// What bounds it on an H100: the same 8.92 MFLOP a window as K1, by
// operations, on the CUDA cores. A wavefront step lasts as long as the
// slowest group's layer-step (in+H = 200 rows at layers 1-2 against 107 at
// layer 0), so a cluster runs at (107 + 200 + 200) / (3 x 200) = 0.85 of
// K1's FMA rate per SM, with the cluster barrier spanning num_layers x
// split CTAs; and clusters of 6 (or 12) CTAs of one GPC leave SMs idle
// where they do not divide it: an H100 holds 17 six-CTA clusters (102 of
// its 132 SMs) and 7 twelve-CTA ones (84). Together: 1.5x K1 fp32's time
// (PERF.md §6, measured 1.52x at H=100). The CUDA-core body this replaces
// held all layers of a lane in one block, read every layer's TF kernel
// from L2 in every wavefront step, and spilled at its 600-thread bound.

#include "lstm_f32.cuh"

namespace {

namespace cg = cooperative_groups;
namespace f32 = dmt::f32;
using dmt::kR;

// ------------------------------------------------- fp32: the fp32 core

// The persistent grid: cluster `slot` of gridDim.x / (num_layers * kSplit)
// streams its items through the layer pipeline, CTA group L running layer
// L (the header)
template <int kSplit>
__global__ void __launch_bounds__(f32::kMaxThreads, 1)
bilstm_wavefront_f32_kernel(const float* __restrict__ x, long long stride_b,
                            long long stride_t, long long stride_f,
                            int batch, int timesteps, int in_dim, int hidden,
                            int num_layers, const float* __restrict__ w,
                            const float* __restrict__ bias,
                            float forget_bias, float* __restrict__ out,
                            int tile) {
  namespace tc = dmt::tc;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int layer = crank / kSplit;
  const int part = crank % kSplit;
  const int csize = num_layers * kSplit;
  const int slot = blockIdx.x / csize;
  const int slots = gridDim.x / csize;
  const int tiles = (batch + tile - 1) / tile;
  // this cluster's run of the lane-major items (item i: lane i / tiles,
  // tile i % tiles)
  const int first = static_cast<int>(2LL * tiles * slot / slots);
  const int items = static_cast<int>(2LL * tiles * (slot + 1) / slots) - first;
  const int steps = timesteps / 2 + 1;
  const int work = items * steps;  // the group's steps q
  const int widest = in_dim > hidden ? in_dim : hidden;
  const int units = f32::units_of(hidden, kSplit);
  const f32::Smem sm = f32::carve(f32_smem, widest, hidden, units, tile);
  const int hp4 = f32::packed_units(hidden);
  const int tid = threadIdx.x;
  const int ul = tid % units;
  const int w0 = (tid / units) * kR;
  const int u = part * units + ul;  // this thread's unit
  const bool live = u < hidden;     // not a padded unit
  const bool last = layer == num_layers - 1;

  const float* w_layer = w;  // [layer][lane]
  for (int l = 0; l < layer; ++l) {
    w_layer += 2 * static_cast<long long>((l == 0 ? in_dim : hidden) +
                                          hidden) * hp4 * 4;
  }
  f32::Layer L;
  L.in_dim = layer == 0 ? in_dim : hidden;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.tile = tile;
  L.fb = forget_bias;
  f32::LayerIO io = {};
  io.x = layer == 0 ? x : nullptr;
  io.sb = stride_b;
  io.st = stride_t;
  io.sf = stride_f;
  io.in_steps = timesteps;
  io.out = last ? out : nullptr;
  io.out_step = steps - 1;
  // the cluster's item j: its lane's weights and bias, its windows
  auto at_item = [&](f32::Layer& li, f32::LayerIO& ioi, int j) {
    const int i = first + j;
    const int lane = i >= tiles ? 1 : 0;  // 0 = fw, 1 = bw
    li.lane = lane;
    li.w = w_layer + lane * static_cast<long long>(li.in_dim + hidden) *
                         hp4 * 4;
    li.bias = bias + (layer * 2 + lane) * hp4 * 4;
    li.b0 = static_cast<long long>(i - lane * tiles) * tile;
    ioi.reversed = lane;
  };
  at_item(L, io, 0);
  const f32::Infer pol{};

  // where h_t goes: the h rings of this CTA's group, the x rings of the
  // next layer's
  float* own_h[kSplit];
  float* next_x[kSplit];
#pragma unroll
  for (int p = 0; p < kSplit; ++p) {
    own_h[p] = cluster.map_shared_rank(sm.h, layer * kSplit + p);
    next_x[p] = last ? nullptr
                     : cluster.map_shared_rank(sm.x, (layer + 1) * kSplit + p);
  }

  // prologue: the layer's weights of the CTA's units, x of the first item's
  // step 0 (layer 0); every CTA of the cluster started before any remote
  // write
  pol.weights(sm.w, L, part * units, units);
  float4 bv = pol.bias(L, u);
  int loaded = L.lane;  // the lane whose weights are resident
  if (layer == 0) {
    float v[f32::kXRegs];
    f32::x_issue(io, L, 0, sm.x, v);
    f32::x_complete(io, L, 0, sm.x, v);
  }
  tc::cp_async_wait_all();
  tc::cluster_arrive();
  tc::cluster_wait();

  const float4* wx = sm.w + ul;
  const float4* wh = wx + L.in_dim * units;
  float c[kR];
  for (int s = 0; s < work + num_layers - 1; ++s) {
    const int q = s - layer;
    const bool active = q >= 0 && q < work;  // CTA-uniform
    int t = 0;
    float h[kR];
    if (active) {
      const int j = q / steps;
      t = q - j * steps;
      const int slot_q = q & 1;
      at_item(L, io, j);
      // layer 0: step q+1's x into the other slot, in flight under the
      // product (at an item's last step, the next item's step 0)
      const bool fetch = layer == 0 && q + 1 < work;
      f32::Layer next = L;
      f32::LayerIO io_next = io;
      int t_next = t + 1;
      if (t_next == steps) {
        t_next = 0;
        at_item(next, io_next, j + 1);
      }
      float* x_next = sm.x + (slot_q ^ 1) * sm.x_slot;
      float xv[f32::kXRegs];
      if (fetch) f32::x_issue(io_next, next, t_next, x_next, xv);
      // at most once a cluster: its run of items crosses from the fw lane
      // to the bw lane (every thread's last product with the old weights is
      // behind the previous wavefront step's barrier)
      if (L.lane != loaded) {
        pol.weights(sm.w, L, part * units, units);
        bv = pol.bias(L, u);
        loaded = L.lane;
        dmt::tc::cp_async_wait_all();
        __syncthreads();
      }

      if (t == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r) c[r] = 0.0f;
      }
      float acc[4][kR];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[g][r] = 0.0f;
      f32::product(sm.x + slot_q * sm.x_slot + w0, tile, wx, units, L.in_dim,
                   acc);
      if (t > 0) {  // h_{-1} = 0 contributes nothing
        f32::product(sm.h + (slot_q ^ 1) * sm.h_slot + w0, tile, wh, units,
                     hidden, acc);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        h[r] = pol.cell_h(acc[0][r] + bv.x, acc[1][r] + bv.y,
                          acc[2][r] + bv.z, acc[3][r] + bv.w, forget_bias,
                          c[r]);
      }
      const int at = u * tile + w0;
      if (live) {
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          f32::store_vec(own_h[p] + slot_q * sm.h_slot + at, h);
          if (!last) f32::store_vec(next_x[p] + slot_q * sm.x_slot + at, h);
        }
      }
      if (fetch) f32::x_complete(io_next, next, t_next, x_next, xv);
    }
    tc::cluster_arrive();
    // the readout row (the last layer at t = steps - 1), while the barrier
    // settles
    if (active && live) pol.stores(io, L, t, u, w0, h, c);
    tc::cluster_wait();
  }
}

// a CTA's shared memory: the widest layer's [Wx; Wh] and the rings, K1's
template <int kSplit>
size_t smem_f32(int in_dim, int hidden, int tile) {
  return f32::smem_bytes(in_dim > hidden ? in_dim : hidden, hidden, kSplit,
                         tile);
}

// the kernel at a shape it takes (else cudaErrorInvalidValue), with the
// attribute a cluster over 8 CTAs needs
template <int kSplit>
int prepare_f32(int hidden, int num_layers, int tile) {
  if (tile % kR != 0 ||
      f32::threads_of(hidden, kSplit, tile) > f32::kMaxThreads ||
      num_layers < 1 || num_layers > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      bilstm_wavefront_f32_kernel<kSplit>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

template <int kSplit>
int clusters_f32(int in_dim, int hidden, int num_layers, int tile, int* n) {
  const int err = prepare_f32<kSplit>(hidden, num_layers, tile);
  if (err != 0) return err;
  return static_cast<int>(dmt::tc::cluster_occupancy(
      bilstm_wavefront_f32_kernel<kSplit>,
      f32::threads_of(hidden, kSplit, tile),
      smem_f32<kSplit>(in_dim, hidden, tile), num_layers * kSplit, n));
}

template <int kSplit>
int launch_f32(const void* x, long long stride_b, long long stride_t,
               long long stride_f, int batch, int timesteps, int in_dim,
               int hidden, int num_layers, const void* w, const void* bias,
               float forget_bias, void* out, int tile, int slots,
               void* stream) {
  const int err = prepare_f32<kSplit>(hidden, num_layers, tile);
  if (err != 0) return err;
  if (slots < 1 || slots > 2 * ((batch + tile - 1) / tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = num_layers * kSplit;
  return static_cast<int>(dmt::tc::launch_cluster(
      bilstm_wavefront_f32_kernel<kSplit>, dim3(slots * cluster),
      f32::threads_of(hidden, kSplit, tile),
      smem_f32<kSplit>(in_dim, hidden, tile),
      static_cast<cudaStream_t>(stream), cluster,
      static_cast<const float*>(x), stride_b, stride_t, stride_f, batch,
      timesteps, in_dim, hidden, num_layers, static_cast<const float*>(w),
      static_cast<const float*>(bias), forget_bias, static_cast<float*>(out),
      tile));
}

// ------------------------------------------------- bf16: the tensor cores

// the bf16 kernel: layer cluster_rank / split of one tile-lane
template <int kHp>
__global__ void __launch_bounds__(
    dmt::tc::threads_of(dmt::tc::split_of(kHp)), 1)
bilstm_wavefront_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           long long stride_b, long long stride_t,
                           long long stride_f, int batch, int timesteps,
                           int in_dim, int hidden, int num_layers,
                           int nx_max, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, float fb_term,
                           float* __restrict__ out) {
  namespace tc = dmt::tc;
  using bf16 = __nv_bfloat16;
  constexpr int kSplit = tc::split_of(kHp);
  constexpr int kT = tc::threads_of(kSplit);
  constexpr int kN = 2 * kHp;
  constexpr int kGroups = kHp / 8;
  constexpr int kNh = kHp / 8;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int layer = crank / kSplit;
  const int part = crank % kSplit;
  const int tile = blockIdx.x / (num_layers * kSplit);
  const int lane = blockIdx.y;  // 0 = fw, 1 = bw
  const int steps = timesteps / 2 + 1;
  const int tid = threadIdx.x;
  const int half = kSplit > 1 ? part : tid >> 7;  // tc_gate_columns' warpgroup
  const int row0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int unit0 = half * (kHp / 2) + (tid & 3);  // unit of group p: + 4p
  const int widest = in_dim > hidden ? in_dim : hidden;
  const tc::Smem sm = tc::carve(tc_smem, kHp, nx_max,
                                tc::weight_bytes(kHp, widest) / kSplit);

  tc::Layer L;
  L.w = w;  // [layer][lane] in the packing
  for (int l = 0; l < layer; ++l) {
    L.w += tc::weight_bytes(kHp, l == 0 ? in_dim : hidden);  // 2 lanes
  }
  L.in_dim = layer == 0 ? in_dim : hidden;
  L.w += lane * static_cast<long long>(tc::weight_bytes(kHp, L.in_dim) / 2);
  L.bias = bias + (layer * 2 + lane) * kHp * 4;
  L.hidden = hidden;
  L.steps = steps;
  L.batch = batch;
  L.lane = lane;
  L.b0 = static_cast<long long>(tile) * tc::kRows;
  L.fb = fb_term;
  tc::LayerIO io = {};
  io.x = layer == 0 ? x : nullptr;
  io.sb = stride_b;
  io.st = stride_t;
  io.sf = stride_f;
  io.reversed = lane == 1;
  io.in_steps = timesteps;
  const int nx = tc::x_cols(L.in_dim);
  const int nc = kNh + nx;
  const int nk = tc::k_tiles(kHp, L.in_dim);
  const bool last = layer == num_layers - 1;

  // where h_t goes: this CTA's h ring (and the peer's), layer L+1's x rings
  unsigned char* h_peer =
      kSplit > 1 ? cluster.map_shared_rank(sm.h, crank ^ 1) : nullptr;
  unsigned char* x_next_layer[kSplit];
#pragma unroll
  for (int r = 0; r < kSplit; ++r) {
    x_next_layer[r] =
        last ? nullptr : cluster.map_shared_rank(sm.x, (layer + 1) * kSplit + r);
  }

  // prologue: weights and bias of the layer, h_{-1} = 0, the zero column,
  // x_0 (layer 0); every CTA of the cluster started before any remote write
  {
    tc::load_weights<kT>(sm.w, L.w, kHp, 0, 2 * nk, part, kSplit, false);
    const float4* b = reinterpret_cast<const float4*>(L.bias);
    for (int u = tid; u < kHp; u += kT) sm.bias[u] = b[u];
    const uint4 z = make_uint4(0, 0, 0, 0);
    uint4* h1 = reinterpret_cast<uint4*>(sm.h + sm.h_slot);
    for (int i = tid; i < sm.h_slot / 16; i += kT) h1[i] = z;
    for (int i = tid; i < tc::kColBytes / 16; i += kT) {
      reinterpret_cast<uint4*>(sm.zero)[i] = z;
    }
    if (layer == 0) {
      bf16 v[tc::kXRegs];
      tc::x_issue<kT>(io, L, 0, sm.x, nx, v);
      tc::x_complete<kT>(io, L, 0, sm.x, nx, v);
    }
    tc::cp_async_wait_all();
    tc::step_barrier<true>();
  }

  float c[2 * kGroups];
#pragma unroll
  for (int i = 0; i < 2 * kGroups; ++i) c[i] = 0.0f;
  float acc[kHp];
#pragma unroll
  for (int i = 0; i < kHp; ++i) acc[i] = 0.0f;
  const uint32_t w_lbo = 4 * kHp / kSplit * 16;
  const uint32_t w_base =
      tc::smem_addr(sm.w) + (kSplit > 1 ? 0 : half) * (kN / 8) * 128;
  const uint32_t zero_col = tc::smem_addr(sm.zero);

  for (int s = 0; s < steps + num_layers - 1; ++s) {
    const int t = s - layer;
    if (t >= 0 && t < steps) {  // CTA-uniform
      const int slot = t & 1;
      const uint32_t h_prev = tc::smem_addr(sm.h + (slot ^ 1) * sm.h_slot);
      const uint32_t x_cur = tc::smem_addr(sm.x + slot * sm.x_slot);
      tc::chain<kN>(
          acc,
          [&](int cc) {
            return cc < kNh  ? h_prev + cc * tc::kColBytes
                   : cc < nc ? x_cur + (cc - kNh) * tc::kColBytes
                             : zero_col;
          },
          w_base, w_lbo, nk, 0);
      // while the tensor cores run: layer 0's x_{t+1}
      bf16 xv[tc::kXRegs];
      unsigned char* x_next = sm.x + (slot ^ 1) * sm.x_slot;
      const bool fetch = layer == 0 && t + 1 < steps;
      if (fetch) tc::x_issue<kT>(io, L, t + 1, x_next, nx, xv);
      tc::wgmma_wait_all();
      tc::fence_acc(acc);

      const bool emit = last && t == steps - 1;
#pragma unroll
      for (int p = 0; p < kGroups; ++p) {
        const int u = unit0 + 4 * p;
        bf16 v0 = dmt::from_f<bf16>(0.0f), v1 = dmt::from_f<bf16>(0.0f);
        if (half * (kHp / 2) + 4 * p < hidden) {  // warp-uniform
          tc::cell_pair(acc[8 * p], acc[8 * p + 1], acc[8 * p + 2],
                        acc[8 * p + 3], acc[8 * p + 4], acc[8 * p + 5],
                        acc[8 * p + 6], acc[8 * p + 7], sm.bias[u], fb_term,
                        c[2 * p], c[2 * p + 1], v0, v1);
        }
        // one straight-line body for every group, as run_layer's: a
        // `continue` past the stores here (the last step's h is read by
        // nobody) cost ~4,000 cycles a step in the cell (clock64 stamps,
        // H100) and 20% of the kernel's time
        tc::put_h(sm.h + slot * sm.h_slot, u, row0, v0, v1);
        if (kSplit > 1) tc::put_h(h_peer + slot * sm.h_slot, u, row0, v0, v1);
        if (!last) {
#pragma unroll
          for (int r = 0; r < kSplit; ++r) {
            tc::put_h(x_next_layer[r] + slot * sm.x_slot, u, row0, v0, v1);
          }
        }
        if (emit && u < hidden) {
          const long long b = L.b0 + row0;
          float* o = out + lane * hidden + u;
          if (b < batch) o[b * 2 * hidden] = dmt::to_f(v0);
          if (b + 8 < batch) o[(b + 8) * 2 * hidden] = dmt::to_f(v1);
        }
      }
      if (fetch) tc::x_complete<kT>(io, L, t + 1, x_next, nx, xv);
    }
    tc::step_barrier<true>();
  }
}

template <int kHp>
size_t wavefront_smem(int in_dim, int hidden) {
  namespace tc = dmt::tc;
  const int widest = in_dim > hidden ? in_dim : hidden;
  return tc::smem_bytes(kHp, tc::x_cols(widest),
                        tc::weight_bytes(kHp, widest) / tc::split_of(kHp));
}

template <int kHp>
int launch_tc(const void* x, long long stride_b, long long stride_t,
              long long stride_f, int batch, int timesteps, int in_dim,
              int hidden, int num_layers, const void* w, const void* bias,
              float fb_term, void* out, void* stream) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  if (num_layers < 1 || num_layers > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nx_max = tc::x_cols(in_dim > hidden ? in_dim : hidden);
  const int cluster = num_layers * kSplit;
  const dim3 grid((batch + tc::kRows - 1) / tc::kRows * cluster, 2);
  return static_cast<int>(tc::launch_cluster(
      bilstm_wavefront_tc_kernel<kHp>, grid, tc::threads_of(kSplit),
      wavefront_smem<kHp>(in_dim, hidden), static_cast<cudaStream_t>(stream),
      cluster, static_cast<const __nv_bfloat16*>(x), stride_b, stride_t,
      stride_f, batch, timesteps, in_dim, hidden, num_layers, nx_max,
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      fb_term, static_cast<float*>(out)));
}

template <int kHp>
int clusters_tc(int in_dim, int hidden, int num_layers, int* clusters) {
  namespace tc = dmt::tc;
  constexpr int kSplit = tc::split_of(kHp);
  return static_cast<int>(tc::cluster_occupancy(
      bilstm_wavefront_tc_kernel<kHp>, tc::threads_of(kSplit),
      wavefront_smem<kHp>(in_dim, hidden), num_layers * kSplit, clusters));
}

}  // namespace

extern "C" {

// fp32 mode, the fp32 core on a persistent grid of `slots` clusters of
// num_layers x split CTAs (split 1, 2 or 4; num_layers 1-3): x is fp32; w
// and bias are the f32_pack_layer packing of ops/bilstm_fused.py (per
// [layer][lane] the (in+H, Hp4, 4) fp32 weights and the (Hp4, 4) bias);
// slots at most the 2 * ceil(B/tile) items (one cluster an item: the
// unstreamed form). Tile a multiple of 8, ceil(hidden/split) * tile/8 <=
// 256 threads (else cudaErrorInvalidValue); cudaErrorLaunchOutOfResources
// where no cluster fits. Returns cudaGetLastError() after the launch (0 =
// success)
int dmt_bilstm_wavefront_f32(const void* x, long long stride_b,
                             long long stride_t, long long stride_f,
                             int batch, int timesteps, int in_dim,
                             int hidden, int num_layers, const void* w,
                             const void* bias, float forget_bias, void* out,
                             int tile, int split, int slots, void* stream) {
#define DMT_LAUNCH(s)                                                       \
  return launch_f32<s>(x, stride_b, stride_t, stride_f, batch, timesteps,  \
                       in_dim, hidden, num_layers, w, bias, forget_bias,   \
                       out, tile, slots, stream)
  DMT_F32_DISPATCH(split, DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the fp32 kernel at this shape
// (clusters of num_layers x split CTAs) into *clusters: the persistent
// grid's slots before the cap by the items
int dmt_bilstm_wavefront_f32_clusters(int in_dim, int hidden, int num_layers,
                                      int tile, int split, int* clusters) {
#define DMT_CLUSTERS(s) \
  return clusters_f32<s>(in_dim, hidden, num_layers, tile, clusters)
  DMT_F32_DISPATCH(split, DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

// bf16 mode, the tensor-core kernel, 64 windows a cluster: x is bf16; w
// and bias are the tensor-core packing of ops/bilstm_fused.py (per
// [layer][lane] the padded, gate-permuted (Kp, 4Hp) bf16 weights in core
// columns and the (Hp, 4) fp32 bias, i/f/o pre-halved); half_forget_bias
// is 0.5 * forget_bias; num_layers 1-3. Hp = hidden rounded up to 8, at
// most 128 (else cudaErrorInvalidValue); a cluster shape the card cannot
// place returns cudaErrorLaunchOutOfResources
int dmt_bilstm_wavefront_bf16(const void* x, long long stride_b,
                              long long stride_t, long long stride_f,
                              int batch, int timesteps, int in_dim,
                              int hidden, int num_layers, const void* w,
                              const void* bias, float half_forget_bias,
                              void* out, void* stream) {
#define DMT_LAUNCH(hp)                                                      \
  return launch_tc<hp>(x, stride_b, stride_t, stride_f, batch, timesteps,  \
                       in_dim, hidden, num_layers, w, bias,                \
                       half_forget_bias, out, stream)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_LAUNCH)
#undef DMT_LAUNCH
}

// cudaOccupancyMaxActiveClusters of the bf16 kernel's cluster at this
// shape (num_layers CTAs, or 2 * num_layers for Hp 112-128) into *clusters
int dmt_bilstm_wavefront_bf16_clusters(int in_dim, int hidden,
                                       int num_layers, int* clusters) {
#define DMT_CLUSTERS(hp) \
  return clusters_tc<hp>(in_dim, hidden, num_layers, clusters)
  DMT_TC_DISPATCH(dmt::tc::padded_hidden(hidden), DMT_CLUSTERS)
#undef DMT_CLUSTERS
}

}  // extern "C"
