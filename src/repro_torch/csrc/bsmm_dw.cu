// Kernel E: the block-sparse weight gradient.
//
//   dw[i][m][n] = sum_b x[b, rows[i]*bm + m] * dy[b, cols[i]*bn + n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_dw (the Pallas
// _dw_kernel), whose sequential grid (nb, B/bb) carries each slot's sum over
// batch tiles in VMEM. Here the sum over the batch is cut into S contiguous
// runs of 32-sample chunks; one block sums one run for (a 64 x 64 part of)
// one slot's tile, in a fixed order. No atomics: the same inputs give the
// same bits on every run.
//
// What bounds it on an H100: 2 * B * nb * bm * bn flops (3x that on the
// tensor cores in 3xTF32) against the bytes of x, dy and dw. At batch 128 and
// 128 x 128 tiles a layer of 32 tiles is 134 MFLOP, 2.0 us at the f32 rate
// and 0.8 us at the 3xTF32 tensor rate, so the latency of one block's chain
// and the number of blocks in flight set the time. The scalar version this
// replaces (f32 FMAs, one barrier-bound 32-sample slice at a time, 4 blocks
// per slot) took 19.5-19.7 us on every layer, whether 8 or 32 tiles, 78.5 us
// a training step (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
//   * Split rule. S is chosen on the host from nb, the batch and the tile
//     sizes alone (block_sparse_matmul.py::dw_splits: about one wave of
//     blocks on the 132 SMs, at most one run per chunk). Run s covers chunks
//     [C*s/S, C*(s+1)/S) of the C = ceil(B/32) chunks. S = 1 writes dw
//     directly; S > 1 writes each run's partial tile to part (S, nb, bm, bn)
//     and a second pass (tf32x3.cuh::sum_parts) adds them in index order.
//   * One block of 256 threads per (slot, 64 x 64 part of the tile, run); 8
//     warps as 2 x 4, each a 32 x 16 warp tile of 2 x 2 m16n8k8 products.
//   * A cp.async ring of 4 stages; a stage is 32 samples of the slot's x
//     columns xs[b][m] and dy columns ys[b][n] (32 x 64 each, row pitch 72,
//     so that the fragment loads are free of bank conflicts), read along the
//     feature axis. 16-byte copies where bm and bn are multiples of 4 and x
//     and dy are 16-byte aligned, else 4-byte copies; masked elements (the
//     ragged last chunk, bm or bn below 64) are zero-filled by the copy's
//     source size, so fragments past the edge read zeros.
//   * 3xTF32 on mma.sync (tf32x3.cuh), A = x^T read from xs transposed.
//     wgmma would need both TF32 operands K-major (batch-contiguous) in
//     shared memory, and both are batch-major here: wgmma and TMA are the
//     next step, with transposed copies.
//
// The bf16 instance, bsmm_dw_bf16: the tile gradients of kernel C's bf16
// instance, which the bfloat16 LM's training step runs twice a layer (W_in:
// x (2048, 1024) and dy (2048, 2816) -> (22, 128, 128); W_out: x (2048,
// 2816) and dy (2048, 1024) -> (15, 128, 128)). It replaces the same Pallas
// _dw_kernel (src/repro/kernels/block_sparse_matmul.py:170, bsmm_dw at
// :186), which sums bf16 products on the MXU into an f32 VMEM scratch across
// the batch tiles of its sequential grid and rounds once.
// What bounds it on an H100: bytes. At 2,048 rows, on W_in it reads dy's 22
// block-columns (11.5 MB) and x's touched block-rows (at most 4.2 MB) and
// writes 0.7 MB, 4.8 us at 3.35 TB/s; on W_out x's touched block-rows and
// dy (4.2 MB), 2.8 us. Their 1.5 and 1.0 GFLOP take 1.5 and 1.0 us at the
// 989 TFLOP/s bf16 rate.
// Design (sm90.cuh): dW[i] = x[:, rows[i]]^T dy[:, cols[i]] over the batch:
// A[m][b] = x[b][m] and B[b][n] = dy[b][n] both come MN-major from
// batch-major boxes, through wgmma's transpose bits.
//   * One cluster of S CTAs per tile, each CTA over the whole tile, so x and
//     dy are read once a tile: CTA s sums the batch run s (chunks [C*s/S,
//     C*(s+1)/S) of the C = ceil(B/64) 64-row chunks). S comes from host
//     ints (block_sparse_matmul.py::dw_splits_bf16: at least 8 chunks a run,
//     the clusters on at most 3/4 of the 132 SMs, at most 8, the portable
//     cluster size): 4 on W_in (22 tiles) and W_out (15) at 2,048 rows, 1
//     below 961 rows.
//   * Warp-specialised: a producer warp sets up the mbarriers and starts
//     loading at once, keeping a ring of 3 stages in flight by TMA (a stage:
//     64 rows of x's block-row and of dy's block-column, two 64-wide boxes
//     each, 32 KB, the 128-byte swizzle); two consumer warpgroups each take
//     64 of the tile's rows, wgmma m64n128k16 into f32 registers, four k16
//     steps a stage.
//   * The sum (sm90.cuh::ClusterSum): each CTA stages its f32 partial in its
//     ring, sends each other CTA its share of the tile's rows by one bulk
//     copy into a receive area after the ring (ready before any CTA's loads
//     began), and adds its share over the ranks 0, 1, ..., S - 1 in that
//     order, spread over all its threads, and rounds once
//     (__float2bfloat16_rn). One launch a call: no second pass, no f32
//     partials in device memory, no atomics, the same bits on every launch.
//     Up to 166 KB of shared memory: one CTA an SM. Without a cluster the
//     tile rounds straight from the registers.
//   * A ragged last chunk and tile sides below the boxes' 64 are zero-filled
//     by TMA (x and dy are mapped as (batch, grid, side)); only the tile's
//     bm x bn are stored.
// Where x and dy sit in L2 the L2's rate bounds the product: 22.5 MB pass
// through it on W_in at 2,048 rows (x's block-rows once a tile), as they do
// for torch.bmm on the gathered tiles.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;      // output tile: kTile x kTile of the slot's bm x bn
constexpr int kDepth = 32;     // samples per stage (one chunk)
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps as 2 x 4, 32 x 16 each
constexpr int kLd = kTile + 8;
constexpr int kStageFloats = 2 * kDepth * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));
constexpr int kMaxBlock = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_dw_kernel(const float* __restrict__ x,
               const float* __restrict__ dy,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               float* __restrict__ out,  // dw (splits == 1) or part (splits > 1)
               int64_t n_blocks, int64_t batch, int64_t x_stride, int64_t dy_stride,
               int bm, int bn) {
  extern __shared__ __align__(16) float smem[];
  const int64_t i = blockIdx.x;
  const int n_tiles = (bn + kTile - 1) / kTile;
  const int m0 = static_cast<int>(blockIdx.y) / n_tiles * kTile;
  const int n0 = static_cast<int>(blockIdx.y) % n_tiles * kTile;
  const int64_t split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int m_valid = min(kTile, bm - m0);
  const int n_valid = min(kTile, bn - n0);

  const int64_t chunks = (batch + kDepth - 1) / kDepth;
  const int64_t first = chunks * split / splits;
  const int64_t n_steps = chunks * (split + 1) / splits - first;
  const float* xt = x + static_cast<int64_t>(rows[i]) * bm + m0;
  const float* dyt = dy + static_cast<int64_t>(cols[i]) * bn + n0;

  // Stage `step` of the run: samples [(first + step) * kDepth, ... + kDepth).
  auto load = [&](int64_t step) {
    float* xs = smem + (step % kStages) * kStageFloats;
    float* ys = xs + kDepth * kLd;
    const int64_t b0 = (first + step) * kDepth;
    const int k_valid = batch - b0 < kDepth ? static_cast<int>(batch - b0) : kDepth;
    const float* xb = xt + b0 * x_stride;
    const float* yb = dyt + b0 * dy_stride;
    if constexpr (kVec) {
      for (int idx = tid; idx < kDepth * (kTile / 4); idx += kThreads) {
        const int k = idx / (kTile / 4), e = (idx % (kTile / 4)) * 4;
        const bool okx = k < k_valid && e < m_valid;
        const bool oky = k < k_valid && e < n_valid;
        tf32x3::cp_async16(xs + k * kLd + e, okx ? xb + k * x_stride + e : x, okx ? 16 : 0);
        tf32x3::cp_async16(ys + k * kLd + e, oky ? yb + k * dy_stride + e : dy, oky ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int k = idx / kTile, e = idx % kTile;
        const bool okx = k < k_valid && e < m_valid;
        const bool oky = k < k_valid && e < n_valid;
        tf32x3::cp_async4(xs + k * kLd + e, okx ? xb + k * x_stride + e : x, okx ? 4 : 0);
        tf32x3::cp_async4(ys + k * kLd + e, oky ? yb + k * dy_stride + e : dy, oky ? 4 : 0);
      }
    }
  };

  float acc[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][j][r] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st);
    tf32x3::cp_async_commit();
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();                       // ... for every thread; the oldest buffer is free
    if (step + kStages - 1 < n_steps) load(step + kStages - 1);
    tf32x3::cp_async_commit();

    const float* xs = smem + (step % kStages) * kStageFloats;
    const float* ys = xs + kDepth * kLd;
    const int64_t b0 = (first + step) * kDepth;
    const int k_valid = batch - b0 < kDepth ? static_cast<int>(batch - b0) : kDepth;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      if (kk >= k_valid) break;  // the rest of the chunk is zero-filled
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float* xa = xs + (kk + t) * kLd + wm + 16 * a + g;  // A[m][b] = xs[b][m]
        tf32x3::split(xa[0], a_hi[a][0], a_lo[a][0]);
        tf32x3::split(xa[8], a_hi[a][1], a_lo[a][1]);
        tf32x3::split(xa[4 * kLd], a_hi[a][2], a_lo[a][2]);
        tf32x3::split(xa[4 * kLd + 8], a_hi[a][3], a_lo[a][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* yj = ys + (kk + t) * kLd + wn + 8 * j + g;
        tf32x3::split(yj[0], b_hi[j][0], b_lo[j][0]);
        tf32x3::split(yj[4 * kLd], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) tf32x3::mma3(acc[a][j], a_hi[a], a_lo[a], b_hi[j], b_lo[j]);
    }
  }
  tf32x3::cp_async_wait<0>();

  float* o = out + (split * n_blocks + i) * bm * bn + static_cast<int64_t>(m0) * bn + n0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + 16 * a + g + 8 * h;
      if (m >= m_valid) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 8 * j + 2 * t;
        if (n < n_valid) o[static_cast<int64_t>(m) * bn + n] = acc[a][j][2 * h];
        if (n + 1 < n_valid) o[static_cast<int64_t>(m) * bn + n + 1] = acc[a][j][2 * h + 1];
      }
    }
  }
}

bool smem_set[2][64];

// --- the bf16 instance --------------------------------------------------------

constexpr int kWarpgroup = 128;
constexpr int kConsumersH = 2;                               // warpgroups of 64 tile rows
constexpr int kThreadsH = kConsumersH * kWarpgroup + 32;     // + the producer warp
constexpr int kChunkH = 64;                                  // batch rows a stage
constexpr int kBoxBytes = kChunkH * 64 * 2;                  // a 64 x 64 box: 8 KB
constexpr int kStagesH = 3;                                  // ring stages
constexpr int kCtasH = 2;                                    // CTAs an SM
using RingH = sm90::Ring<kStagesH, 4 * kBoxBytes>;           // x boxes m 0.., 64..; dy boxes
constexpr int kPitchH = kMaxBlock + 8;                       // f32 partial rows
constexpr int kPitchB = kMaxBlock + 8;                       // bf16 output rows
constexpr int kMaxSplits = 8;                                // the portable cluster size
static_assert(kMaxBlock * kPitchH * 4 <= kStagesH * 4 * kBoxBytes, "the partial fits in the ring");
// The cluster's receive slots lie after the ring: one CTA an SM.
using SumH = sm90::ClusterSum<kPitchH, kMaxSplits>;
constexpr int area_max() {
  int most = 0;
  for (int size = 2; size <= kMaxSplits; ++size)
    most = SumH::recv_area_bytes(size) > most ? SumH::recv_area_bytes(size) : most;
  return most;
}
constexpr int kSmemMaxH = RingH::kSmem + area_max();
static_assert(kSmemMaxH <= 232448, "a CTA's shared memory on sm_90");

// Dynamic shared memory of a launch in clusters of `size`.
constexpr int smem_for(int size) {
  return RingH::kSmem + (size > 1 ? SumH::recv_area_bytes(size) : 0);
}

// One CTA per (tile i = blockIdx.x / splits, batch run s = blockIdx.x %
// splits = its rank in the cluster).
__global__ void __launch_bounds__(kThreadsH, kCtasH)
bsmm_dw_bf16_kernel(const __grid_constant__ CUtensorMap x_map,   // (bm, grid_m, batch)
                    const __grid_constant__ CUtensorMap dy_map,  // (bn, grid_n, batch)
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols,
                    __nv_bfloat16* __restrict__ dw,
                    int64_t batch, int bm, int bn, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const int64_t i = blockIdx.x / splits;
  const int s_run = static_cast<int>(blockIdx.x % splits);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t chunks = (batch + kChunkH - 1) / kChunkH;
  const int64_t first = chunks * s_run / splits;
  const int steps = static_cast<int>(chunks * (s_run + 1) / splits - first);
  const RingH ring(smem_raw);
  const SumH sum(bm, splits, s_run);

  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.0f;
  if (warp == kConsumersH * 4) {
    // The producer: lane 0 sets up the barriers and starts loading at once;
    // it waits for a free stage and issues its four boxes.
    if (lane == 0) ring.init(kConsumersH, sum.recv_bytes());
    __syncwarp();
    sm90::bar_arrive(1, kThreadsH);  // the barriers are ready for the consumers
    // the sum's receive slots lie after the ring: ready once the barriers are
    if (splits > 1) sm90::cluster_arrive_relaxed();
    if (lane == 0) {
      const int row = rows[i], col = cols[i];
      for (int step = 0; step < steps; ++step) {
        const int s = step % kStagesH;
        const int b0 = static_cast<int>((first + step) * kChunkH);
        if (step >= kStagesH) sm90::mbar_wait(ring.empty(s), (step / kStagesH - 1) & 1);
        sm90::mbar_arrive_expect_tx(ring.full(s), 4 * kBoxBytes);
        for (int h = 0; h < 2; ++h) {
          sm90::tma_load_3d(ring.stage(s) + h * kBoxBytes, &x_map, ring.full(s), 64 * h, row, b0);
          sm90::tma_load_3d(ring.stage(s) + (2 + h) * kBoxBytes, &dy_map, ring.full(s), 64 * h,
                            col, b0);
        }
      }
    }
    __syncwarp();
  } else {
    // A consumer warpgroup: tile rows 64 * wg.. (x box wg, one 64-wide atom
    // of M) against all 128 columns (dy's two boxes, LBO apart); a k16 step
    // is 16 batch rows of both.
    const int wg = warp / 4;
    sm90::bar_sync(1, kThreadsH);
    if (splits > 1) sm90::cluster_arrive_relaxed();
    sm90::wgmma_fence();
    sm90::fence_operands(acc);
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStagesH;
      sm90::mbar_wait(ring.full(s), (step / kStagesH) & 1);
      const uint32_t a = ring.stage(s) + wg * kBoxBytes;
      const uint32_t b = ring.stage(s) + 2 * kBoxBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunkH / 16; ++k)
        sm90::wgmma_m64n128k16<1, 1>(acc, sm90::desc_sw128(a + 2048 * k, kBoxBytes, 1024),
                                     sm90::desc_sw128(b + 2048 * k, kBoxBytes, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (step > 0 && tid % kWarpgroup == 0) sm90::mbar_arrive(ring.empty((step - 1) % kStagesH));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
  }
  const bool consumer = warp < kConsumersH * 4;
  const int row0 = 64 * (warp / 4), tid_in_wg = tid % kWarpgroup;
  __nv_bfloat16* out = dw + i * bm * bn;
  if (splits == 1) {  // no cluster: the tile rounds once into the ring, then out
    auto* stage_b = reinterpret_cast<__nv_bfloat16*>(ring.ptr);
    __syncthreads();  // every product has read its stage
    if (consumer) sm90::stage_bf16<kPitchB>(stage_b, row0, tid_in_wg, acc);
    __syncthreads();
    sm90::copy_rows<kPitchB>(stage_b, bm, bn, out, bn, tid, kThreadsH);
    return;
  }
  // The cluster's sum (sm90::ClusterSum): the partial takes the ring once its
  // products are done; the receive slots lie after the ring, ready before any
  // CTA's loads began.
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring.ptr);
  float* recv = reinterpret_cast<float*>(ring.ptr + RingH::kAreaOffset);
  if (consumer) sm90::store_partial<kPitchH>(part, row0, tid_in_wg, acc);
  sm90::fence_proxy_async();
  __syncthreads();
  sm90::cluster_wait();
  if (tid == 0) sum.send(ring.base, sm90::smem_u32(recv), ring.recv_bar());
  sm90::mbar_wait<true>(ring.recv_bar(), 0);
  sum.sum_store(part, recv, bn, out, bn, tid, kThreadsH);
  sm90::cluster_arrive_relaxed();  // this CTA has every byte sent to it: ...
  sm90::cluster_wait();            // ... once all have, no copy still reads a staging
}

bool smem_set_bf16[64];

}  // namespace

extern "C" int bsmm_dw_f32(const void* x, const void* dy, const void* rows,
                           const void* cols, void* dw, void* part,
                           int64_t n_blocks, int64_t batch, int64_t grid_m, int64_t grid_n,
                           int bm, int bn, int splits, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffff || grid_m < 1 || grid_n < 1 ||
      splits < 1 || splits > 65535 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = bm % 4 == 0 && bn % 4 == 0 && tf32x3::aligned16(x) && tf32x3::aligned16(dy);
  auto kernel = vec ? &bsmm_dw_kernel<true> : &bsmm_dw_kernel<false>;
  err = tf32x3::allow_smem(kernel, device, kSmemBytes, smem_set[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = ((bm + kTile - 1) / kTile) * ((bn + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned int>(n_blocks), static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(splits));
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      out, n_blocks, batch, grid_m * bm, grid_n * bn, bm, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(tf32x3::launch_sum_parts(
      static_cast<const float*>(part), static_cast<float*>(dw), n_blocks * bm * bn, splits, s));
}

// The bf16 instance: x, dy and dw bf16, one launch in clusters of `splits`
// CTAs (1..8). bm and bn are multiples of 16 up to 128; x, dy and dw 16-byte
// aligned; batch and n_blocks positive.
extern "C" int bsmm_dw_bf16(const void* x, const void* dy, const void* rows,
                            const void* cols, void* dw,
                            int64_t n_blocks, int64_t batch, int64_t grid_m, int64_t grid_n,
                            int bm, int bn, int splits, int device, void* stream) {
  if (bm < 16 || bm > kMaxBlock || bm % 16 || bn < 16 || bn > kMaxBlock || bn % 16 ||
      batch < 1 || batch > 0x7fffffff || n_blocks < 1 || grid_m < 1 || grid_n < 1 ||
      splits < 1 || splits > kMaxSplits || n_blocks * splits > 0x7fffffff ||
      !tf32x3::aligned16(x) || !tf32x3::aligned16(dy) || !tf32x3::aligned16(dw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map, dy_map;
  err = sm90::encode_bf16_3d(&x_map, x, bm, grid_m, batch, bm, grid_m * bm, 64, 1, kChunkH);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::encode_bf16_3d(&dy_map, dy, bn, grid_n, batch, bn, grid_n * bn, 64, 1, kChunkH);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tf32x3::allow_smem(&bsmm_dw_bf16_kernel, device, kSmemMaxH, smem_set_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::launch_clusters(
      &bsmm_dw_bf16_kernel, dim3(static_cast<unsigned>(n_blocks * splits)), splits, kThreadsH,
      smem_for(splits), static_cast<cudaStream_t>(stream), x_map, dy_map,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<__nv_bfloat16*>(dw), batch, bm, bn, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `splits` CTAs of the bf16 instance the card holds at
// once (cudaOccupancyMaxActiveClusters), into *out: for the probe.
extern "C" int bsmm_dw_bf16_max_clusters(int splits, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = tf32x3::allow_smem(&bsmm_dw_bf16_kernel, device, kSmemMaxH, smem_set_bf16);
  if (err == cudaSuccess)
    err = sm90::max_active_clusters(&bsmm_dw_bf16_kernel, splits, kThreadsH,
                                     smem_for(splits), out);
  return static_cast<int>(err);
}
