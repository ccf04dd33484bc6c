// Kernel D: the block-sparse input gradient.
//
//   dx[b, r*bm + m] = sum_{j in [row_ptr[r], row_ptr[r+1])} sum_n dy[b, cols_r[j]*bn + n] * values[perm_r[j]][m][n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_dx (the Pallas
// _dx_kernel). The Pallas kernel walks the row-sorted slot order on a
// sequential grid and accumulates each revisited dx tile in VMEM, zeroed
// where first_row is 1, and never visits an input block-row that no slot
// covers. Here blocks run in parallel: the row-sorted order makes the slots
// of one block-row one contiguous range, given by row_ptr, and each block
// sums a contiguous run of that range itself. There are no atomics, and every
// sum runs in a fixed order, so the same inputs give the same bits on every
// run. An input block-row that no slot covers comes out as exact zeros (a run
// with no slot writes +0, and +0 + +0 = +0), so the gradient of an input
// feature that feeds nothing is 0.
//
// What bounds it on an H100: the same flops and bytes as kernel C (2 * B *
// nb * bm * bn flops, 3x that on the tensor cores in 3xTF32; dy, the live
// tiles and dx). At batch 128 and 128 x 128 tiles a layer of 32 tiles is 134
// MFLOP, 2.0 us at the f32 rate and 0.8 us at the 3xTF32 tensor rate: what
// sets the time is one block's chain and how many blocks are in flight. The
// scalar version this replaces (f32 FMAs, one barrier-bound 32-deep slice at
// a time, one block walking a whole block-row) took 30.9, 104.6 and 19.3 us
// on layers 1-3, 154.9 us a training step (NVIDIA H100 80GB HBM3, 700 W):
// layer 2 has 8 block-rows of ~4 slots on 32 blocks.
//
// Design (kernel C's, csrc/bsmm_fwd.cu, with the roles of the tile's axes
// turned):
//   * Split rule. The wrapper cuts each block-row's range into P contiguous
//     runs, run p = [lo + len*p/P, lo + len*(p+1)/P), with P chosen on the
//     host from nb, grid_m, the batch and bm alone
//     (block_sparse_matmul.py::dx_parts: about one wave of blocks on the 132
//     SMs, at most ceil(nb / grid_m); 4 on the full-width model's layer 2, 1
//     on layers 1 and 3). P = 1 writes dx directly. P > 1 writes each run's
//     partial tile to part (P, B, grid_m*bm) and a second pass
//     (tf32x3.cuh::sum_parts) adds the P partials in index order.
//   * One block of 256 threads per (block-row r, run p, 64-row batch tile,
//     64-wide slice of bm); 8 warps as 2 x 4, each a 32 x 16 warp tile of
//     2 x 2 m16n8k8 products.
//   * A cp.async ring of 4 stages. A stage is a 32-deep slice (over the
//     slot's bn columns, the contraction) of one slot: the dy slice ds[b][k]
//     (64 x 32) and the W slice ws[m][k] (64 x 32), both at row pitch 36.
//     W is staged as it lies in memory (values[i] is [m][n], n contiguous),
//     so its copies are 16 bytes wide like dy's; the mma's B operand
//     B[k][m] = W[m][k] is then read along a row of ws: lane (g, t) needs
//     ws[g][t] and ws[g][t + 4], as it needs ds[g][t] (and rows g + 8,
//     columns t + 4) for A. Both are what ldmatrix.x4 hands out when f32 is
//     taken as pairs of b16: one instruction loads a warp's whole A fragment
//     (or its two B fragments) where 4-byte loads took four, and the 8 rows
//     of a matrix, 144 bytes apart, fall on 32 distinct banks. Staging
//     ws[k][m] instead would make the copy transpose, which cp.async cannot:
//     4-byte stores. The slices of
//     the run's slots are numbered in order, so the next slot's first slice
//     loads while this slot's last computes. 16-byte copies where bn is a
//     multiple of 4 and dy and values are 16-byte aligned, else 4-byte
//     copies. Masked elements (a ragged batch tile, bn below a slice, the
//     tail of bm) are zero-filled by the copy's source size.
//   * 3xTF32 on mma.sync (tf32x3.cuh): each 8-deep step sums its three
//     products in a fresh fragment, added to the running sum in f32. One SM
//     holds one block at the full-width shapes, so a block's time is its
//     chain of stages: a full 32-deep slice runs as straight-line code, so
//     that one 8-deep step's fragment loads and TF32 splits can overlap the
//     others' mma chains, and the fragments come by ldmatrix, since a warp's
//     shared-memory loads queue behind each other.
//
// The bf16 instance, bsmm_dx_bf16: the backward of kernel C's bf16
// instance, which the bfloat16 LM's training step runs twice a layer
// (models/layers.py::sparse_ffn_fwd under autograd: dx through W_out, dy
// (2048, 1024) -> (2048, 2816), and through W_in, (2048, 2816) -> (2048,
// 1024), at 8 x 256 tokens). It replaces the same Pallas _dx_kernel
// (src/repro/kernels/block_sparse_matmul.py:108, bsmm_dx at :127), which
// takes bf16 as it is: each product on the MXU into an f32 VMEM scratch,
// rounded once at the flush.
// What bounds it on an H100: bytes. At 2,048 rows, through W_in: dy 11.5 MB,
// the 22 tiles 0.7 MB, dx 4.2 MB, 4.9 us at 3.35 TB/s; through W_out: dy 4.2
// MB, the 15 tiles 0.5 MB, dx 11.5 MB, 4.8 us. Their 1.5 and 1.0 GFLOP take
// 1.5 and 1.0 us at the 989 TFLOP/s bf16 rate. Where the operands sit in L2
// (a training step's dy was just written), the L2's rate is the limit: the
// tiles are read again by every 128 rows, 22.5 MB through W_in.
// Design (sm90.cuh): per slot a plain "TN" product, dx[b][m] += sum_n
// dy[b][n] W[m][n]: A = the dy slab [b][n] and B[n][m] = W[m][n] as the tile
// lies in values[perm_r] are both K-major, so neither is transposed.
//   * One CTA per (block-row r, 128 batch rows), over all of bm and the
//     whole block-row: each dy element is read once per tile that uses it,
//     each tile once per 128 rows (through L2), and the block-row's slots
//     are added in their order in the CTA's registers and rounded once
//     (__float2bfloat16_rn): no atomics, no f32 partials, the same bits on
//     every launch.
//   * Warp-specialised: a producer warp sets up the mbarriers and starts
//     loading at once, keeping a ring of 3 stages in flight by TMA (a stage:
//     the dy box 128 rows x 64 of the slot's bn and the W box 128 of bm x the
//     same 64, 32 KB, the 128-byte swizzle); two consumer warpgroups each run
//     wgmma m64n128k16 over 64 rows into f32 registers and free a stage once
//     the next one's products are issued and its own have completed. 97 KB
//     of shared memory, 90 registers: two CTAs an SM.
//   * A long block-row is not split. W_in's row of 8 slots sets the time at
//     2,048 rows, but cut into runs over a cluster of 2 or 3 CTAs, summed in
//     distributed shared memory, it ran slower than whole on an H100: the
//     sum cost more than the shorter loop saved (and 3 runs took more than
//     one wave of CTAs).
//   * The rows round once into the freed ring and leave as whole 16-byte
//     rows (copy_rows), not as the accumulators' 8-byte pieces.
//   * A block-row with no slot stores +0 (W_out's 22 block-rows hold 15
//     tiles, and autograd reads every row of dx) and takes no ring.
//   * Ragged batches and tiles narrower than the boxes: TMA zero-fills what
//     lies outside dy or the tile (dy is mapped as (batch, grid_n, bn), so a
//     box never reaches into the next block-column), and rows past the batch
//     are not stored.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kTileB = 64;     // batch rows per block
constexpr int kTileM = 64;     // dx columns (of bm) per block
constexpr int kDepth = 32;     // contraction depth (of bn) of one stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps as 2 x 4, 32 x 16 each
constexpr int kLd = kDepth + 4;
constexpr int kStageFloats = (kTileB + kTileM) * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));
constexpr int kMaxBlock = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_dx_kernel(const float* __restrict__ dy,
               const float* __restrict__ values,
               const int32_t* __restrict__ cols_r,
               const int32_t* __restrict__ perm_r,
               const int64_t* __restrict__ row_ptr,
               float* __restrict__ out,  // dx (parts == 1) or part (parts > 1)
               int64_t batch, int64_t dy_stride, int64_t dx_stride,
               int bm, int bn, int parts) {
  extern __shared__ __align__(16) float smem[];
  const int64_t r = blockIdx.x / parts;
  const int p = static_cast<int>(blockIdx.x % parts);
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kTileB;
  const int m0 = static_cast<int>(blockIdx.z) * kTileM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wb = (warp / 4) * 32, wm = (warp % 4) * 16;
  const int b_valid = batch - b0 < kTileB ? static_cast<int>(batch - b0) : kTileB;
  const int m_valid = min(kTileM, bm - m0);
  const int k_steps = (bn + kDepth - 1) / kDepth;

  const int64_t begin = row_ptr[r];
  const int64_t len = row_ptr[r + 1] - begin;
  const int64_t lo = begin + len * p / parts;
  const int64_t hi = begin + len * (p + 1) / parts;
  const int64_t n_steps = (hi - lo) * k_steps;

  // Stage `step` of the run: slot lo + step / k_steps, depth slice step % k_steps.
  auto load = [&](int64_t step) {
    float* ds = smem + (step % kStages) * kStageFloats;
    float* ws = ds + kTileB * kLd;
    const int64_t s = lo + step / k_steps;
    const int k0 = static_cast<int>(step % k_steps) * kDepth;
    const int k_valid = min(kDepth, bn - k0);
    const float* dyt = dy + b0 * dy_stride + static_cast<int64_t>(cols_r[s]) * bn + k0;
    const float* wt = values + static_cast<int64_t>(perm_r[s]) * bm * bn
                      + static_cast<int64_t>(m0) * bn + k0;
    if constexpr (kVec) {
      for (int idx = tid; idx < kTileB * (kDepth / 4); idx += kThreads) {
        const int b = idx / (kDepth / 4), k = (idx % (kDepth / 4)) * 4;
        const bool ok = b < b_valid && k < k_valid;
        tf32x3::cp_async16(ds + b * kLd + k, ok ? dyt + b * dy_stride + k : dy, ok ? 16 : 0);
      }
      for (int idx = tid; idx < kTileM * (kDepth / 4); idx += kThreads) {
        const int m = idx / (kDepth / 4), k = (idx % (kDepth / 4)) * 4;
        const bool ok = m < m_valid && k < k_valid;
        tf32x3::cp_async16(ws + m * kLd + k, ok ? wt + static_cast<int64_t>(m) * bn + k : values,
                           ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kTileB * kDepth; idx += kThreads) {
        const int b = idx / kDepth, k = idx % kDepth;
        const bool ok = b < b_valid && k < k_valid;
        tf32x3::cp_async4(ds + b * kLd + k, ok ? dyt + b * dy_stride + k : dy, ok ? 4 : 0);
      }
      for (int idx = tid; idx < kTileM * kDepth; idx += kThreads) {
        const int m = idx / kDepth, k = idx % kDepth;
        const bool ok = m < m_valid && k < k_valid;
        tf32x3::cp_async4(ws + m * kLd + k, ok ? wt + static_cast<int64_t>(m) * bn + k : values,
                          ok ? 4 : 0);
      }
    }
  };

  // This lane's ldmatrix row, in bytes from a stage: lanes 8k to 8k + 7 give
  // matrix k's 8 rows. A (ds[b][k]): matrices (a0, a1, a2, a3) are rows
  // +0 / +8 at columns +0 / +4. B (ws[m][k], B[k][m] = W[m][k]): matrices
  // (b0, b1) of j = 0 then j = 1 are rows 8j at columns +0 / +4.
  const int mat = lane / 8, row = lane % 8;
  const uint32_t a_row = ((wb + row + 8 * (mat & 1)) * kLd + 4 * (mat >> 1)) * 4;
  const uint32_t b_row = (kTileB * kLd + (wm + 8 * (mat >> 1) + row) * kLd + 4 * (mat & 1)) * 4;

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

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

    const uint32_t stage = static_cast<uint32_t>(
        __cvta_generic_to_shared(smem + (step % kStages) * kStageFloats));
    const int k_valid = min(kDepth, bn - static_cast<int>(step % k_steps) * kDepth);
    auto step8 = [&](int kk) {
      uint32_t a[2][4], b[4];  // f32 bits: a[i] = (a0, a1, a2, a3), b = (b0, b1) of j = 0, 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tf32x3::ldmatrix_x4(stage + a_row + (16 * i * kLd + kk) * 4, a[i][0], a[i][1], a[i][2],
                            a[i][3]);
      }
      tf32x3::ldmatrix_x4(stage + b_row + kk * 4, b[0], b[1], b[2], b[3]);
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tf32x3::split(__uint_as_float(a[i][q]), a_hi[i][q], a_lo[i][q]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) tf32x3::split(__uint_as_float(b[2 * j + h]), b_hi[j][h], b_lo[j][h]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) tf32x3::mma3(acc[i][j], a_hi[i], a_lo[i], b_hi[j], b_lo[j]);
    };
    if (k_valid == kDepth) {  // straight-line code: the four steps' loads and mmas overlap
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 8) step8(kk);
    } else {  // a narrow tile: the rest of the slice is zero-filled
      for (int kk = 0; kk < k_valid; kk += 8) step8(kk);
    }
  }
  tf32x3::cp_async_wait<0>();

  float* xt = out + static_cast<int64_t>(p) * batch * dx_stride + b0 * dx_stride + r * bm + m0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = wb + 16 * i + g + 8 * h;
      if (b >= b_valid) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = wm + 8 * j + 2 * t;
        if (m < m_valid) xt[b * dx_stride + m] = acc[i][j][2 * h];
        if (m + 1 < m_valid) xt[b * dx_stride + m + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

bool smem_set[2][64];

// --- the bf16 instance --------------------------------------------------------

constexpr int kWarpgroup = 128;
constexpr int kConsumersH = 2;                               // warpgroups of 64 rows
constexpr int kThreadsH = kConsumersH * kWarpgroup + 32;     // + the producer warp
constexpr int kRowsH = 128;                                  // batch rows a CTA
constexpr int kBoxK = 64;                                    // k (of bn) a stage: 128 bytes
constexpr int kBoxBytes = kRowsH * kBoxK * 2;                // 16 KB
constexpr int kStagesH = 3;                                  // ring stages
constexpr int kCtasH = 2;                                    // CTAs an SM
using RingH = sm90::Ring<kStagesH, 2 * kBoxBytes>;           // dy box, then W box
constexpr int kPitchB = kMaxBlock + 8;                       // bf16 output rows
static_assert(kRowsH * kPitchB * 2 <= kStagesH * 2 * kBoxBytes, "the rows fit in the ring");

// One CTA per (block-row r = blockIdx.x, 128 batch rows from blockIdx.y * 128).
__global__ void __launch_bounds__(kThreadsH, kCtasH)
bsmm_dx_bf16_kernel(const __grid_constant__ CUtensorMap dy_map,  // (bn, grid_n, batch)
                    const __grid_constant__ CUtensorMap w_map,   // (bn, bm, nb)
                    const int32_t* __restrict__ cols_r,
                    const int32_t* __restrict__ perm_r,
                    const int64_t* __restrict__ row_ptr,
                    __nv_bfloat16* __restrict__ dx,
                    int64_t batch, int64_t dx_stride, int bm, int bn) {
  extern __shared__ unsigned char smem_raw[];
  const int64_t r = blockIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kRowsH;
  const int b_valid = batch - b0 < kRowsH ? static_cast<int>(batch - b0) : kRowsH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* out = dx + b0 * dx_stride + r * bm;
  const int64_t begin = row_ptr[r], len = row_ptr[r + 1] - begin;
  if (len == 0) {  // exact +0, no ring
    sm90::store_zero_rows(out, dx_stride, b_valid, bm, tid, kThreadsH);
    return;
  }
  const int64_t lo = begin, hi = begin + len;
  const int chunks = (bn + kBoxK - 1) / kBoxK;  // stages a slot
  const int steps = static_cast<int>(len) * chunks;
  const RingH ring(smem_raw);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if (warp == kConsumersH * 4) {
    // The producer: lane 0 sets up the barriers and starts loading at once;
    // its lanes read 32 slots' indices at a time; lane 0 waits for a free
    // stage and issues its two boxes.
    if (lane == 0) ring.init(kConsumersH, 0);  // no cluster: recv is unused
    __syncwarp();
    sm90::bar_arrive(1, kThreadsH);  // the barriers are ready for the consumers
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t j = base + lane;
      const int32_t my_col = j < hi ? cols_r[j] : 0, my_perm = j < hi ? perm_r[j] : 0;
      const int n = hi - base < 32 ? static_cast<int>(hi - base) : 32;
      for (int q = 0; q < n; ++q) {
        const int col = __shfl_sync(0xffffffffu, my_col, q);
        const int perm = __shfl_sync(0xffffffffu, my_perm, q);
        for (int k = 0; k < chunks; ++k) {
          const int step = static_cast<int>(base - lo + q) * chunks + k;
          const int s = step % kStagesH;
          if (lane == 0) {
            if (step >= kStagesH) sm90::mbar_wait(ring.empty(s), (step / kStagesH - 1) & 1);
            sm90::mbar_arrive_expect_tx(ring.full(s), 2 * kBoxBytes);
            sm90::tma_load_3d(ring.stage(s), &dy_map, ring.full(s), k * kBoxK, col,
                              static_cast<int>(b0));
            sm90::tma_load_3d(ring.stage(s) + kBoxBytes, &w_map, ring.full(s), k * kBoxK, 0,
                              perm);
          }
          __syncwarp();
        }
      }
    }
  } else {
    // A consumer warpgroup: rows 64 * wg.. of the dy box against the whole
    // W box, four k16 steps a stage; a stage is freed once the next one's
    // products are issued and its own have completed.
    const int wg = warp / 4;
    sm90::bar_sync(1, kThreadsH);
    sm90::wgmma_fence();
    sm90::fence_operands(acc);
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStagesH;
      sm90::mbar_wait(ring.full(s), (step / kStagesH) & 1);
      const uint32_t a = ring.stage(s) + wg * 64 * (kBoxK * 2);
      const uint32_t b = ring.stage(s) + kBoxBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBoxK / 16; ++k)
        sm90::wgmma_m64n128k16<0, 0>(acc, sm90::desc_sw128(a + 32 * k, 16, 1024),
                                     sm90::desc_sw128(b + 32 * k, 16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (step > 0 && tid % kWarpgroup == 0) sm90::mbar_arrive(ring.empty((step - 1) % kStagesH));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
  }
  // The rows round once into the ring, then out.
  const bool consumer = warp < kConsumersH * 4;
  auto* stage_b = reinterpret_cast<__nv_bfloat16*>(ring.ptr);
  __syncthreads();  // every product has read its stage
  if (consumer) sm90::stage_bf16<kPitchB>(stage_b, 64 * (warp / 4), tid % kWarpgroup, acc);
  __syncthreads();
  sm90::copy_rows<kPitchB>(stage_b, b_valid, bm, out, dx_stride, tid, kThreadsH);
}

bool smem_set_bf16[64];

}  // namespace

extern "C" int bsmm_dx_f32(const void* dy, const void* values, const void* cols_r,
                           const void* perm_r, const void* row_ptr, void* dx, void* part,
                           int64_t batch, int64_t grid_m, int64_t grid_n,
                           int bm, int bn, int parts, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_n < 1 || parts < 1 || grid_m * parts > 0x7fffffff ||
      (parts > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kTileB - 1) / kTileB;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles == 0) return static_cast<int>(cudaGetLastError());
  // every copy's offset is a multiple of bn (dy's row stride is grid_n * bn)
  const bool vec = bn % 4 == 0 && tf32x3::aligned16(dy) && tf32x3::aligned16(values);
  auto kernel = vec ? &bsmm_dx_kernel<true> : &bsmm_dx_kernel<false>;
  err = tf32x3::allow_smem(kernel, device, kSmemBytes, smem_set[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_m * parts),
                  static_cast<unsigned int>(batch_tiles),
                  static_cast<unsigned int>((bm + kTileM - 1) / kTileM));
  float* out = static_cast<float*>(parts > 1 ? part : dx);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(values),
      static_cast<const int32_t*>(cols_r), static_cast<const int32_t*>(perm_r),
      static_cast<const int64_t*>(row_ptr), out, batch, grid_n * bn, grid_m * bm, bm, bn, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  return static_cast<int>(tf32x3::launch_sum_parts(
      static_cast<const float*>(part), static_cast<float*>(dx), batch * grid_m * bm, parts, s));
}

// The bf16 instance: dy, values and dx bf16, one launch. bm and bn are
// multiples of 16 up to 128; dy, values and dx 16-byte aligned; batch and
// n_blocks positive.
extern "C" int bsmm_dx_bf16(const void* dy, const void* values, const void* cols_r,
                            const void* perm_r, const void* row_ptr, void* dx,
                            int64_t batch, int64_t grid_m, int64_t grid_n, int64_t n_blocks,
                            int bm, int bn, int device, void* stream) {
  if (bm < 16 || bm > kMaxBlock || bm % 16 || bn < 16 || bn > kMaxBlock || bn % 16 ||
      batch < 1 || batch > 0x7fffffff || n_blocks < 1 || n_blocks > 0x7fffffff ||
      grid_m < 1 || grid_m > 0x7fffffff || grid_n < 1 || !tf32x3::aligned16(dy) ||
      !tf32x3::aligned16(values) || !tf32x3::aligned16(dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kRowsH - 1) / kRowsH;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dy_map, w_map;
  err = sm90::encode_bf16_3d(&dy_map, dy, bn, grid_n, batch, bn, grid_n * bn, kBoxK, 1, kRowsH);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::encode_bf16_3d(&w_map, values, bn, bm, n_blocks, bn, static_cast<int64_t>(bm) * bn,
                             kBoxK, kRowsH, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tf32x3::allow_smem(&bsmm_dx_bf16_kernel, device, RingH::kSmem, smem_set_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(batch_tiles));
  bsmm_dx_bf16_kernel<<<grid, kThreadsH, RingH::kSmem, static_cast<cudaStream_t>(stream)>>>(
      dy_map, w_map, static_cast<const int32_t*>(cols_r), static_cast<const int32_t*>(perm_r),
      static_cast<const int64_t*>(row_ptr), static_cast<__nv_bfloat16*>(dx), batch,
      grid_m * bm, bm, bn);
  return static_cast<int>(cudaGetLastError());
}
