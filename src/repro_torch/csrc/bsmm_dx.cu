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
// 1024), at 8 x 256 tokens). The Pallas _dx_kernel takes bf16 as it is: dy
// and the tiles in bf16, each product on the MXU into its f32 VMEM scratch,
// rounded once at the flush. Here the same: mma.sync m16n8k16 bf16 into f32,
// the products of a block-row summed in f32 in one fixed order, rounded once
// (__float2bfloat16_rn). Tile sides are multiples of 16 (the MMA's k; the
// wrapper raises for others). The design is kernel C's rows route with the
// tile's axes turned:
//   * one block of 8 warps per (block-row r, 64 features of bm, 64 batch
//     rows); warps are 4 groups of 16 rows x 2 k-groups, and the block-row's
//     flattened k (bn / 16 steps a slot, slot after slot in the row-sorted
//     order, values[perm_r]) is dealt to the k-groups in turn; the two
//     groups' f32 partials meet in shared memory after the ring and the
//     first adds the second's before the single store: no second pass, no
//     f32 partials in device memory, no atomics, the same bits every run;
//   * a cp.async ring of 3 slot stages, all issued before the loop, with
//     the wait that counts them (ring - 2 pending from step 1: slot j is
//     commit group j): the W slab ws[m][n] as values[perm] lies (64 rows of
//     bn) and the dy slab ds[b][n] (64 rows of the slot's block-column), both
//     at 272-byte rows, so the 8 row addresses of every ldmatrix fall on 8
//     distinct 16-byte bank groups; dy's A fragments by ldmatrix, W^T's B
//     fragments by ldmatrix of the [m][n] slab without .trans (B[k][m] =
//     W[m][k] is a column-major fragment there);
//   * a block-row with no slot stores +0 (W_out's 22 block-rows hold 15
//     tiles, and autograd reads every row of dx); no split: at the LM's
//     2,048 rows the grid already holds 32 batch tiles per block-row.
// What bounds it: bytes. Through W_out at 2,048 rows dy is 4.2 MB, the 15
// tiles 0.5 MB and dx 11.5 MB, 4.8 us at 3.35 TB/s; its 1.0 GFLOP take
// 1.0 us at the 989 TFLOP/s bf16 rate. Each block reads its slots' dy slabs
// and tiles once; dy is read again by each of a block-row's 2 feature slices
// and each tile by each of the 32 batch tiles, through L2.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
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

using namespace bf16mma;

constexpr int kLdSlab = kMaxBlock + 8;  // slab rows: 136 bf16 = 272 bytes
constexpr int kRowsH = 64;              // batch rows per block
constexpr int kFeatH = 64;              // dx features (of bm) per block
constexpr int kRingH = 3;               // slot stages
constexpr int kWarpsH = kThreads / 32;
constexpr int kMWH = kRowsH / 16;       // warps: 4 groups of 16 rows ...
constexpr int kKWH = kWarpsH / kMWH;    // ... x 2 k-groups
constexpr int kNFH = kFeatH / 8;        // a warp's n8 fragments: 8
constexpr int kStageH = (kFeatH + kRowsH) * kLdSlab;  // bf16 elements
constexpr int kSmemH = kRingH * kStageH * static_cast<int>(sizeof(__nv_bfloat16));

// Load one slot into a stage: the W slab ws[m][n] (kFeatH rows of the
// tile's rows m0.., all bn columns, as values[perm] lies in memory) and the
// dy slab ds[b][n] (kRowsH batch rows from b0, the slot's block-column).
// Rows past m_valid or b_valid are zero-filled; bn is a multiple of 16 and
// both operands 16-byte aligned, so every 16-byte chunk is all in or all out.
__device__ __forceinline__ void load_dx_slot(__nv_bfloat16* ws,
                                             const __nv_bfloat16* __restrict__ dy,
                                             const __nv_bfloat16* __restrict__ values,
                                             int32_t col, int32_t perm, int64_t b0, int b_valid,
                                             int m0, int m_valid, int64_t dy_stride, int bm,
                                             int bn, int tid) {
  const int chunks = bn / 8;
  __nv_bfloat16* ds = ws + kFeatH * kLdSlab;
  const __nv_bfloat16* wt = values + static_cast<int64_t>(perm) * bm * bn +
                            static_cast<int64_t>(m0) * bn;
  for (int idx = tid; idx < kFeatH * chunks; idx += kThreads) {
    const int m = idx / chunks, k = (idx % chunks) * 8;
    const bool ok = m < m_valid;
    cp_async16_bf16(ws + m * kLdSlab + k, ok ? wt + static_cast<int64_t>(m) * bn + k : values,
                    ok ? 16 : 0);
  }
  const __nv_bfloat16* dt = dy + b0 * dy_stride + static_cast<int64_t>(col) * bn;
  for (int idx = tid; idx < kRowsH * chunks; idx += kThreads) {
    const int b = idx / chunks, k = (idx % chunks) * 8;
    const bool ok = b < b_valid;
    cp_async16_bf16(ds + b * kLdSlab + k, ok ? dt + b * dy_stride + k : dy, ok ? 16 : 0);
  }
}

// One block per (block-row r, kFeatH features from m0, kRowsH batch rows
// from b0). The block-row's slots [row_ptr[r], row_ptr[r+1]) are walked in
// the row-sorted order through a ring of kRingH slot stages; the slot's
// flattened k (bn / 16 steps a slot, slot after slot) is dealt to the
// k-groups in turn, step j to group j mod kKWH, as kernel C's rows route
// deals a column's. A warp holds dy (16 rows x 16 k, ldmatrix) and W^T (16 k
// x 8 features, ldmatrix of the [m][n] slab without .trans: B[k][m] =
// W[m][k] is a column-major fragment there) a step.
__global__ void __launch_bounds__(kThreads)
bsmm_dx_bf16_kernel(const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ values,
                    const int32_t* __restrict__ cols_r,
                    const int32_t* __restrict__ perm_r,
                    const int64_t* __restrict__ row_ptr,
                    __nv_bfloat16* __restrict__ dx,
                    int64_t batch, int64_t dy_stride, int64_t dx_stride, int bm, int bn) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  const int slices = (bm + kFeatH - 1) / kFeatH;
  const int64_t r = blockIdx.x / slices;
  const int m0 = static_cast<int>(blockIdx.x % slices) * kFeatH;
  const int m_valid = min(kFeatH, bm - m0);
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kRowsH;
  const int b_valid = batch - b0 < kRowsH ? static_cast<int>(batch - b0) : kRowsH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = warp % kMWH, kw = warp / kMWH;
  const int64_t lo = row_ptr[r];
  const int len = static_cast<int>(row_ptr[r + 1] - lo);
  const int ks = bn / 16;

  float acc[kNFH][4];
#pragma unroll
  for (int f = 0; f < kNFH; ++f)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[f][q] = 0.0f;

  // The first kRingH slots go out at once; their (and the next slot's)
  // indices are read before any copy is issued, as in kernel C's routes.
  int32_t col[kRingH + 1], perm[kRingH + 1];
#pragma unroll
  for (int st = 0; st <= kRingH; ++st) {
    col[st] = st < len ? cols_r[lo + st] : 0;
    perm[st] = st < len ? perm_r[lo + st] : 0;
  }
#pragma unroll
  for (int st = 0; st < kRingH; ++st) {
    if (st < len)
      load_dx_slot(smem + st * kStageH, dy, values, col[st], perm[st], b0, b_valid, m0, m_valid,
                   dy_stride, bm, bn, tid);
    tf32x3::cp_async_commit();
  }
  int32_t next_col = col[kRingH], next_perm = perm[kRingH];
  // this lane's ldmatrix rows: A from the dy slab (rows 16 * mw.., k from
  // kk), B from the W slab (features 16h.., k from kk)
  const int a_off = kFeatH * kLdSlab +
                    (16 * mw + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdSlab + (lane >> 4) * 8;
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * kLdSlab + ((lane >> 3) & 1) * 8;
  for (int step = 0; step < len; ++step) {
    // slot j is commit group j (the prologue's kRingH, then one a step from
    // step 1): before step s's wait kRingH + s - 1 groups are out (kRingH at
    // step 0) and group s must be done
    if (step == 0) {
      tf32x3::cp_async_wait<kRingH - 1>();
    } else {
      tf32x3::cp_async_wait<kRingH - 2>();
    }
    __syncthreads();  // ... for every thread; the last step's stage is free
    if (step > 0) {
      if (step + kRingH - 1 < len) {
        load_dx_slot(smem + ((step + kRingH - 1) % kRingH) * kStageH, dy, values, next_col,
                     next_perm, b0, b_valid, m0, m_valid, dy_stride, bm, bn, tid);
        if (step + kRingH < len) {
          next_col = cols_r[lo + step + kRingH];
          next_perm = perm_r[lo + step + kRingH];
        }
      }
      tf32x3::cp_async_commit();
    }

    const __nv_bfloat16* stage = smem + (step % kRingH) * kStageH;
    for (int q = ((kw - step * ks) % kKWH + kKWH) % kKWH; q < ks; q += kKWH) {
      const int kk = 16 * q;
      uint32_t a[4], b[kNFH][2];
      tf32x3::ldmatrix_x4(smem_addr(stage + a_off + kk), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int h = 0; h < kNFH / 2; ++h)
        tf32x3::ldmatrix_x4(smem_addr(stage + b_off + 16 * h * kLdSlab + kk), b[2 * h][0],
                            b[2 * h][1], b[2 * h + 1][0], b[2 * h + 1][1]);
#pragma unroll
      for (int f = 0; f < kNFH; ++f) mma_bf16_add(acc[f], a, b[f]);
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the k-groups' partials meet in it

  float4* red = reinterpret_cast<float4*>(smem_bytes);  // [kKWH][kMWH][kNFH][32]
  if (kw > 0) {
#pragma unroll
    for (int f = 0; f < kNFH; ++f)
      red[((kw * kMWH + mw) * kNFH + f) * 32 + lane] =
          make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
  }
  __syncthreads();
  if (kw > 0) return;
  for (int w = 1; w < kKWH; ++w) {
#pragma unroll
    for (int f = 0; f < kNFH; ++f) {
      const float4 p = red[((w * kMWH + mw) * kNFH + f) * 32 + lane];
      acc[f][0] += p.x;
      acc[f][1] += p.y;
      acc[f][2] += p.z;
      acc[f][3] += p.w;
    }
  }
  // c0, c1 = dx[g][2t..2t+1] of fragment f's 8 features, c2, c3 row g + 8:
  // the f32 sum rounded once, one 4-byte store a pair. An empty block-row
  // stores +0.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = 16 * mw + g + 8 * h;
    if (b >= b_valid) continue;
    __nv_bfloat16* xr = dx + (b0 + b) * dx_stride + r * bm + m0 + 2 * t;
#pragma unroll
    for (int f = 0; f < kNFH; ++f) {
      if (8 * f >= m_valid) break;  // m_valid is a multiple of 16
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(acc[f][2 * h]);
      v.y = __float2bfloat16_rn(acc[f][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(xr + 8 * f) = v;
    }
  }
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

// The bf16 instance: dy, values and dx bf16, one launch (no split). bm and bn
// are multiples of 16 up to 128; dy and values 16-byte aligned, dx 4-byte.
extern "C" int bsmm_dx_bf16(const void* dy, const void* values, const void* cols_r,
                            const void* perm_r, const void* row_ptr, void* dx,
                            int64_t batch, int64_t grid_m, int64_t grid_n,
                            int bm, int bn, int device, void* stream) {
  if (bm < 16 || bm > kMaxBlock || bm % 16 || bn < 16 || bn > kMaxBlock || bn % 16 ||
      batch < 0 || grid_m < 1 || grid_n < 1 || !tf32x3::aligned16(dy) ||
      !tf32x3::aligned16(values) || (reinterpret_cast<uintptr_t>(dx) & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kRowsH - 1) / kRowsH;
  const int64_t blocks_x = grid_m * ((bm + kFeatH - 1) / kFeatH);
  if (batch_tiles > 65535 || blocks_x > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles == 0) return static_cast<int>(cudaGetLastError());
  err = tf32x3::allow_smem(&bsmm_dx_bf16_kernel, device, kSmemH, smem_set_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(batch_tiles));
  bsmm_dx_bf16_kernel<<<grid, kThreads, kSmemH, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(values),
      static_cast<const int32_t*>(cols_r), static_cast<const int32_t*>(perm_r),
      static_cast<const int64_t*>(row_ptr), static_cast<__nv_bfloat16*>(dx), batch,
      grid_n * bn, grid_m * bm, bm, bn);
  return static_cast<int>(cudaGetLastError());
}
