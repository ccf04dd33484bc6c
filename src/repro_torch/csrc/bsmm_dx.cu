// Kernel D: the block-sparse input gradient.
//
//   dx[b, r*bm + m] = sum_{j in [row_ptr[r], row_ptr[r+1])} sum_n dy[b, cols_r[j]*bn + n] * values[perm_r[j]][m][n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_dx (the Pallas
// _dx_kernel). The Pallas kernel walks the row-sorted slot order on a
// sequential grid and accumulates each revisited dx tile in VMEM, zeroed
// where first_row is 1, and never visits an input block-row that no slot
// covers. Here each block owns one dx tile and walks its row's contiguous
// slot range (row_ptr, from the row-sorted rows_r) in order: no atomics, a
// deterministic sum. An input block-row that no slot covers comes out as
// exact zeros, so the gradient of an input feature that feeds nothing is 0.
//
// What bounds it on an H100: the same flops and bytes as kernel C (2 * B *
// nb * bm * bn flops; dy, the live tiles and dx), so the f32 units at
// batch 128 and 128 x 128 tiles. f32 FMAs from registers; no tensor cores
// yet.
//
// Design:
//   * One block per (input block-row r, 64-row batch tile, 64-wide slice of
//     the tile's bm columns); 256 threads as 16 x 16, each owning a 4 x 4
//     micro-tile at stride 16.
//   * The contraction runs over the slot's bn columns in steps of 32. The dy
//     slice (64 x 32) is staged as in kernel C. The W tile is read
//     transposed: its slice W[m0 .. m0+64][k0 .. k0+32] is loaded with
//     consecutive threads on consecutive k (the contiguous axis of a tile,
//     so the read stays coalesced) and stored to shared memory as [k][m]
//     with a pad of one, so neither the store nor the compute loop's reads
//     conflict on banks.
//   * Ragged batch tiles and narrow tiles are masked. Any bm and bn from 1
//     to 128.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 32;
constexpr int kThreads = 256;
constexpr int kMicro = 4;
constexpr int kPad = kTile + 1;
constexpr int kMaxBlock = 128;

__global__ void __launch_bounds__(kThreads)
bsmm_dx_kernel(const float* __restrict__ dy,
               const float* __restrict__ values,
               const int32_t* __restrict__ cols_r,
               const int32_t* __restrict__ perm_r,
               const int64_t* __restrict__ row_ptr,
               float* __restrict__ dx,
               int64_t batch, int64_t dy_stride, int64_t dx_stride,
               int bm, int bn) {
  __shared__ float ys[kDepth][kPad];  // ys[k][b] = dy[b0 + b, cols_r[j]*bn + k0 + k]
  __shared__ float wt_s[kDepth][kPad];  // wt_s[k][m] = values[perm_r[j]][m0 + m][k0 + k]
  const int64_t r = blockIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int m0 = static_cast<int>(blockIdx.z) * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b_valid = batch - b0 < kTile ? static_cast<int>(batch - b0) : kTile;
  const int m_valid = min(kTile, bm - m0);

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int64_t begin = row_ptr[r];
  const int64_t end = row_ptr[r + 1];
  for (int64_t s = begin; s < end; ++s) {
    const float* dyt = dy + b0 * dy_stride + static_cast<int64_t>(cols_r[s]) * bn;
    const float* wt = values + static_cast<int64_t>(perm_r[s]) * bm * bn
                      + static_cast<int64_t>(m0) * bn;
    for (int k0 = 0; k0 < bn; k0 += kDepth) {
      const int k_valid = min(kDepth, bn - k0);
      for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
        const int b = idx / kDepth;
        const int k = idx % kDepth;
        ys[k][b] = (b < b_valid && k < k_valid) ? __ldg(dyt + b * dy_stride + k0 + k) : 0.0f;
      }
      for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
        const int m = idx / kDepth;
        const int k = idx % kDepth;
        wt_s[k][m] = (m < m_valid && k < k_valid)
                         ? __ldg(wt + static_cast<int64_t>(m) * bn + k0 + k) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < k_valid; ++k) {
        float a[kMicro];
        float w[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = ys[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) w[j] = wt_s[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* dxt = dx + b0 * dx_stride + r * bm + m0;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int b = ty + 16 * i;
    if (b >= b_valid) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int m = tx + 16 * j;
      if (m < m_valid) dxt[b * dx_stride + m] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bsmm_dx_f32(const void* dy, const void* values, const void* cols_r,
                           const void* perm_r, const void* row_ptr, void* dx,
                           int64_t batch, int64_t grid_m, int64_t grid_n,
                           int bm, int bn, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_m > 0x7fffffff || grid_n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kTile - 1) / kTile;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles > 0) {
    const dim3 grid(static_cast<unsigned int>(grid_m), static_cast<unsigned int>(batch_tiles),
                    static_cast<unsigned int>((bm + kTile - 1) / kTile));
    bsmm_dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dy), static_cast<const float*>(values),
        static_cast<const int32_t*>(cols_r), static_cast<const int32_t*>(perm_r),
        static_cast<const int64_t*>(row_ptr), static_cast<float*>(dx),
        batch, grid_n * bn, grid_m * bm, bm, bn);
  }
  return static_cast<int>(cudaGetLastError());
}
