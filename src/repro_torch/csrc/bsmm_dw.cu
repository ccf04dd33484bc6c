// Kernel E: the block-sparse weight gradient.
//
//   dw[i][m][n] = sum_b x[b, rows[i]*bm + m] * dy[b, cols[i]*bn + n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_dw (the Pallas
// _dw_kernel), whose sequential grid (nb, B/bb) carries each slot's sum over
// batch tiles in VMEM. Here one block owns (a 64 x 64 part of) one slot's
// tile and reduces over the whole batch itself, in steps of 32 samples in a
// fixed order: no atomics, no split across blocks, a deterministic sum. A
// ragged last step is masked, not padded.
//
// What bounds it on an H100: 2 * B * nb * bm * bn flops against the bytes of
// x, dy and dw: the f32 units at batch 128 and 128 x 128 tiles. f32 FMAs from
// registers; no tensor cores yet.
//
// Design:
//   * One block per (slot i, 64-row slice of bm, 64-column slice of bn), so a
//     layer of nb 128 x 128 tiles runs 4 * nb blocks; 256 threads as 16 x 16,
//     each owning a 4 x 4 micro-tile at stride 16.
//   * Each step stages 32 samples of the slot's x columns (32 x 64) and dy
//     columns (32 x 64) in shared memory, read along the feature axis with
//     consecutive threads on consecutive addresses.
//   * Any bm and bn from 1 to 128.
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
bsmm_dw_kernel(const float* __restrict__ x,
               const float* __restrict__ dy,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               float* __restrict__ dw,
               int64_t batch, int64_t x_stride, int64_t dy_stride,
               int bm, int bn) {
  __shared__ float xs[kDepth][kPad];  // xs[k][m] = x[b0 + k, rows[i]*bm + m0 + m]
  __shared__ float ys[kDepth][kPad];  // ys[k][n] = dy[b0 + k, cols[i]*bn + n0 + n]
  const int64_t s = blockIdx.x;
  const int m0 = static_cast<int>(blockIdx.y) * kTile;
  const int n0 = static_cast<int>(blockIdx.z) * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m_valid = min(kTile, bm - m0);
  const int n_valid = min(kTile, bn - n0);
  const float* xt = x + static_cast<int64_t>(rows[s]) * bm + m0;
  const float* dyt = dy + static_cast<int64_t>(cols[s]) * bn + n0;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int64_t b0 = 0; b0 < batch; b0 += kDepth) {
    const int k_valid = batch - b0 < kDepth ? static_cast<int>(batch - b0) : kDepth;
    for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
      const int k = idx / kTile;
      const int m = idx % kTile;
      xs[k][m] = (k < k_valid && m < m_valid) ? __ldg(xt + (b0 + k) * x_stride + m) : 0.0f;
    }
    for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
      const int k = idx / kTile;
      const int n = idx % kTile;
      ys[k][n] = (k < k_valid && n < n_valid) ? __ldg(dyt + (b0 + k) * dy_stride + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < k_valid; ++k) {
      float a[kMicro];
      float g[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) g[j] = ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = dw + s * bm * bn + static_cast<int64_t>(m0) * bn + n0;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int m = ty + 16 * i;
    if (m >= m_valid) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int n = tx + 16 * j;
      if (n < n_valid) out[static_cast<int64_t>(m) * bn + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bsmm_dw_f32(const void* x, const void* dy, const void* rows,
                           const void* cols, void* dw,
                           int64_t n_blocks, int64_t batch, int64_t grid_m, int64_t grid_n,
                           int bm, int bn, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffff || grid_m < 1 || grid_n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    const dim3 grid(static_cast<unsigned int>(n_blocks),
                    static_cast<unsigned int>((bm + kTile - 1) / kTile),
                    static_cast<unsigned int>((bn + kTile - 1) / kTile));
    bsmm_dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<float*>(dw), batch, grid_m * bm, grid_n * bn, bm, bn);
  }
  return static_cast<int>(cudaGetLastError());
}
