// Kernel C: the block-sparse forward product.
//
//   y[b, c*bn + n] = sum_{i in [col_ptr[c], col_ptr[c+1])} sum_k x[b, rows[i]*bm + k] * values[i][k][n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_fwd (the Pallas
// _fwd_kernel). On the TPU the grid runs in order and an output tile that
// consecutive slots revisit accumulates in VMEM, zeroed where first_col is 1.
// Here blocks run in parallel, so each block owns its output tile and walks
// the tile's slot range itself: the canonical (col, row) order makes the
// slots of one block-column one contiguous range, given by col_ptr. There are
// no atomics, and the sum runs slot by slot, k by k, in a fixed order, so the
// result is deterministic. A block-column with no slot writes zeros.
//
// What bounds it on an H100: 2 * B * nb * bm * bn flops against the bytes of
// x, the live tiles and y. At batch 128 and 128 x 128 tiles that is about 25
// flops a byte, so the f32 units (67 TFLOP/s) bound a layer, not memory. This
// first version issues f32 FMAs from registers, with the x and W tiles staged
// through shared memory; it does not use the tensor cores (wgmma/TMA is later
// work). Its known cost is a layer with few block-columns: the output layer
// of the CIFAR-10 SET-MLP is one column of 32 slots, so only
// ceil(B/64) * ceil(bn/64) blocks run, each walking all 32 slots.
//
// Design:
//   * One block per (output block-column c, 64-row batch tile, 64-wide slice
//     of the tile's bn columns); 256 threads as 16 x 16, each owning a 4 x 4
//     micro-tile at stride 16 (rows ty + 16i, columns tx + 16j).
//   * The contraction runs over the slot's bm rows in steps of 32: the x
//     slice (64 x 32) and the W slice (32 x 64) are staged in shared memory,
//     both read from device memory with consecutive threads on consecutive
//     addresses, and laid out [k][row] with a pad of one so that the stores
//     and the compute loop's reads avoid bank conflicts.
//   * A ragged last batch tile, and tiles narrower than 64, are masked: the
//     staged values beyond them are zero and their outputs are not stored.
//     Any bm and bn from 1 to 128 are taken; the wrapper raises on others.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile: kTile batch rows x kTile columns
constexpr int kDepth = 32;     // contraction depth staged per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread: kMicro x kMicro outputs at stride 16
constexpr int kPad = kTile + 1;
constexpr int kMaxBlock = 128;

__global__ void __launch_bounds__(kThreads)
bsmm_fwd_kernel(const float* __restrict__ x,
                const float* __restrict__ values,
                const int32_t* __restrict__ rows,
                const int64_t* __restrict__ col_ptr,
                float* __restrict__ y,
                int64_t batch, int64_t x_stride, int64_t y_stride,
                int bm, int bn) {
  __shared__ float xs[kDepth][kPad];  // xs[k][b] = x[b0 + b, rows[i]*bm + k0 + k]
  __shared__ float ws[kDepth][kPad];  // ws[k][n] = values[i][k0 + k][n0 + n]
  const int64_t c = blockIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int n0 = static_cast<int>(blockIdx.z) * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b_valid = batch - b0 < kTile ? static_cast<int>(batch - b0) : kTile;
  const int n_valid = min(kTile, bn - n0);

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int64_t begin = col_ptr[c];
  const int64_t end = col_ptr[c + 1];
  for (int64_t s = begin; s < end; ++s) {
    const float* xt = x + b0 * x_stride + static_cast<int64_t>(rows[s]) * bm;
    const float* wt = values + s * bm * bn + n0;
    for (int k0 = 0; k0 < bm; k0 += kDepth) {
      const int k_valid = min(kDepth, bm - k0);
      for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
        const int b = idx / kDepth;
        const int k = idx % kDepth;
        xs[k][b] = (b < b_valid && k < k_valid) ? __ldg(xt + b * x_stride + k0 + k) : 0.0f;
      }
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int k = idx / kTile;
        const int n = idx % kTile;
        ws[k][n] = (k < k_valid && n < n_valid)
                       ? __ldg(wt + static_cast<int64_t>(k0 + k) * bn + n) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < k_valid; ++k) {
        float a[kMicro];
        float w[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) w[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* yt = y + b0 * y_stride + c * bn + n0;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int b = ty + 16 * i;
    if (b >= b_valid) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int n = tx + 16 * j;
      if (n < n_valid) yt[b * y_stride + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bsmm_fwd_f32(const void* x, const void* values, const void* rows,
                            const void* col_ptr, void* y,
                            int64_t batch, int64_t grid_m, int64_t grid_n,
                            int bm, int bn, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_n < 1 || grid_n > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kTile - 1) / kTile;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles > 0) {
    const dim3 grid(static_cast<unsigned int>(grid_n), static_cast<unsigned int>(batch_tiles),
                    static_cast<unsigned int>((bn + kTile - 1) / kTile));
    bsmm_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(values),
        static_cast<const int32_t*>(rows), static_cast<const int64_t*>(col_ptr),
        static_cast<float*>(y), batch, grid_m * bm, grid_n * bn, bm, bn);
  }
  return static_cast<int>(cudaGetLastError());
}
