// Kernel A: the element-sparse (COO) product in transposed layout.
//
//   outT[s, b] = acc[s, b] + sum_{j in [seg_ptr[s], seg_ptr[s+1])} srcT[gather[j], b] * values[j]
//
// Replaces src/repro/core/sparsity.py::coo_matmul_T, an XLA lax.scan of
// sorted segment_sums (not a Pallas kernel). The serving path runs it as the
// forward product (gather = rows, segments = cols, canonical (col, row)
// order); the training slice runs the same kernel for dX (gather = cols_r,
// segments = rows_r).
//
// What bounds it on an H100: 2 flops per slot and batch column against at
// least 4 bytes of srcT per slot and column read through L2, so it is bound
// by memory traffic, never by the f32 units. The operands of a serving layer
// (a few MB) sit in the 50 MB L2; device memory sees each input once.
//
// Design:
//   * One thread per (segment, batch column), flattened as s * B + b. At
//     B = 128 the 32 lanes of a warp read 32 consecutive floats of one srcT
//     row (coalesced), and gather[j] / values[j] are the same address for the
//     whole warp (one broadcast load). At B = 1 the lanes cover consecutive
//     segments, so even the smallest bucket fills the card's warps.
//   * Each thread walks its segment's slots left to right in canonical slot
//     order and sums in one f32 register: no atomics, no tree reduction, so
//     the result is deterministic and independent of the launch shape.
//     Removing zero contributions from a fixed left-to-right sum leaves it
//     unchanged, which is why lossless compaction stays bit-equal on the card.
//   * The loop is unrolled by kUnroll with all loads issued before the fused
//     multiply-adds, so a long segment keeps kUnroll gathers in flight while
//     the additions still happen in slot order.
//   * Segment offsets come from seg_ptr (n_segments + 1 int64 offsets); all
//     offset arithmetic is 64-bit. An empty segment yields acc, or exactly 0.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
coo_matmul_T_kernel(const float* __restrict__ srcT,
                    const float* __restrict__ values,
                    const int32_t* __restrict__ gather,
                    const int64_t* __restrict__ seg_ptr,
                    const float* __restrict__ acc,
                    float* __restrict__ out,
                    int64_t n_segments,
                    int64_t batch) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_segments * batch) return;
  const int64_t s = t / batch;
  const int64_t b = t - s * batch;
  const int64_t end = seg_ptr[s + 1];
  int64_t j = seg_ptr[s];
  float sum = acc != nullptr ? __ldg(acc + t) : 0.0f;
  for (; j + kUnroll <= end; j += kUnroll) {
    float x[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(values + j + u);
      x[u] = __ldg(srcT + static_cast<int64_t>(__ldg(gather + j + u)) * batch + b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sum = fmaf(x[u], v[u], sum);
  }
  for (; j < end; ++j) {
    const float x = __ldg(srcT + static_cast<int64_t>(__ldg(gather + j)) * batch + b);
    sum = fmaf(x, __ldg(values + j), sum);
  }
  out[t] = sum;
}

}  // namespace

extern "C" int coo_matmul_T_f32(const void* srcT, const void* values,
                                const void* gather, const void* seg_ptr,
                                const void* acc, void* out,
                                int64_t n_segments, int64_t batch,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = n_segments * batch;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    coo_matmul_T_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(srcT), static_cast<const float*>(values),
        static_cast<const int32_t*>(gather),
        static_cast<const int64_t*>(seg_ptr), static_cast<const float*>(acc),
        static_cast<float*>(out), n_segments, batch);
  }
  return static_cast<int>(cudaGetLastError());
}
