// Kernel F: the element-sparse (COO) weight gradient, one value per slot.
//
//   dv[j] = sum_b xT[rows[j], b] * dyT[cols[j], b]
//
// Replaces src/repro/core/sparsity.py::coo_dw, an XLA lax.scan over chunks
// of slots whose gathered (chunk, B) slabs are multiplied and reduced over
// the batch (not a Pallas kernel); src/repro/kernels/ops.py::_espmm_core_bwd
// runs it as the element product's dW. dv is in the canonical (col, row)
// slot order, so it lines up with values.
//
// The sum. One warp per slot. Each lane sums its batch columns in one f32
// chain in column order, then the 32 partials meet in a fixed xor-shuffle
// tree (offsets 16, 8, 4, 2, 1). Float addition is commutative, so every
// lane of the tree holds the same bits, and lane 0 stores them. No atomics:
// the same inputs give the same bits on every launch. The lanes' columns:
//
//   * where B is a multiple of 4 and both operands are 16-byte aligned, lane
//     l reads the float4s at b = 4l + 128k (k = 0, 1, ...), and its chain runs
//     k by k, x/y/z/w within each;
//   * else lane l reads b = l + 32k.
//
// The two read the batch in another order, so they differ in the last bits;
// which one runs is a pure function of B and the two base addresses.
//
// What bounds it on an H100: per slot, 2 flops per batch column against two
// gathered rows of B floats. Counted once, the compulsory bytes are xT, dyT,
// the two index arrays and dv: 15 MB summed over the CIFAR-10 SET-MLP's four
// layers at batch 128, 4.6 us at 3.35 TB/s, against 98 MFLOP, 1.5 us at 67
// TFLOP/s, so bytes bound it. The gathers read each row once per slot
// through L2 (1 KB a slot at B = 128), and consecutive slots share a column
// in the canonical order, so a block's 8 warps read one dyT row from L1 or
// L2 most of the time. A simple kernel first: each warp waits on its two
// rows with nothing in flight between slots.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // slots per block

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
coo_dw_kernel(const float* __restrict__ xT,
              const float* __restrict__ dyT,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ cols,
              float* __restrict__ dv,
              int64_t nnz,
              int64_t batch) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (j >= nnz) return;  // the whole warp: j is the warp's
  const int lane = threadIdx.x % 32;
  const float* x = xT + static_cast<int64_t>(__ldg(rows + j)) * batch;
  const float* d = dyT + static_cast<int64_t>(__ldg(cols + j)) * batch;
  float p = 0.0f;
  if constexpr (kVec) {
    for (int64_t b = 4 * lane; b < batch; b += 128) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + b));
      const float4 dv4 = __ldg(reinterpret_cast<const float4*>(d + b));
      p = fmaf(xv.x, dv4.x, p);
      p = fmaf(xv.y, dv4.y, p);
      p = fmaf(xv.z, dv4.z, p);
      p = fmaf(xv.w, dv4.w, p);
    }
  } else {
    for (int64_t b = lane; b < batch; b += 32) p = fmaf(__ldg(x + b), __ldg(d + b), p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
  if (lane == 0) dv[j] = p;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// xT (in_dim x batch), dyT (out_dim x batch), rows/cols (nnz int32, inside
// their tensors' first dimensions: the wrapper checks), dv (nnz f32).
extern "C" int coo_dw_f32(const void* xT, const void* dyT, const void* rows, const void* cols,
                          void* dv, int64_t nnz, int64_t batch, int device, void* stream) {
  if (nnz < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nnz == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (nnz + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = batch % 4 == 0 && aligned16(xT) && aligned16(dyT);
  auto kernel = vec ? &coo_dw_kernel<true> : &coo_dw_kernel<false>;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(xT), static_cast<const float*>(dyT),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<float*>(dv), nnz, batch);
  return static_cast<int>(cudaGetLastError());
}
