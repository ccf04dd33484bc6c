// Kernel B: bias + All-ReLU epilogue.
//
//   y[r, n] = v > 0 ? v : slope * v,   v = x[r, n] + bias[n]
//
// with slope = -alpha for even layer_index and +alpha for odd (paper Eq. 3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/all_relu_fused.py::
// bias_all_relu (kernel body _kernel). The Pallas version pads rows to
// block_rows for the TPU's tiling; here the grid walks the flat element range
// and masks the ragged edge itself, so nothing is padded.
//
// What bounds it on an H100: one add, one compare and one multiply per 8 bytes
// moved (x read once, y written once; bias is tiny and stays in L1/L2), so it
// is bound by memory bandwidth.
//
// Design: one elementwise pass with 16-byte loads and stores (float4) when the
// row width is a multiple of 4 and the pointers are 16-byte aligned, scalar
// otherwise; a grid-stride loop covers any number of rows. The arithmetic is
// the same IEEE f32 add, compare and multiply as the plain PyTorch version
// (the add comes before the multiply, so no fused multiply-add can form), so
// the two agree bit for bit.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__device__ __forceinline__ float all_relu(float v, float slope) {
  return v > 0.0f ? v : slope * v;
}

__global__ void __launch_bounds__(kThreads)
bias_all_relu_vec4(const float4* __restrict__ x, const float4* __restrict__ bias,
                   float4* __restrict__ y, int64_t n_vec, int64_t row_vec,
                   float slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    float4 a = x[i];
    const float4 c = __ldg(bias + i % row_vec);
    a.x = all_relu(a.x + c.x, slope);
    a.y = all_relu(a.y + c.y, slope);
    a.z = all_relu(a.z + c.z, slope);
    a.w = all_relu(a.w + c.w, slope);
    y[i] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
bias_all_relu_scalar(const float* __restrict__ x, const float* __restrict__ bias,
                     float* __restrict__ y, int64_t n_elem, int64_t row,
                     float slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_elem; i += stride) {
    y[i] = all_relu(x[i] + __ldg(bias + i % row), slope);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int64_t grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

extern "C" int bias_all_relu_f32(const void* x, const void* bias, void* y,
                                 int64_t rows, int64_t n, float slope,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_elem = rows * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_elem > 0) {
    if (n % 4 == 0 && aligned16(x) && aligned16(bias) && aligned16(y)) {
      const int64_t n_vec = n_elem / 4;
      bias_all_relu_vec4<<<static_cast<unsigned int>(grid_for(n_vec)), kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<const float4*>(bias),
          static_cast<float4*>(y), n_vec, n / 4, slope);
    } else {
      bias_all_relu_scalar<<<static_cast<unsigned int>(grid_for(n_elem)), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(bias),
          static_cast<float*>(y), n_elem, n, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
