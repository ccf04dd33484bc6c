// Kernel B: bias + All-ReLU epilogue.
//
//   y[r, n] = v > 0 ? v : slope * v,   v = x[r * pitch + n] + bias[n]
//
// with slope = -alpha for even layer_index and +alpha for odd (paper Eq. 3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/all_relu_fused.py::
// bias_all_relu (kernel body _kernel). The Pallas version pads rows to
// block_rows for the TPU's tiling; here the grid walks the flat element range
// and masks the ragged edge itself, so nothing is padded.
//
// Where it runs. The reference's kernel is the block product's epilogue,
// and so is this one: the block model's no-grad forward (evaluation, and
// infer=True) runs it on each hidden layer's product. That product is the
// first out_dim columns of kernel C's block-padded output, so x is read at a
// row pitch (elements between row starts, >= n) and needs no copy; y is
// contiguous. The element serving path no longer runs this pass: kernel A
// applies the same arithmetic in its store (csrc/coo_matmul_T.cu, the
// epilogue), in the (features, batch) layout the served forward keeps.
//
// What bounds it on an H100: one add, one compare and one multiply per 8 bytes
// moved (x read once, y written once; bias is tiny and stays in L1/L2), so it
// is bound by memory bandwidth.
//
// Design: one elementwise pass with 16-byte loads and stores (float4) when the
// row width and the row pitch are multiples of 4 and the pointers are 16-byte
// aligned, scalar otherwise. A thread owns one column (its bias loaded once)
// and walks rows with a stride of the grid's rows of blocks, so a row pitch
// costs no index division.
// The arithmetic is the same IEEE f32 add, compare and multiply as the plain
// PyTorch version (the add comes before the multiply, so no fused
// multiply-add can form), so the two agree bit for bit.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxRowBlocks = 65535;  // gridDim.y
constexpr int64_t kTargetBlocks = 4096;

__device__ __forceinline__ float all_relu(float v, float slope) {
  return v > 0.0f ? v : slope * v;
}

// Block (bx, by) covers columns bx * kThreads + threadIdx.x of rows by,
// by + gridDim.y, ...: each thread loads its bias once, and no index is
// divided.
__global__ void __launch_bounds__(kThreads)
bias_all_relu_vec4(const float4* __restrict__ x, const float4* __restrict__ bias,
                   float4* __restrict__ y, int64_t rows, int64_t row_vec,
                   int64_t pitch_vec, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row_vec) return;
  const float4 b = __ldg(bias + c);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    float4 a = x[r * pitch_vec + c];
    a.x = all_relu(a.x + b.x, slope);
    a.y = all_relu(a.y + b.y, slope);
    a.z = all_relu(a.z + b.z, slope);
    a.w = all_relu(a.w + b.w, slope);
    y[r * row_vec + c] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
bias_all_relu_scalar(const float* __restrict__ x, const float* __restrict__ bias,
                     float* __restrict__ y, int64_t rows, int64_t row,
                     int64_t pitch, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row) return;
  const float b = __ldg(bias + c);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    y[r * row + c] = all_relu(x[r * pitch + c] + b, slope);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One block per kThreads columns, and as many rows of blocks as keep the
// grid near kTargetBlocks (each block then walks rows / gridDim.y rows).
dim3 grid_for(int64_t width, int64_t rows) {
  const int64_t gx = (width + kThreads - 1) / kThreads;
  int64_t gy = kTargetBlocks / gx;
  gy = gy < 1 ? 1 : gy;
  gy = gy < rows ? gy : rows;
  gy = gy < kMaxRowBlocks ? gy : kMaxRowBlocks;
  return dim3(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
}

}  // namespace

// x: rows of n floats, pitch floats apart (pitch >= n); y: (rows, n), contiguous.
extern "C" int bias_all_relu_f32(const void* x, const void* bias, void* y,
                                 int64_t rows, int64_t n, int64_t pitch, float slope,
                                 int device, void* stream) {
  if (rows < 0 || n < 0 || pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && n > 0) {
    if (n % 4 == 0 && pitch % 4 == 0 && aligned16(x) && aligned16(bias) && aligned16(y)) {
      bias_all_relu_vec4<<<grid_for(n / 4, rows), kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<const float4*>(bias),
          static_cast<float4*>(y), rows, n / 4, pitch / 4, slope);
    } else {
      bias_all_relu_scalar<<<grid_for(n, rows), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(bias),
          static_cast<float*>(y), rows, n, pitch, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
