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
// The (features, batch) entry, bias_act_T_f32. The out-of-core stream
// (src/repro_torch/xl/stream.py) keeps kernel A's (features, batch) layout
// and runs kernel A with no epilogue over each connection shard of a layer,
// since a segment may span two shards and only the layer's last shard ends
// its sum; this pass is then the layer's epilogue, with one bias value per
// row (= output feature), in kernel A's store modes:
//
//   v = __fadd_rn(x[r, b], bias[r])
//   mode 1: y = v                      (the output layer: the bias alone)
//   mode 2: y = v > 0 ? v : __fmul_rn(slope, v)
//   mode 3: y as mode 2, and mask[r, b] = v > 0 (uint8): the branch the
//           backward (kernel G, csrc/coo_dw.cu's epilogue) needs
//
// the same IEEE add, compare and multiply as kernel A's epilogue
// (csrc/coo_matmul_T.cu), so kernel A with no epilogue followed by this pass
// gives kernel A's fused store bit for bit, mask included. y may be x (in
// place): each element is read once, then written once, by one thread. A
// thread takes 4 consecutive batch columns of one row (16-byte loads and
// stores, a 4-byte mask store) where the batch is a multiple of 4 and the
// pointers are 16-byte aligned, else one element. Bound by bytes like the
// pass above: 8 bytes an element (9 with the mask).
//
// The bf16 entry, bias_all_relu_bf16. The port's bfloat16 LM runs All-ReLU
// between its sparse FFN's two products (models/layers.py::sparse_ffn_fwd),
// with no bias, the slope -alpha or +alpha by the layer's parity, in x's
// dtype, as the reference's all_relu does with a traced layer index
// (src/repro/core/all_relu.py:27-28, the slope cast to bf16). It computes the
// reference's bf16 arithmetic exactly: v = bf16(x + b) where there is a
// bias, bf16(slope * v) with the slope a bf16 value, the select on v > 0; so
// it is bit-equal to the plain version and to the Pallas bias_all_relu in
// bf16. 16-byte loads and stores (8 bf16) where n and the pitch are
// multiples of 8 and the pointers 16-byte aligned, else one element. Bound by
// bytes: 4 an element. The f32 row-major entry takes a null bias too.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_bf16.h>
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
// divided. Without a bias (kBias false) v is x itself.
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_all_relu_vec4(const float4* __restrict__ x, const float4* __restrict__ bias,
                   float4* __restrict__ y, int64_t rows, int64_t row_vec,
                   int64_t pitch_vec, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row_vec) return;
  const float4 b = kBias ? __ldg(bias + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    float4 a = x[r * pitch_vec + c];
    a.x = all_relu(kBias ? a.x + b.x : a.x, slope);
    a.y = all_relu(kBias ? a.y + b.y : a.y, slope);
    a.z = all_relu(kBias ? a.z + b.z : a.z, slope);
    a.w = all_relu(kBias ? a.w + b.w : a.w, slope);
    y[r * row_vec + c] = a;
  }
}

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_all_relu_scalar(const float* __restrict__ x, const float* __restrict__ bias,
                     float* __restrict__ y, int64_t rows, int64_t row,
                     int64_t pitch, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row) return;
  const float b = kBias ? __ldg(bias + c) : 0.0f;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float v = x[r * pitch + c];
    y[r * row + c] = all_relu(kBias ? v + b : v, slope);
  }
}

// The bf16 arithmetic of the reference's bfloat16 All-ReLU, step by step:
// v = bf16(x + b) (with a bias), then bf16(slope * v) with the slope already
// a bf16 value, then the select on v > 0. Each step is an f32 operation
// (exact or rounded to nearest) rounded to nearest bf16, as PyTorch's and
// XLA's bf16 elementwise ops are, so the plain version gives the same bits.
template <bool kBias>
__device__ __forceinline__ __nv_bfloat16 all_relu_bf16(__nv_bfloat16 xv, __nv_bfloat16 bv,
                                                       float slope) {
  float v = __bfloat162float(xv);
  if (kBias) v = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, __bfloat162float(bv))));
  const __nv_bfloat16 neg = __float2bfloat16_rn(__fmul_rn(slope, v));
  return v > 0.0f ? __float2bfloat16_rn(v) : neg;  // v is a bf16 value: exact
}

// 8 bf16 (16 bytes) a thread and row; the same walk as bias_all_relu_vec4.
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_all_relu_bf16_vec8(const uint4* __restrict__ x, const uint4* __restrict__ bias,
                        uint4* __restrict__ y, int64_t rows, int64_t row_vec,
                        int64_t pitch_vec, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row_vec) return;
  uint4 braw = kBias ? __ldg(bias + c) : make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&braw);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    uint4 a = x[r * pitch_vec + c];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = all_relu_bf16<kBias>(e[q], b[q], slope);
    y[r * row_vec + c] = a;
  }
}

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_all_relu_bf16_scalar(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                          int64_t rows, int64_t row, int64_t pitch, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= row) return;
  const __nv_bfloat16 b = kBias ? bias[c] : __float2bfloat16_rn(0.0f);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    y[r * row + c] = all_relu_bf16<kBias>(x[r * pitch + c], b, slope);
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

__device__ __forceinline__ float act_T(float x, float b, float slope, int mode, bool* pos) {
  const float v = __fadd_rn(x, b);
  *pos = v > 0.0f;
  return mode == 1 || *pos ? v : __fmul_rn(slope, v);
}

__global__ void __launch_bounds__(kThreads)
bias_act_T_vec4(const float4* x, const float* __restrict__ bias, float4* y,
                uchar4* __restrict__ mask, int64_t n_vec, int64_t batch_vec, float slope,
                int mode) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_vec) return;
  const float b = __ldg(bias + t / batch_vec);
  const float4 a = x[t];
  bool p0, p1, p2, p3;
  const float4 o = make_float4(act_T(a.x, b, slope, mode, &p0), act_T(a.y, b, slope, mode, &p1),
                               act_T(a.z, b, slope, mode, &p2), act_T(a.w, b, slope, mode, &p3));
  y[t] = o;
  if (mode == 3) mask[t] = make_uchar4(p0, p1, p2, p3);
}

__global__ void __launch_bounds__(kThreads)
bias_act_T_scalar(const float* x, const float* __restrict__ bias, float* y,
                  uint8_t* __restrict__ mask, int64_t n, int64_t batch, float slope, int mode) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  bool p;
  y[t] = act_T(x[t], __ldg(bias + t / batch), slope, mode, &p);
  if (mode == 3) mask[t] = p ? 1 : 0;
}

}  // namespace

// x and y: (n_rows, batch) f32, contiguous, y may be x; bias: (n_rows,);
// mask: (n_rows, batch) uint8, read only in mode 3. mode: 1 + bias, 2 + bias
// then All-ReLU with slope, 3 as 2 and the mask of v > 0.
extern "C" int bias_act_T_f32(const void* x, const void* bias, void* y, void* mask,
                              int64_t n_rows, int64_t batch, float slope, int mode,
                              int device, void* stream) {
  if (n_rows < 0 || batch < 0 || mode < 1 || mode > 3 || (mode == 3 && mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = n_rows * batch;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = batch % 4 == 0 && aligned16(x) && aligned16(y) &&
                   (mask == nullptr || (reinterpret_cast<uintptr_t>(mask) & 3u) == 0);
  const int64_t work = vec ? n / 4 : n;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    bias_act_T_vec4<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float*>(bias), static_cast<float4*>(y),
        static_cast<uchar4*>(mask), work, batch / 4, slope, mode);
  } else {
    bias_act_T_scalar<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias), static_cast<float*>(y),
        static_cast<uint8_t*>(mask), n, batch, slope, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: rows of n floats, pitch floats apart (pitch >= n); y: (rows, n), contiguous;
// bias: (n,), or null for All-ReLU alone.
extern "C" int bias_all_relu_f32(const void* x, const void* bias, void* y,
                                 int64_t rows, int64_t n, int64_t pitch, float slope,
                                 int device, void* stream) {
  if (rows < 0 || n < 0 || pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && n > 0) {
    const bool has_bias = bias != nullptr;
    if (n % 4 == 0 && pitch % 4 == 0 && aligned16(x) && (!has_bias || aligned16(bias)) &&
        aligned16(y)) {
      auto kernel = has_bias ? &bias_all_relu_vec4<true> : &bias_all_relu_vec4<false>;
      kernel<<<grid_for(n / 4, rows), kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<const float4*>(bias),
          static_cast<float4*>(y), rows, n / 4, pitch / 4, slope);
    } else {
      auto kernel = has_bias ? &bias_all_relu_scalar<true> : &bias_all_relu_scalar<false>;
      kernel<<<grid_for(n, rows), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(bias),
          static_cast<float*>(y), rows, n, pitch, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 entry: x rows of n bf16, pitch elements apart; y: (rows, n) bf16,
// contiguous; bias: (n,) bf16, or null (the LM's sparse FFN has none); slope:
// a bf16 value (the wrapper rounds it).
extern "C" int bias_all_relu_bf16(const void* x, const void* bias, void* y,
                                  int64_t rows, int64_t n, int64_t pitch, float slope,
                                  int device, void* stream) {
  if (rows < 0 || n < 0 || pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && n > 0) {
    const bool has_bias = bias != nullptr;
    if (n % 8 == 0 && pitch % 8 == 0 && aligned16(x) && (!has_bias || aligned16(bias)) &&
        aligned16(y)) {
      auto kernel = has_bias ? &bias_all_relu_bf16_vec8<true> : &bias_all_relu_bf16_vec8<false>;
      kernel<<<grid_for(n / 8, rows), kThreads, 0, s>>>(
          static_cast<const uint4*>(x), static_cast<const uint4*>(bias),
          static_cast<uint4*>(y), rows, n / 8, pitch / 8, slope);
    } else {
      auto kernel =
          has_bias ? &bias_all_relu_bf16_scalar<true> : &bias_all_relu_bf16_scalar<false>;
      kernel<<<grid_for(n, rows), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(y), rows, n, pitch, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
