// Kernel G: the backward of kernel A's training epilogue (bias, then
// All-ReLU), in the (features, batch) layout the element path keeps.
//
//   dz[n, b]  = mask[n, b] ? dy[n, b] : slope * dy[n, b]      (no mask: dy)
//   dbias[n]  = sum_b dz[n, b]
//
// Replaces what XLA derives for src/repro/core/all_relu.py::all_relu(h + b)
// in the reference's element step (src/repro/models/mlp.py::mlp_forward:
// espmm, + bias, then the activation): jax.grad of
// jnp.where(x > 0, x, slope * x) gives dy where x > 0 and slope * dy where
// not (x == 0 included), and the bias's gradient is dz summed over the
// batch. Not a Pallas kernel: the forward's Pallas kernel
// (src/repro/kernels/all_relu_fused.py::bias_all_relu) runs inside kernel
// A's store, and this is its backward. mask is the branch kernel A's
// epilogue 3 recorded (v > 0); the output layer has no activation and no
// mask, and G gives it dz = dy and the row sums.
//
// The sum. One warp per feature row n (a row is contiguous in this layout):
// lane l sums dz[n, l + 32k] over k in order, in f32 adds, then the 32
// partials meet in a fixed xor-shuffle tree (offsets 16, 8, 4, 2, 1), whose
// lanes all hold the same bits (addition is commutative); lane 0 stores. No
// atomics: the same inputs give the same bits on every launch. The multiply
// rounds on its own (__fmul_rn), as the reference's slope * dy does.
//
// What bounds it on an H100: bytes. Per element it reads 4 bytes of dy and 1
// of mask and writes 4 of dz, for one multiply and one add; a 4000 x 128
// layer moves 4.6 MB, ~1.4 us at 3.35 TB/s.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // feature rows per block

__global__ void __launch_bounds__(kThreads)
all_relu_bwd_kernel(const float* __restrict__ dy,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ dz,
                    float* __restrict__ dbias,
                    int64_t n_rows,
                    int64_t batch,
                    float slope) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (n >= n_rows) return;  // the whole warp: n is the warp's
  const int lane = threadIdx.x % 32;
  const int64_t base = n * batch;
  float p = 0.0f;
  for (int64_t b = lane; b < batch; b += 32) {
    float g = __ldg(dy + base + b);
    if (mask != nullptr && __ldg(mask + base + b) == 0) g = __fmul_rn(slope, g);
    dz[base + b] = g;
    p = __fadd_rn(p, g);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
  if (lane == 0) dbias[n] = p;
}

}  // namespace

// dy, dz (n_rows x batch f32), mask (n_rows x batch uint8, or null: no
// activation), dbias (n_rows f32).
extern "C" int all_relu_bwd_f32(const void* dy, const void* mask, void* dz, void* dbias,
                                int64_t n_rows, int64_t batch, float slope, int device,
                                void* stream) {
  if (n_rows < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  all_relu_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const uint8_t*>(mask), static_cast<float*>(dz),
      static_cast<float*>(dbias), n_rows, batch, slope);
  return static_cast<int>(cudaGetLastError());
}
