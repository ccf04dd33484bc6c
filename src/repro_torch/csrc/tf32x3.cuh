// Shared pieces of kernels C, D and E (bsmm_fwd.cu, bsmm_dx.cu, bsmm_dw.cu):
// asynchronous global-to-shared copies and ldmatrix (also kernel A's staged
// route, coo_matmul_T.cu), f32-accurate tensor-core products (3xTF32), and
// the ordered sum of split partials.
//
// 3xTF32. TF32 keeps 10 explicit mantissa bits, so one TF32 product of f32
// operands loses about three decimal digits: too much for a sum over K = 4096
// held at rtol = atol = 1e-4. Each operand a is split as it goes from shared
// memory into a fragment, hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi),
// and the product is taken as lo*hi + hi*lo + hi*hi; lo*lo (below f32's
// last bit) is dropped. Each TF32 product is exact in f32, and the sum over
// k is taken in f32 adds that round to nearest (mma3), so the result is as
// accurate as an f32 FMA chain.
//
// Fragment layouts of mma.sync.aligned.m16n8k8 with .tf32 operands, for lane
// = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, column):      b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8):             c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf32x3 {

// --- cp.async --------------------------------------------------------------

// Copy 16 bytes; src_bytes < 16 zero-fills the rest (0: the whole chunk is
// zero and nothing is read).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// Copy 4 bytes, or write a zero where src_bytes is 0.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lane i receives 32-bit word i % 4
// of row i / 4 of matrix k in r_k, where lanes 8k to 8k + 7 give the addresses
// of matrix k's 8 rows (16 bytes each, 16-byte aligned). Taken as f32 words,
// a row is 4 floats: one instruction gives each lane the element of 4 rows
// that its (g, t) = (lane / 4, lane % 4) selects, e.g. an m16n8k8 TF32 A
// fragment, where four 4-byte loads would take four instructions.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// --- 3xTF32 on mma.sync ------------------------------------------------------

// cvt.rna.tf32.f32 for a finite a: add half of the 13 dropped bits' range to
// the magnitude and clear them (round to nearest, ties away from zero; a
// carry runs into the exponent). Two integer instructions, where the compiler
// lowers the cvt to four with a guard for infinities and NaNs. A non-finite a
// gives a NaN product either way (lo = a - hi is a NaN).
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a * b in 3xTF32, the small terms first. The tensor cores' adder
// does not round to nearest, and a long chain of mma into one accumulator
// drifts by up to a unit in the last place of the running sum per mma, far
// past an f32 sum's error over K in the thousands. So the three products of
// one 8-deep step are summed on the tensor cores into a zero fragment, and
// the fragment is added to acc with f32 adds that round to nearest.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(d, a_lo, b_hi);
  mma(d, a_hi, b_lo);
  mma(d, a_hi, b_hi);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += d[r];
}

// --- the second pass of a split ----------------------------------------------

// out[i] = part[0][i] + part[1][i] + ... + part[parts-1][i], in that order:
// the same bits on every run. Loads go out eight at a time, so that their
// latency is paid once per eight partials, not once per partial.
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ out,
                          int64_t total, int parts) {
  constexpr int kBatch = 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = part[i];
    int p = 1;
    for (; p + kBatch <= parts; p += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) v[q] = part[(p + q) * total + i];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) s += v[q];
    }
    for (; p < parts; ++p) s += part[p * total + i];
    out[i] = s;
  }
}

inline cudaError_t launch_sum_parts(const float* part, float* out, int64_t total, int parts,
                                    cudaStream_t stream) {
  if (total <= 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sum_parts<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      part, out, total, parts);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Raise a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int device, int bytes, bool (&done)[64]) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

}  // namespace tf32x3
