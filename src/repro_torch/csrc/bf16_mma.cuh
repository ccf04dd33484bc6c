// Pieces of kernel C's bf16 instance (bsmm_fwd.cu): the bf16 tensor-core
// product (mma.sync m16n8k16 into f32), its f32 accumulation, 16-byte
// cp.async of bf16 rows, and ldmatrix of b16 matrices, plain and transposed.
// (Kernels D's and E's bf16 instances run on wgmma: sm90.cuh.)
//
// Fragment layouts of mma.sync.aligned.m16n8k16 with .bf16 operands, for lane
// = 4 * g + t; a register holds two bf16, the lower index in its low half:
//   A (16 x 16, row):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, col):   b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8):        as m16n8k8's (tf32x3.cuh)
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace bf16mma {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a * b, the product taken into a zero fragment and added in f32, so
// the sum rounds to nearest all along a warp's steps.
__device__ __forceinline__ void mma_bf16_add(float (&acc)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(d, a, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += d[r];
}

__device__ __forceinline__ void cp_async16_bf16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                                int src_bytes) {
  tf32x3::cp_async16(reinterpret_cast<float*>(smem), reinterpret_cast<const float*>(gmem),
                     src_bytes);
}

__device__ __forceinline__ uint32_t smem_addr(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 8x8 b16 matrices: lanes 0-7 and 8-15 give the row addresses of matrix
// 0 and 1; lane 4g + t receives row g, elements 2t and 2t + 1.
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// Four 8x8 b16 matrices, transposed: lane 4g + t receives elements (2t, g)
// and (2t + 1, g) of each stored matrix. From a [k][n] slab that is a
// column-major fragment of W, or a row-major one of W^T.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

}  // namespace bf16mma
