// Kernel C: the block-sparse forward product.
//
//   y[b, c*bn + n] = sum_{i in [col_ptr[c], col_ptr[c+1])} sum_k x[b, rows[i]*bm + k] * values[i][k][n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_fwd (the Pallas
// _fwd_kernel). On the TPU the grid runs in order and an output tile that
// consecutive slots revisit accumulates in VMEM, zeroed where first_col is 1.
// Here blocks run in parallel: the canonical (col, row) order makes the slots
// of one block-column one contiguous range, given by col_ptr, and each block
// sums a contiguous run of that range itself. There are no atomics, and every
// sum runs in a fixed order, so the same inputs give the same bits on every
// run. A block-column with no slot writes zeros.
//
// What bounds it on an H100: 2 * B * nb * bm * bn flops (3x that on the
// tensor cores in 3xTF32) against the bytes of x, the live tiles and y. At
// batch 128 and 128 x 128 tiles a layer of 32 tiles is 134 MFLOP, 2.0 us at
// the f32 rate and 0.8 us at the 3xTF32 tensor rate: what sets the time is
// the latency of one block's chain and how many blocks are in flight, not a
// peak rate. The scalar version this replaces (f32 FMAs, one barrier-bound
// 32-deep slice at a time, one block walking a whole column) took 24.5-25.0
// us on layers 0-2 and 549.7 us on the output layer (one column of 32 slots
// on 4 blocks), 624 us a training step (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
//   * Split rule. The wrapper cuts each column's range into P contiguous
//     runs, run p = [lo + len*p/P, lo + len*(p+1)/P), with P chosen on the
//     host from nb, grid_n, the batch and the tile sizes alone
//     (block_sparse_matmul.py::fwd_parts: about one wave of blocks on the
//     132 SMs, at most ceil(nb / grid_n)). P = 1 writes y directly. P > 1
//     writes each run's partial tile to part (P, B, grid_n*bn) and a second
//     pass (tf32x3.cuh::sum_parts) adds the P partials in index order.
//   * One block of 256 threads per (column c, run p, 64-row batch tile,
//     64-wide column slice); 8 warps as 2 x 4, each a 32 x 16 warp tile of
//     2 x 2 m16n8k8 products.
//   * A cp.async ring of 4 stages. A stage is a 32-deep slice of one slot:
//     the x slice xs[b][k] (64 x 32, row pitch 36) and the W slice ws[k][n]
//     (32 x 64, row pitch 72); the pitches make the fragment loads free of
//     bank conflicts. The slices of the run's slots are numbered in order,
//     so the next slot's first slice loads while this slot's last computes.
//     16-byte copies where bm and bn are multiples of 4 and x and values are
//     16-byte aligned, else 4-byte copies. Masked elements (a ragged batch
//     tile, bm or bn below a slice, the tail of bm) are zero-filled by the
//     copy's source size, so fragments past the edge read zeros.
//   * 3xTF32 on mma.sync (tf32x3.cuh). wgmma would need both TF32 operands
//     K-major in shared memory, and values[i] is stored [k][n] (N-major):
//     wgmma and TMA are the next step, with a transposed copy or another
//     parameter layout.
//
// The bf16 instance, bsmm_fwd_bf16. The Pallas kernel runs in bf16 as well
// (held at 5e-2 against ref.bsmm_ref, tests/test_kernels.py): x and the
// tiles in bf16, each product on the MXU into an f32 accumulator across a
// column's slots, rounded once at the flush. The port's bfloat16 LM runs it
// twice in every layer's sparse FFN (models/layers.py::sparse_ffn_fwd). Here:
//   * the same split rule, grid, ring and ragged batch tile as the f32
//     instance. The products are one mma.sync m16n8k16 bf16 with an f32
//     accumulator each (no split: bf16 x bf16 is exact in f32). As in mma3,
//     each product goes into a zero fragment that f32 adds carry into the
//     run's accumulator, so the sum rounds to nearest all along the run;
//   * a stage is a 32-deep slice as before, two k16 steps: the x slice
//     xs[b][k] (64 x 32 bf16, row pitch 40 = 80 bytes) and the W slice
//     ws[k][n] (32 x 64 bf16, row pitch 72 = 144 bytes), 38,912 bytes for
//     the 4 stages. A fragments are 32-bit loads of two neighbouring k: the
//     8 rows g of a warp's load start 20 words apart, which puts the 32
//     lanes on 32 banks. B fragments pair two 16-bit loads of rows k and
//     k + 1 at column g: lanes with the same t and g / 2 share a word, and
//     the four t are 72 words (8 banks) apart, so neither load conflicts;
//   * 16-byte copies (8 bf16) where bm and bn are multiples of 8 and x and
//     values are 16-byte aligned, else plain element loads into the same
//     ring (cp.async has no 2-byte copy);
//   * the store rounds the f32 sum once to bf16 (__float2bfloat16_rn). A
//     split run keeps f32 partials in part (P, B, grid_n*bn), and the
//     second pass adds them in index order, then rounds once.
// The product of a batch of 8 rows moves the tiles (22 x 32 KB = 0.70 MB for
// the LM's W_in, 15 x 32 KB = 0.48 MB for W_out) in about 0.2 us at HBM
// rate: what sets its time is the latency of one slot chain, not a rate.
// wgmma and TMA are later work.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTileB = 64;     // batch rows per block
constexpr int kTileN = 64;     // output columns per block
constexpr int kDepth = 32;     // contraction depth of one stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps as 2 x 4, 32 x 16 each
constexpr int kLdX = kDepth + 4;
constexpr int kLdW = kTileN + 8;
constexpr int kStageFloats = kTileB * kLdX + kDepth * kLdW;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));
constexpr int kMaxBlock = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_fwd_kernel(const float* __restrict__ x,
                const float* __restrict__ values,
                const int32_t* __restrict__ rows,
                const int64_t* __restrict__ col_ptr,
                float* __restrict__ out,  // y (parts == 1) or part (parts > 1)
                int64_t batch, int64_t x_stride, int64_t y_stride,
                int bm, int bn, int parts) {
  extern __shared__ __align__(16) float smem[];
  const int64_t c = blockIdx.x / parts;
  const int p = static_cast<int>(blockIdx.x % parts);
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kTileB;
  const int n0 = static_cast<int>(blockIdx.z) * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int b_valid = batch - b0 < kTileB ? static_cast<int>(batch - b0) : kTileB;
  const int n_valid = min(kTileN, bn - n0);
  const int k_steps = (bm + kDepth - 1) / kDepth;

  const int64_t begin = col_ptr[c];
  const int64_t len = col_ptr[c + 1] - begin;
  const int64_t lo = begin + len * p / parts;
  const int64_t hi = begin + len * (p + 1) / parts;
  const int64_t n_steps = (hi - lo) * k_steps;

  // Stage `step` of the run: slot lo + step / k_steps, depth slice step % k_steps.
  auto load = [&](int64_t step) {
    float* xs = smem + (step % kStages) * kStageFloats;
    float* ws = xs + kTileB * kLdX;
    const int64_t s = lo + step / k_steps;
    const int k0 = static_cast<int>(step % k_steps) * kDepth;
    const int k_valid = min(kDepth, bm - k0);
    const float* xt = x + b0 * x_stride + static_cast<int64_t>(rows[s]) * bm + k0;
    const float* wt = values + s * bm * bn + static_cast<int64_t>(k0) * bn + n0;
    if constexpr (kVec) {
      for (int idx = tid; idx < kTileB * (kDepth / 4); idx += kThreads) {
        const int b = idx / (kDepth / 4), k = (idx % (kDepth / 4)) * 4;
        const bool ok = b < b_valid && k < k_valid;
        tf32x3::cp_async16(xs + b * kLdX + k, ok ? xt + b * x_stride + k : x, ok ? 16 : 0);
      }
      for (int idx = tid; idx < kDepth * (kTileN / 4); idx += kThreads) {
        const int k = idx / (kTileN / 4), n = (idx % (kTileN / 4)) * 4;
        const bool ok = k < k_valid && n < n_valid;
        tf32x3::cp_async16(ws + k * kLdW + n, ok ? wt + static_cast<int64_t>(k) * bn + n : values,
                           ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kTileB * kDepth; idx += kThreads) {
        const int b = idx / kDepth, k = idx % kDepth;
        const bool ok = b < b_valid && k < k_valid;
        tf32x3::cp_async4(xs + b * kLdX + k, ok ? xt + b * x_stride + k : x, ok ? 4 : 0);
      }
      for (int idx = tid; idx < kDepth * kTileN; idx += kThreads) {
        const int k = idx / kTileN, n = idx % kTileN;
        const bool ok = k < k_valid && n < n_valid;
        tf32x3::cp_async4(ws + k * kLdW + n, ok ? wt + static_cast<int64_t>(k) * bn + n : values,
                          ok ? 4 : 0);
      }
    }
  };

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st);
    tf32x3::cp_async_commit();
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();                       // ... for every thread; the oldest buffer is free
    if (step + kStages - 1 < n_steps) load(step + kStages - 1);
    tf32x3::cp_async_commit();

    const float* xs = smem + (step % kStages) * kStageFloats;
    const float* ws = xs + kTileB * kLdX;
    const int k_valid = min(kDepth, bm - static_cast<int>(step % k_steps) * kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      if (kk >= k_valid) break;  // the rest of the slice is zero-filled
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = xs + (wm + 16 * i + g) * kLdX + kk + t;
        tf32x3::split(a[0], a_hi[i][0], a_lo[i][0]);
        tf32x3::split(a[8 * kLdX], a_hi[i][1], a_lo[i][1]);
        tf32x3::split(a[4], a_hi[i][2], a_lo[i][2]);
        tf32x3::split(a[8 * kLdX + 4], a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* w = ws + (kk + t) * kLdW + wn + 8 * j + g;
        tf32x3::split(w[0], b_hi[j][0], b_lo[j][0]);
        tf32x3::split(w[4 * kLdW], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) tf32x3::mma3(acc[i][j], a_hi[i], a_lo[i], b_hi[j], b_lo[j]);
    }
  }
  tf32x3::cp_async_wait<0>();

  float* yt = out + static_cast<int64_t>(p) * batch * y_stride + b0 * y_stride + c * bn + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = wm + 16 * i + g + 8 * h;
      if (b >= b_valid) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 8 * j + 2 * t;
        if (n < n_valid) yt[b * y_stride + n] = acc[i][j][2 * h];
        if (n + 1 < n_valid) yt[b * y_stride + n + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// --- the bf16 instance --------------------------------------------------------

constexpr int kLdXh = kDepth + 8;  // bf16 elements: 80-byte rows
constexpr int kLdWh = kTileN + 8;  // 144-byte rows
constexpr int kStageHalves = kTileB * kLdXh + kDepth * kLdWh;
constexpr int kSmemBytesBf16 = kStages * kStageHalves * static_cast<int>(sizeof(__nv_bfloat16));
static_assert(kSmemBytesBf16 <= 48 * 1024, "the bf16 ring fits the default shared memory");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) into one register, lo in the low half: an mma operand pair.
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void cp_async16_bf16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                                int src_bytes) {
  tf32x3::cp_async16(reinterpret_cast<float*>(smem), reinterpret_cast<const float*>(gmem),
                     src_bytes);
}

// Fragment layouts of mma.sync.aligned.m16n8k16 with .bf16 operands, for lane
// = 4 * g + t; a register holds two bf16, the lower index in its low half:
//   A (16 x 16, row):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, col):   b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8):        as m16n8k8's (tf32x3.cuh)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ values,
                     const int32_t* __restrict__ rows,
                     const int64_t* __restrict__ col_ptr,
                     __nv_bfloat16* __restrict__ y,  // parts == 1
                     float* __restrict__ part,       // parts > 1: f32 partials
                     int64_t batch, int64_t x_stride, int64_t y_stride,
                     int bm, int bn, int parts) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem_h = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  const int64_t c = blockIdx.x / parts;
  const int p = static_cast<int>(blockIdx.x % parts);
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kTileB;
  const int n0 = static_cast<int>(blockIdx.z) * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int b_valid = batch - b0 < kTileB ? static_cast<int>(batch - b0) : kTileB;
  const int n_valid = min(kTileN, bn - n0);
  const int k_steps = (bm + kDepth - 1) / kDepth;

  const int64_t begin = col_ptr[c];
  const int64_t len = col_ptr[c + 1] - begin;
  const int64_t lo = begin + len * p / parts;
  const int64_t hi = begin + len * (p + 1) / parts;
  const int64_t n_steps = (hi - lo) * k_steps;

  // Stage `step` of the run: slot lo + step / k_steps, depth slice step % k_steps.
  auto load = [&](int64_t step) {
    __nv_bfloat16* xs = smem_h + (step % kStages) * kStageHalves;
    __nv_bfloat16* ws = xs + kTileB * kLdXh;
    const int64_t s = lo + step / k_steps;
    const int k0 = static_cast<int>(step % k_steps) * kDepth;
    const int k_valid = min(kDepth, bm - k0);
    const __nv_bfloat16* xt = x + b0 * x_stride + static_cast<int64_t>(rows[s]) * bm + k0;
    const __nv_bfloat16* wt = values + s * bm * bn + static_cast<int64_t>(k0) * bn + n0;
    if constexpr (kVec) {
      // bm and bn are multiples of 8, so a 16-byte chunk is all in or all out
      for (int idx = tid; idx < kTileB * (kDepth / 8); idx += kThreads) {
        const int b = idx / (kDepth / 8), k = (idx % (kDepth / 8)) * 8;
        const bool ok = b < b_valid && k < k_valid;
        cp_async16_bf16(xs + b * kLdXh + k, ok ? xt + b * x_stride + k : x, ok ? 16 : 0);
      }
      for (int idx = tid; idx < kDepth * (kTileN / 8); idx += kThreads) {
        const int k = idx / (kTileN / 8), n = (idx % (kTileN / 8)) * 8;
        const bool ok = k < k_valid && n < n_valid;
        cp_async16_bf16(ws + k * kLdWh + n, ok ? wt + static_cast<int64_t>(k) * bn + n : values,
                        ok ? 16 : 0);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      for (int idx = tid; idx < kTileB * kDepth; idx += kThreads) {
        const int b = idx / kDepth, k = idx % kDepth;
        xs[b * kLdXh + k] = b < b_valid && k < k_valid ? xt[b * x_stride + k] : zero;
      }
      for (int idx = tid; idx < kDepth * kTileN; idx += kThreads) {
        const int k = idx / kTileN, n = idx % kTileN;
        ws[k * kLdWh + n] = k < k_valid && n < n_valid ? wt[static_cast<int64_t>(k) * bn + n] : zero;
      }
    }
  };

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st);
    tf32x3::cp_async_commit();
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    tf32x3::cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();                       // ... for every thread; the oldest buffer is free
    if (step + kStages - 1 < n_steps) load(step + kStages - 1);
    tf32x3::cp_async_commit();

    const __nv_bfloat16* xs = smem_h + (step % kStages) * kStageHalves;
    const __nv_bfloat16* ws = xs + kTileB * kLdXh;
    const int k_valid = min(kDepth, bm - static_cast<int>(step % k_steps) * kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      if (kk >= k_valid) break;  // the rest of the slice is zero-filled
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* ap = xs + (wm + 16 * i + g) * kLdXh + kk + 2 * t;
        a[i][0] = ld_pair(ap);
        a[i][1] = ld_pair(ap + 8 * kLdXh);
        a[i][2] = ld_pair(ap + 8);
        a[i][3] = ld_pair(ap + 8 * kLdXh + 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp = ws + (kk + 2 * t) * kLdWh + wn + 8 * j + g;
        b[j][0] = pack(bp[0], bp[kLdWh]);
        b[j][1] = pack(bp[8 * kLdWh], bp[9 * kLdWh]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(d, a[i], b[j]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += d[r];
        }
    }
  }
  tf32x3::cp_async_wait<0>();

  const int64_t tile = b0 * y_stride + c * bn + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = wm + 16 * i + g + 8 * h;
      if (b >= b_valid) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 8 * j + 2 * t;
        const int64_t at = tile + b * y_stride + n;
        if (parts == 1) {
          if (n < n_valid) y[at] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (n + 1 < n_valid) y[at + 1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        } else {
          float* pt = part + static_cast<int64_t>(p) * batch * y_stride;
          if (n < n_valid) pt[at] = acc[i][j][2 * h];
          if (n + 1 < n_valid) pt[at + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// out[i] = bf16(part[0][i] + part[1][i] + ... + part[parts-1][i]): the f32
// sum in index order, as tf32x3::sum_parts takes it, rounded once.
__global__ void sum_parts_bf16(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                               int64_t total, int parts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = part[i];
    for (int q = 1; q < parts; ++q) s += part[q * total + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

bool smem_set[2][64];

}  // namespace

extern "C" int bsmm_fwd_f32(const void* x, const void* values, const void* rows,
                            const void* col_ptr, void* y, void* part,
                            int64_t batch, int64_t grid_m, int64_t grid_n,
                            int bm, int bn, int parts, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_n < 1 || parts < 1 || grid_n * parts > 0x7fffffff ||
      (parts > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kTileB - 1) / kTileB;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = bm % 4 == 0 && bn % 4 == 0 && tf32x3::aligned16(x) &&
                   tf32x3::aligned16(values);
  auto kernel = vec ? &bsmm_fwd_kernel<true> : &bsmm_fwd_kernel<false>;
  err = tf32x3::allow_smem(kernel, device, kSmemBytes, smem_set[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_n * parts),
                  static_cast<unsigned int>(batch_tiles),
                  static_cast<unsigned int>((bn + kTileN - 1) / kTileN));
  float* out = static_cast<float*>(parts > 1 ? part : y);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(values),
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(col_ptr),
      out, batch, grid_m * bm, grid_n * bn, bm, bn, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  return static_cast<int>(tf32x3::launch_sum_parts(
      static_cast<const float*>(part), static_cast<float*>(y), batch * grid_n * bn, parts, s));
}

// The bf16 instance: x, values and y bf16; part (parts > 1) f32.
extern "C" int bsmm_fwd_bf16(const void* x, const void* values, const void* rows,
                             const void* col_ptr, void* y, void* part,
                             int64_t batch, int64_t grid_m, int64_t grid_n,
                             int bm, int bn, int parts, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_n < 1 || parts < 1 || grid_n * parts > 0x7fffffff ||
      (parts > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t batch_tiles = (batch + kTileB - 1) / kTileB;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = bm % 8 == 0 && bn % 8 == 0 && tf32x3::aligned16(x) &&
                   tf32x3::aligned16(values);
  auto kernel = vec ? &bsmm_fwd_bf16_kernel<true> : &bsmm_fwd_bf16_kernel<false>;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_n * parts),
                  static_cast<unsigned int>(batch_tiles),
                  static_cast<unsigned int>((bn + kTileN - 1) / kTileN));
  kernel<<<grid, kThreads, kSmemBytesBf16, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(values),
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(col_ptr),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), batch, grid_m * bm,
      grid_n * bn, bm, bn, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const int64_t total = batch * grid_n * bn;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + 255) / 256;
  sum_parts_bf16<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(y), total, parts);
  return static_cast<int>(cudaGetLastError());
}
