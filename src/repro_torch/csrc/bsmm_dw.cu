// Kernel E: the block-sparse weight gradient.
//
//   dw[i][m][n] = sum_b x[b, rows[i]*bm + m] * dy[b, cols[i]*bn + n]
//
// Replaces src/repro/kernels/block_sparse_matmul.py::bsmm_dw (the Pallas
// _dw_kernel), whose sequential grid (nb, B/bb) carries each slot's sum over
// batch tiles in VMEM. Here the sum over the batch is cut into S contiguous
// runs of 32-sample chunks; one block sums one run for (a 64 x 64 part of)
// one slot's tile, in a fixed order. No atomics: the same inputs give the
// same bits on every run.
//
// What bounds it on an H100: 2 * B * nb * bm * bn flops (3x that on the
// tensor cores in 3xTF32) against the bytes of x, dy and dw. At batch 128 and
// 128 x 128 tiles a layer of 32 tiles is 134 MFLOP, 2.0 us at the f32 rate
// and 0.8 us at the 3xTF32 tensor rate, so the latency of one block's chain
// and the number of blocks in flight set the time. The scalar version this
// replaces (f32 FMAs, one barrier-bound 32-sample slice at a time, 4 blocks
// per slot) took 19.5-19.7 us on every layer, whether 8 or 32 tiles, 78.5 us
// a training step (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
//   * Split rule. S is chosen on the host from nb, the batch and the tile
//     sizes alone (block_sparse_matmul.py::dw_splits: about one wave of
//     blocks on the 132 SMs, at most one run per chunk). Run s covers chunks
//     [C*s/S, C*(s+1)/S) of the C = ceil(B/32) chunks. S = 1 writes dw
//     directly; S > 1 writes each run's partial tile to part (S, nb, bm, bn)
//     and a second pass (tf32x3.cuh::sum_parts) adds them in index order.
//   * One block of 256 threads per (slot, 64 x 64 part of the tile, run); 8
//     warps as 2 x 4, each a 32 x 16 warp tile of 2 x 2 m16n8k8 products.
//   * A cp.async ring of 4 stages; a stage is 32 samples of the slot's x
//     columns xs[b][m] and dy columns ys[b][n] (32 x 64 each, row pitch 72,
//     so that the fragment loads are free of bank conflicts), read along the
//     feature axis. 16-byte copies where bm and bn are multiples of 4 and x
//     and dy are 16-byte aligned, else 4-byte copies; masked elements (the
//     ragged last chunk, bm or bn below 64) are zero-filled by the copy's
//     source size, so fragments past the edge read zeros.
//   * 3xTF32 on mma.sync (tf32x3.cuh), A = x^T read from xs transposed.
//     wgmma would need both TF32 operands K-major (batch-contiguous) in
//     shared memory, and both are batch-major here: wgmma and TMA are the
//     next step, with transposed copies.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;      // output tile: kTile x kTile of the slot's bm x bn
constexpr int kDepth = 32;     // samples per stage (one chunk)
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps as 2 x 4, 32 x 16 each
constexpr int kLd = kTile + 8;
constexpr int kStageFloats = 2 * kDepth * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));
constexpr int kMaxBlock = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_dw_kernel(const float* __restrict__ x,
               const float* __restrict__ dy,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               float* __restrict__ out,  // dw (splits == 1) or part (splits > 1)
               int64_t n_blocks, int64_t batch, int64_t x_stride, int64_t dy_stride,
               int bm, int bn) {
  extern __shared__ __align__(16) float smem[];
  const int64_t i = blockIdx.x;
  const int n_tiles = (bn + kTile - 1) / kTile;
  const int m0 = static_cast<int>(blockIdx.y) / n_tiles * kTile;
  const int n0 = static_cast<int>(blockIdx.y) % n_tiles * kTile;
  const int64_t split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int m_valid = min(kTile, bm - m0);
  const int n_valid = min(kTile, bn - n0);

  const int64_t chunks = (batch + kDepth - 1) / kDepth;
  const int64_t first = chunks * split / splits;
  const int64_t n_steps = chunks * (split + 1) / splits - first;
  const float* xt = x + static_cast<int64_t>(rows[i]) * bm + m0;
  const float* dyt = dy + static_cast<int64_t>(cols[i]) * bn + n0;

  // Stage `step` of the run: samples [(first + step) * kDepth, ... + kDepth).
  auto load = [&](int64_t step) {
    float* xs = smem + (step % kStages) * kStageFloats;
    float* ys = xs + kDepth * kLd;
    const int64_t b0 = (first + step) * kDepth;
    const int k_valid = batch - b0 < kDepth ? static_cast<int>(batch - b0) : kDepth;
    const float* xb = xt + b0 * x_stride;
    const float* yb = dyt + b0 * dy_stride;
    if constexpr (kVec) {
      for (int idx = tid; idx < kDepth * (kTile / 4); idx += kThreads) {
        const int k = idx / (kTile / 4), e = (idx % (kTile / 4)) * 4;
        const bool okx = k < k_valid && e < m_valid;
        const bool oky = k < k_valid && e < n_valid;
        tf32x3::cp_async16(xs + k * kLd + e, okx ? xb + k * x_stride + e : x, okx ? 16 : 0);
        tf32x3::cp_async16(ys + k * kLd + e, oky ? yb + k * dy_stride + e : dy, oky ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int k = idx / kTile, e = idx % kTile;
        const bool okx = k < k_valid && e < m_valid;
        const bool oky = k < k_valid && e < n_valid;
        tf32x3::cp_async4(xs + k * kLd + e, okx ? xb + k * x_stride + e : x, okx ? 4 : 0);
        tf32x3::cp_async4(ys + k * kLd + e, oky ? yb + k * dy_stride + e : dy, oky ? 4 : 0);
      }
    }
  };

  float acc[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][j][r] = 0.0f;

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
    const float* ys = xs + kDepth * kLd;
    const int64_t b0 = (first + step) * kDepth;
    const int k_valid = batch - b0 < kDepth ? static_cast<int>(batch - b0) : kDepth;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      if (kk >= k_valid) break;  // the rest of the chunk is zero-filled
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float* xa = xs + (kk + t) * kLd + wm + 16 * a + g;  // A[m][b] = xs[b][m]
        tf32x3::split(xa[0], a_hi[a][0], a_lo[a][0]);
        tf32x3::split(xa[8], a_hi[a][1], a_lo[a][1]);
        tf32x3::split(xa[4 * kLd], a_hi[a][2], a_lo[a][2]);
        tf32x3::split(xa[4 * kLd + 8], a_hi[a][3], a_lo[a][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* yj = ys + (kk + t) * kLd + wn + 8 * j + g;
        tf32x3::split(yj[0], b_hi[j][0], b_lo[j][0]);
        tf32x3::split(yj[4 * kLd], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) tf32x3::mma3(acc[a][j], a_hi[a], a_lo[a], b_hi[j], b_lo[j]);
    }
  }
  tf32x3::cp_async_wait<0>();

  float* o = out + (split * n_blocks + i) * bm * bn + static_cast<int64_t>(m0) * bn + n0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + 16 * a + g + 8 * h;
      if (m >= m_valid) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 8 * j + 2 * t;
        if (n < n_valid) o[static_cast<int64_t>(m) * bn + n] = acc[a][j][2 * h];
        if (n + 1 < n_valid) o[static_cast<int64_t>(m) * bn + n + 1] = acc[a][j][2 * h + 1];
      }
    }
  }
}

bool smem_set[2][64];

}  // namespace

extern "C" int bsmm_dw_f32(const void* x, const void* dy, const void* rows,
                           const void* cols, void* dw, void* part,
                           int64_t n_blocks, int64_t batch, int64_t grid_m, int64_t grid_n,
                           int bm, int bn, int splits, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffff || grid_m < 1 || grid_n < 1 ||
      splits < 1 || splits > 65535 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = bm % 4 == 0 && bn % 4 == 0 && tf32x3::aligned16(x) && tf32x3::aligned16(dy);
  auto kernel = vec ? &bsmm_dw_kernel<true> : &bsmm_dw_kernel<false>;
  err = tf32x3::allow_smem(kernel, device, kSmemBytes, smem_set[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = ((bm + kTile - 1) / kTile) * ((bn + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned int>(n_blocks), static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(splits));
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      out, n_blocks, batch, grid_m * bm, grid_n * bn, bm, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(tf32x3::launch_sum_parts(
      static_cast<const float*>(part), static_cast<float*>(dw), n_blocks * bm * bn, splits, s));
}
