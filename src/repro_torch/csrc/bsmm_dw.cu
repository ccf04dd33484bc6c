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
// The bf16 instance, bsmm_dw_bf16: the tile gradients of kernel C's bf16
// instance, which the bfloat16 LM's training step runs twice a layer (W_in:
// x (2048, 1024) and dy (2048, 2816) -> (22, 128, 128); W_out: x (2048,
// 2816) and dy (2048, 1024) -> (15, 128, 128)). The Pallas _dw_kernel sums
// bf16 products on the MXU into an f32 VMEM scratch across the batch tiles
// of its sequential grid and rounds once. Here:
//   * the batch is cut into S runs of 64-sample chunks, S from host ints
//     (block_sparse_matmul.py::dw_splits_bf16: about two blocks an SM);
//     one block of 8 warps per (slot, 64 x 64 part of its tile, run). S = 1
//     rounds the f32 sum once into dw; S > 1 writes the runs' f32 partials
//     to part (S, nb, bm, bn) and a second pass adds them in index order and
//     rounds once: no atomics, the same bits every run;
//   * a cp.async ring of 4 stages, 3 issued before the loop (the f32
//     instance's ring): a stage is 64 samples of the slot's x columns
//     xs[b][m] and dy columns ys[b][n] at 144-byte rows, so the 8 row
//     addresses of every ldmatrix fall on distinct bank groups; both
//     operands by ldmatrix.trans (A[m][b] = x[b][m] and B[b][n] from
//     batch-major slabs), mma.sync m16n8k16 bf16 into f32, the 8 warps 4 x 2
//     over the 64 x 64 output, each product taken into a zero fragment and
//     added in f32 (mma_bf16_add);
//   * tile sides are multiples of 16 (the wrapper raises for others); a
//     ragged last chunk and features past a side below 64 are zero-filled.
// What bounds it: bytes. On W_in at 2,048 rows it reads dy's 22
// block-columns (11.5 MB) and x's touched block-rows (at most 4.2 MB) and
// writes 0.7 MB, 4.9 us at 3.35 TB/s; its 1.48 GFLOP take 1.5 us at the
// bf16 rate. Each block reads its run of x and dy columns once; a
// block-column of dy is read again by every slot that holds it and each
// part of a tile, through L2.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
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

// --- the bf16 instance --------------------------------------------------------

using namespace bf16mma;

constexpr int kTileH = 64;            // output: a 64 x 64 part of the slot's bm x bn
constexpr int kChunkH = 64;           // samples per stage
constexpr int kRingH = 4;
constexpr int kLdH = kTileH + 8;      // slab rows: 72 bf16 = 144 bytes
constexpr int kStageH = 2 * kChunkH * kLdH;  // bf16 elements: x slab, then dy slab
constexpr int kSmemH = kRingH * kStageH * static_cast<int>(sizeof(__nv_bfloat16));
constexpr int kNFH = 4;               // a warp's n8 fragments: 16 x 32 of the 64 x 64

// One block per (slot i, 64 x 64 part of its tile, run of the batch). A
// stage is 64 samples of the slot's x columns xs[b][m] and dy columns
// ys[b][n]; the 8 warps tile the output as 4 x 2, each 16 m x 32 n, and
// every warp takes every k16 step of every stage. Both operands come by
// ldmatrix.trans: A[m][b] = x[b][m] is a row-major fragment of the [b][m]
// slab transposed, B[b][n] a column-major one of the [b][n] slab.
__global__ void __launch_bounds__(kThreads)
bsmm_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols,
                    __nv_bfloat16* __restrict__ dw,  // splits == 1
                    float* __restrict__ part,        // splits > 1: f32 partials
                    int64_t n_blocks, int64_t batch, int64_t x_stride, int64_t dy_stride,
                    int bm, int bn) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  const int64_t i = blockIdx.x;
  const int n_tiles = (bn + kTileH - 1) / kTileH;
  const int m0 = static_cast<int>(blockIdx.y) / n_tiles * kTileH;
  const int n0 = static_cast<int>(blockIdx.y) % n_tiles * kTileH;
  const int64_t split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  const int m_valid = min(kTileH, bm - m0);
  const int n_valid = min(kTileH, bn - n0);

  const int64_t chunks = (batch + kChunkH - 1) / kChunkH;
  const int64_t first = chunks * split / splits;
  const int64_t n_steps = chunks * (split + 1) / splits - first;
  const __nv_bfloat16* xt = x + static_cast<int64_t>(rows[i]) * bm + m0;
  const __nv_bfloat16* yt = dy + static_cast<int64_t>(cols[i]) * bn + n0;

  // Stage `step` of the run: samples [(first + step) * kChunkH, ... + kChunkH);
  // samples past the batch and features past m_valid / n_valid zero-filled
  // (multiples of 16: a 16-byte chunk is all in or all out).
  auto load = [&](int64_t step) {
    __nv_bfloat16* xs = smem + (step % kRingH) * kStageH;
    __nv_bfloat16* ys = xs + kChunkH * kLdH;
    const int64_t b0 = (first + step) * kChunkH;
    const int k_valid = batch - b0 < kChunkH ? static_cast<int>(batch - b0) : kChunkH;
    for (int idx = tid; idx < kChunkH * (kTileH / 8); idx += kThreads) {
      const int k = idx / (kTileH / 8), e = (idx % (kTileH / 8)) * 8;
      const bool okx = k < k_valid && e < m_valid;
      const bool oky = k < k_valid && e < n_valid;
      cp_async16_bf16(xs + k * kLdH + e, okx ? xt + (b0 + k) * x_stride + e : x, okx ? 16 : 0);
      cp_async16_bf16(ys + k * kLdH + e, oky ? yt + (b0 + k) * dy_stride + e : dy, oky ? 16 : 0);
    }
  };

  float acc[kNFH][4];
#pragma unroll
  for (int f = 0; f < kNFH; ++f)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[f][q] = 0.0f;

  // this lane's ldmatrix rows: A's matrices (b lo, m lo), (b lo, m hi),
  // (b hi, m lo), (b hi, m hi) = a0..a3; B's (n lo, b lo), (n lo, b hi),
  // (n hi, b lo), (n hi, b hi) = b[2h][0], b[2h][1], b[2h + 1][0], b[2h + 1][1]
  const int mat = lane >> 3, row = lane & 7;
  const int a_off = (8 * (mat >> 1) + row) * kLdH + wm + 8 * (mat & 1);
  const int b_off = kChunkH * kLdH + (8 * (mat & 1) + row) * kLdH + wn + 8 * (mat >> 1);

#pragma unroll
  for (int st = 0; st < kRingH - 1; ++st) {
    if (st < n_steps) load(st);
    tf32x3::cp_async_commit();
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    tf32x3::cp_async_wait<kRingH - 2>();  // this step's stage has landed
    __syncthreads();                      // ... for every thread; the oldest buffer is free
    if (step + kRingH - 1 < n_steps) load(step + kRingH - 1);
    tf32x3::cp_async_commit();

    const __nv_bfloat16* stage = smem + (step % kRingH) * kStageH;
    const int64_t b0 = (first + step) * kChunkH;
    const int k_valid = batch - b0 < kChunkH ? static_cast<int>(batch - b0) : kChunkH;
#pragma unroll
    for (int kb = 0; kb < kChunkH; kb += 16) {
      if (kb >= k_valid) break;  // the rest of the chunk is zero-filled
      uint32_t a[4], b[kNFH][2];
      ldmatrix_x4_trans(smem_addr(stage + a_off + kb * kLdH), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int h = 0; h < kNFH / 2; ++h)
        ldmatrix_x4_trans(smem_addr(stage + b_off + kb * kLdH + 16 * h), b[2 * h][0],
                          b[2 * h][1], b[2 * h + 1][0], b[2 * h + 1][1]);
#pragma unroll
      for (int f = 0; f < kNFH; ++f) mma_bf16_add(acc[f], a, b[f]);
    }
  }
  tf32x3::cp_async_wait<0>();

  // c0, c1 = dw[wm + g][wn + 8f + 2t..] and c2, c3 row + 8: bf16 rounded
  // once (one run) or the run's f32 partial
  const int g = lane >> 2, t = lane & 3;
  const int64_t tile = i * bm * bn + static_cast<int64_t>(m0) * bn + n0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wm + g + 8 * h;
    if (m >= m_valid) continue;
#pragma unroll
    for (int f = 0; f < kNFH; ++f) {
      const int n = wn + 8 * f + 2 * t;
      if (n >= n_valid) break;  // n_valid is a multiple of 16
      const int64_t at = tile + static_cast<int64_t>(m) * bn + n;
      if (splits == 1) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(acc[f][2 * h]);
        v.y = __float2bfloat16_rn(acc[f][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dw + at) = v;
      } else {
        *reinterpret_cast<float2*>(part + split * n_blocks * bm * bn + at) =
            make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
      }
    }
  }
}

// out[i] = bf16(part[0][i] + ... + part[parts-1][i]): the runs' f32 sums in
// index order, rounded once.
__global__ void sum_parts_bf16(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                               int64_t total, int parts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    float s = part[e];
    for (int q = 1; q < parts; ++q) s += part[q * total + e];
    out[e] = __float2bfloat16_rn(s);
  }
}

bool smem_set_bf16[64];

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

// The bf16 instance: x, dy and dw bf16, part (splits > 1) f32. bm and bn are
// multiples of 16 up to 128; x and dy 16-byte aligned, dw 4-byte, part 8-byte.
extern "C" int bsmm_dw_bf16(const void* x, const void* dy, const void* rows,
                            const void* cols, void* dw, void* part,
                            int64_t n_blocks, int64_t batch, int64_t grid_m, int64_t grid_n,
                            int bm, int bn, int splits, int device, void* stream) {
  if (bm < 16 || bm > kMaxBlock || bm % 16 || bn < 16 || bn > kMaxBlock || bn % 16 ||
      batch < 0 || n_blocks < 0 || n_blocks > 0x7fffffff || grid_m < 1 || grid_n < 1 ||
      splits < 1 || splits > 65535 || (splits > 1 && part == nullptr) ||
      !tf32x3::aligned16(x) || !tf32x3::aligned16(dy) ||
      (reinterpret_cast<uintptr_t>(dw) & 3) || (reinterpret_cast<uintptr_t>(part) & 7)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  err = tf32x3::allow_smem(&bsmm_dw_bf16_kernel, device, kSmemH, smem_set_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = ((bm + kTileH - 1) / kTileH) * ((bn + kTileH - 1) / kTileH);
  const dim3 grid(static_cast<unsigned int>(n_blocks), static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(splits));
  bsmm_dw_bf16_kernel<<<grid, kThreads, kSmemH, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<__nv_bfloat16*>(dw), static_cast<float*>(part), n_blocks, batch,
      grid_m * bm, grid_n * bn, bm, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = n_blocks * bm * bn;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sum_parts_bf16<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw), total, splits);
  return static_cast<int>(cudaGetLastError());
}
