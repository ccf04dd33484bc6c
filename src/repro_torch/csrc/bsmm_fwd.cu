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
// twice in every layer's sparse FFN (models/layers.py::sparse_ffn_fwd), the
// first time with All-ReLU in its store. The wrapper picks one of three
// routes by a rule on host ints (block_sparse_matmul.py::fwd_plan):
//
//   * decode (1 to 16 rows; tile sides multiples of 32, 16-byte aligned
//     operands): the operands swap. y^T = W^T x^T, so a tile's output
//     features fill the MMA's M (16 a warp) and the batch its N (8 rows a
//     fragment): no row of a product is zero-fill. One block of 8 warps per
//     (column, 16 features), each warp a k-group. A cp.async ring of 4
//     stages, a stage one whole slot, all 4 issued at the start: the W slab
//     ws[k][n] (bm x 16, rows of 48 bytes) and the x slab xs[b][k] (8 or 16
//     rows of 272 bytes); the pitches put the 8 rows of every ldmatrix on
//     distinct banks. W^T's A fragments come by ldmatrix.trans from the
//     [k][n] slab, x's B fragments by ldmatrix. The column's flattened k
//     (slot after slot, 16 deep a step) is dealt out over the warps in turn,
//     step j to warp j mod 8, so every warp works on every slot. Nothing in
//     a product mixes batch columns, and the deal does not depend on the
//     batch, so a row's bits do not depend on how many rows the call has.
//   * rows (more than 16 rows, the same tiles): batch as M. One block of 8
//     warps per (column, 32 batch rows x 32 features, or 64 x 64: the
//     smaller where its blocks fit one wave on the card); warps are 16-row
//     groups x k-groups, k dealt out as in the decode route; both operands by
//     ldmatrix (W's by .trans); a ring of 4 slot stages (3 for 64 x 64).
//   * tiled (anything else: tiles of 8 or 16, unaligned operands): the
//     route every bf16 call took first, on the f32 instance's design, below.
//
// In both new routes the k-groups' f32 partials meet in shared memory after
// the ring, and the block's first k-group adds them in group order before
// its single store: no second pass, no f32 partials in device memory, no
// atomics. Each product is one mma.sync m16n8k16 bf16 into a zero fragment,
// added in f32 to the warp's sum (bf16 x bf16 is exact in f32; the adds
// round to nearest). The store rounds the f32 sum once to bf16
// (__float2bfloat16_rn). With the epilogue, it then applies All-ReLU as
// kernel B's bf16 entry does (csrc/bias_all_relu.cu::all_relu_bf16 with no
// bias): v = bf16(sum), v > 0 ? v : bf16(slope * v), the slope a bf16 value;
// so C with the epilogue is bit for bit C followed by B.
//
// What bounds it: the LM's W_in moves 22 x 32 KB = 0.70 MB of tiles, W_out
// 15 x 32 KB = 0.48 MB, 0.2 us at HBM rate; at 8 rows the flops are nothing.
// What sets the time is one block's chain: two dependent L2 reads (col_ptr,
// then rows) before the first copy, then each slot's copies issued and
// landed, though a ring's worth of a column's slots are in flight at once.
// So the longest column sets the time (tools/bsmm_bf16_probe.py's column
// sweep times columns of 1 to 8 slots). At 256 rows the tiles' re-reads
// through L2 (one per batch tile and feature slice) join it.
//
// The tiled route: the f32 instance's split rule, grid, ring and ragged
// batch tile. A stage is a 32-deep slice, two k16 steps: the x slice
// xs[b][k] (64 x 32 bf16, row pitch 40 = 80 bytes) and the W slice ws[k][n]
// (32 x 64 bf16, row pitch 72 = 144 bytes), 38,912 bytes for the 4 stages.
// A fragments are 32-bit loads of two neighbouring k: the 8 rows g of a
// warp's load start 20 words apart, which puts the 32 lanes on 32 banks. B
// fragments pair two 16-bit loads of rows k and k + 1 at column g. 16-byte
// copies (8 bf16) where bm and bn are multiples of 8 and x and values are
// 16-byte aligned, else plain element loads into the same ring (cp.async has
// no 2-byte copy). A split run keeps f32 partials in part (P, B,
// grid_n*bn), and the second pass adds them in index order, then rounds
// once and applies the epilogue.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace bf16mma;

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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) into one register, lo in the low half: an mma operand pair.
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The store: the f32 sum rounded once to bf16; with the epilogue, All-ReLU
// on that value as kernel B's bf16 entry computes it (slope a bf16 value).
__device__ __forceinline__ __nv_bfloat16 store_bf16(float sum, int epilogue, float slope) {
  const __nv_bfloat16 v = __float2bfloat16_rn(sum);
  if (!epilogue) return v;
  const float f = __bfloat162float(v);
  return f > 0.0f ? v : __float2bfloat16_rn(__fmul_rn(slope, f));
}

// (fragment layouts: bf16_mma.cuh)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ values,
                     const int32_t* __restrict__ rows,
                     const int64_t* __restrict__ col_ptr,
                     __nv_bfloat16* __restrict__ y,  // parts == 1
                     float* __restrict__ part,       // parts > 1: f32 partials
                     int64_t batch, int64_t x_stride, int64_t y_stride,
                     int bm, int bn, int parts, int epilogue, float slope) {
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
        for (int j = 0; j < 2; ++j) mma_bf16_add(acc[i][j], a[i], b[j]);
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
          if (n < n_valid) y[at] = store_bf16(acc[i][j][2 * h], epilogue, slope);
          if (n + 1 < n_valid) y[at + 1] = store_bf16(acc[i][j][2 * h + 1], epilogue, slope);
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
// sum in index order, as tf32x3::sum_parts takes it, rounded once, then the
// epilogue.
__global__ void sum_parts_bf16(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                               int64_t total, int parts, int epilogue, float slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = part[i];
    for (int q = 1; q < parts; ++q) s += part[q * total + i];
    out[i] = store_bf16(s, epilogue, slope);
  }
}

// --- the decode and rows routes ----------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kLdSlab = kMaxBlock + 8;  // x slab rows: 136 bf16 = 272 bytes
constexpr int kDecodeRing = 4;          // slot stages
constexpr int kDecodeFeat = 16;         // decode route: a block's features, one m16 of W^T

// The rows route's ring: 4 slot stages for 32 x 32 tiles (76 KB, 3 blocks an
// SM), 3 for 64 x 64 (108 KB, 2 blocks an SM)
template <int kRT>
__host__ __device__ constexpr int rows_ring() { return kRT == 32 ? 4 : 3; }

// W slab rows: the block's features + 8 bf16 (48, 80 or 144 bytes): with the
// x slab's 272, the 8 row addresses of an ldmatrix fall on 8 distinct
// 16-byte bank groups.
template <int kFeat>
__host__ __device__ constexpr int ld_w() { return kFeat + 8; }

template <int kFeat, int kRows>
__host__ __device__ constexpr int stage_halves() {
  return kMaxBlock * ld_w<kFeat>() + kRows * kLdSlab;
}

template <int kNB>
__host__ __device__ constexpr int decode_smem() {
  return kDecodeRing * stage_halves<kDecodeFeat, 8 * kNB>() * 2;
}

template <int kRT, int kFeat>
__host__ __device__ constexpr int rows_smem() {
  return rows_ring<kRT>() * stage_halves<kFeat, kRT>() * 2;
}

// The first of this group's k16 steps in a slot whose flattened steps start
// at j0: steps j with j mod groups == group.
__device__ __forceinline__ int first_step(int j0, int group, int groups) {
  return ((group - j0) % groups + groups) % groups;
}

// Load slot s, whose x block-row is xrow, into a stage: the W slab (bm rows
// of the block's kFeat features from n0) and the x slab (kRows batch rows
// from b0, bm wide; rows at or past b_valid zero-filled). bm and bn are
// multiples of 32 and both operands 16-byte aligned: every chunk is 16
// bytes, all in or all out.
template <int kFeat, int kRows>
__device__ __forceinline__ void load_slot(__nv_bfloat16* ws, const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ values, int64_t s,
                                          int32_t xrow, int64_t b0, int b_valid, int n0,
                                          int64_t x_stride, int bm, int bn, int tid) {
  constexpr int kChunksW = kFeat / 8;
  __nv_bfloat16* xs = ws + kMaxBlock * ld_w<kFeat>();
  const __nv_bfloat16* wt = values + s * bm * bn + n0;
  for (int idx = tid; idx < bm * kChunksW; idx += kThreads) {
    const int k = idx / kChunksW, n = (idx % kChunksW) * 8;
    cp_async16_bf16(ws + k * ld_w<kFeat>() + n, wt + static_cast<int64_t>(k) * bn + n, 16);
  }
  const int chunks = bm / 8;
  const __nv_bfloat16* xt = x + b0 * x_stride + static_cast<int64_t>(xrow) * bm;
  for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
    const int b = idx / chunks, k = (idx % chunks) * 8;
    const bool ok = b < b_valid;
    cp_async16_bf16(xs + b * kLdSlab + k, ok ? xt + b * x_stride + k : x, ok ? 16 : 0);
  }
}

// The decode route: one block per (column, 16 features). Each warp is a
// k-group; it holds W^T (16 features x 16 k) and kNB x-fragments (16 k x 8
// rows) a step.
template <int kNB>
__global__ void __launch_bounds__(kThreads)
bsmm_fwd_bf16_decode(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ values,
                     const int32_t* __restrict__ rows,
                     const int64_t* __restrict__ col_ptr,
                     __nv_bfloat16* __restrict__ y,
                     int batch, int64_t x_stride, int64_t y_stride,
                     int bm, int bn, int epilogue, float slope) {
  constexpr int kStage = stage_halves<kDecodeFeat, 8 * kNB>();
  constexpr int kLdW = ld_w<kDecodeFeat>();
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  const int slices = bn / kDecodeFeat;
  const int64_t c = blockIdx.x / slices;
  const int n0 = static_cast<int>(blockIdx.x % slices) * kDecodeFeat;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t lo = col_ptr[c];
  const int len = static_cast<int>(col_ptr[c + 1] - lo);
  const int ks = bm / 16;

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.0f;

  // Every stage is free at the start, so the first kDecodeRing slots go out
  // at once: a column of up to 4 slots waits one load. Their x block-rows
  // (and the next slot's) are read before any copy is issued: a copy's
  // memory clobber would hold each read back behind the copies before it,
  // one L2 round trip a slot.
  int32_t xrow[kDecodeRing + 1];
#pragma unroll
  for (int st = 0; st <= kDecodeRing; ++st) xrow[st] = st < len ? rows[lo + st] : 0;
#pragma unroll
  for (int st = 0; st < kDecodeRing; ++st) {
    if (st < len)
      load_slot<kDecodeFeat, 8 * kNB>(smem + st * kStage, x, values, lo + st, xrow[st], 0,
                                      batch, n0, x_stride, bm, bn, tid);
    tf32x3::cp_async_commit();
  }
  int32_t next_row = xrow[kDecodeRing];
  // this lane's ldmatrix rows: A from the W slab (k rows, the 16
  // features), B from the x slab (batch rows, k from kk)
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * kLdW + ((lane >> 3) & 1) * 8;
  const int b_off = kMaxBlock * kLdW + ((lane >> 4) * 8 + (lane & 7)) * kLdSlab +
                    ((lane >> 3) & 1) * 8;
  for (int step = 0; step < len; ++step) {
    // this slot's stage has landed: slot j is commit group j (the prologue's
    // kDecodeRing, then one a step from step 1), so before step s's wait
    // kDecodeRing + s - 1 groups are out and group s must be done
    if (step == 0) {
      tf32x3::cp_async_wait<kDecodeRing - 1>();
    } else {
      tf32x3::cp_async_wait<kDecodeRing - 2>();
    }
    __syncthreads();  // ... for every thread; the last step's stage is free
    if (step > 0) {
      if (step + kDecodeRing - 1 < len) {
        load_slot<kDecodeFeat, 8 * kNB>(
            smem + ((step + kDecodeRing - 1) % kDecodeRing) * kStage, x, values,
            lo + step + kDecodeRing - 1, next_row, 0, batch, n0, x_stride, bm, bn, tid);
        if (step + kDecodeRing < len) next_row = rows[lo + step + kDecodeRing];  // the next one
      }
      tf32x3::cp_async_commit();
    }

    const __nv_bfloat16* stage = smem + (step % kDecodeRing) * kStage;
    for (int q = first_step(step * ks, warp, kWarps); q < ks; q += kWarps) {
      const int kk = 16 * q;
      uint32_t a[4], b[kNB][2];
      ldmatrix_x4_trans(smem_addr(stage + a_off + kk * kLdW), a[0], a[1], a[2], a[3]);
      if constexpr (kNB == 1) {
        ldmatrix_x2(smem_addr(stage + b_off + kk), b[0][0], b[0][1]);
      } else {
        tf32x3::ldmatrix_x4(smem_addr(stage + b_off + kk), b[0][0], b[0][1], b[1][0], b[1][1]);
      }
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) mma_bf16_add(acc[nb], a, b[nb]);
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partials meet in it

  float4* red = reinterpret_cast<float4*>(smem_bytes);  // [kWarps][kNB][32]
  if (warp > 0) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      red[(warp * kNB + nb) * 32 + lane] = make_float4(acc[nb][0], acc[nb][1], acc[nb][2],
                                                       acc[nb][3]);
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < kWarps; ++w) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const float4 p = red[(w * kNB + nb) * 32 + lane];
      acc[nb][0] += p.x;
      acc[nb][1] += p.y;
      acc[nb][2] += p.z;
      acc[nb][3] += p.w;
    }
  }
  // C = (y^T)[16 features][8 rows]: c0 = y[2t][g], c1 = y[2t+1][g], c2 and
  // c3 the same rows at feature g + 8
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* yc = y + c * bn + n0 + g;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = 8 * nb + 2 * t + (r & 1);
      if (b < batch) yc[b * y_stride + (r >> 1) * 8] = store_bf16(acc[nb][r], epilogue, slope);
    }
}

// The rows route: one block per (column, kRT batch rows, kFeat features).
// Warps are kMW groups of 16 rows x kKW k-groups; a warp holds x (16 rows x
// 16 k) and kFeat / 8 W fragments (16 k x 8 features) a step.
template <int kRT, int kFeat>
__global__ void __launch_bounds__(kThreads)
bsmm_fwd_bf16_rows(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ values,
                   const int32_t* __restrict__ rows,
                   const int64_t* __restrict__ col_ptr,
                   __nv_bfloat16* __restrict__ y,
                   int64_t batch, int64_t x_stride, int64_t y_stride,
                   int bm, int bn, int epilogue, float slope) {
  constexpr int kMW = kRT / 16;
  constexpr int kKW = kWarps / kMW;
  constexpr int kNF = kFeat / 8;
  constexpr int kStage = stage_halves<kFeat, kRT>();
  constexpr int kLdW = ld_w<kFeat>();
  constexpr int kRing = rows_ring<kRT>();
  static_assert(kMW * kKW == kWarps, "warps are row groups x k-groups");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  const int slices = bn / kFeat;
  const int64_t c = blockIdx.x / slices;
  const int n0 = static_cast<int>(blockIdx.x % slices) * kFeat;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kRT;
  const int b_valid = batch - b0 < kRT ? static_cast<int>(batch - b0) : kRT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = warp % kMW, kw = warp / kMW;
  const int64_t lo = col_ptr[c];
  const int len = static_cast<int>(col_ptr[c + 1] - lo);
  const int ks = bm / 16;

  float acc[kNF][4];
#pragma unroll
  for (int f = 0; f < kNF; ++f)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[f][r] = 0.0f;

  int32_t xrow[kRing + 1];  // as in the decode route
#pragma unroll
  for (int st = 0; st <= kRing; ++st) xrow[st] = st < len ? rows[lo + st] : 0;
#pragma unroll
  for (int st = 0; st < kRing; ++st) {
    if (st < len)
      load_slot<kFeat, kRT>(smem + st * kStage, x, values, lo + st, xrow[st], b0, b_valid, n0,
                            x_stride, bm, bn, tid);
    tf32x3::cp_async_commit();
  }
  int32_t next_row = xrow[kRing];
  // this lane's ldmatrix rows: A from the x slab (rows 16 * mw.., k from
  // kk), B from the W slab (k rows from kk, features 16 apart)
  const int a_off = kMaxBlock * kLdW + (16 * mw + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdSlab +
                    (lane >> 4) * 8;
  const int b_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kLdW + (lane >> 4) * 8;
  for (int step = 0; step < len; ++step) {
    if (step == 0) {  // the groups as in the decode route
      tf32x3::cp_async_wait<kRing - 1>();
    } else {
      tf32x3::cp_async_wait<kRing - 2>();
    }
    __syncthreads();
    if (step > 0) {
      if (step + kRing - 1 < len) {
        load_slot<kFeat, kRT>(smem + ((step + kRing - 1) % kRing) * kStage, x, values,
                              lo + step + kRing - 1, next_row, b0, b_valid, n0, x_stride, bm,
                              bn, tid);
        if (step + kRing < len) next_row = rows[lo + step + kRing];
      }
      tf32x3::cp_async_commit();
    }

    const __nv_bfloat16* stage = smem + (step % kRing) * kStage;
    for (int q = first_step(step * ks, kw, kKW); q < ks; q += kKW) {
      const int kk = 16 * q;
      uint32_t a[4], b[kNF][2];
      tf32x3::ldmatrix_x4(smem_addr(stage + a_off + kk), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int h = 0; h < kNF / 2; ++h)
        ldmatrix_x4_trans(smem_addr(stage + b_off + kk * kLdW + 16 * h), b[2 * h][0],
                          b[2 * h][1], b[2 * h + 1][0], b[2 * h + 1][1]);
#pragma unroll
      for (int f = 0; f < kNF; ++f) mma_bf16_add(acc[f], a, b[f]);
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  float4* red = reinterpret_cast<float4*>(smem_bytes);  // [kKW][kMW][kNF][32]
  if (kw > 0) {
#pragma unroll
    for (int f = 0; f < kNF; ++f)
      red[((kw * kMW + mw) * kNF + f) * 32 + lane] =
          make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
  }
  __syncthreads();
  if (kw > 0) return;
  for (int w = 1; w < kKW; ++w) {
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const float4 p = red[((w * kMW + mw) * kNF + f) * 32 + lane];
      acc[f][0] += p.x;
      acc[f][1] += p.y;
      acc[f][2] += p.z;
      acc[f][3] += p.w;
    }
  }
  // c0, c1 = y[g][2t..2t+1] and c2, c3 the same features of row g + 8: one
  // 4-byte store each (bn is even, so the pair is aligned)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = 16 * mw + g + 8 * h;
    if (b >= b_valid) continue;
    __nv_bfloat16* yr = y + (b0 + b) * y_stride + c * bn + n0 + 2 * t;
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      __nv_bfloat162 v;
      v.x = store_bf16(acc[f][2 * h], epilogue, slope);
      v.y = store_bf16(acc[f][2 * h + 1], epilogue, slope);
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * f) = v;
    }
  }
}

// What the wrapper hands the new routes' launchers.
struct Bf16Call {
  const __nv_bfloat16* x;
  const __nv_bfloat16* values;
  const int32_t* rows;
  const int64_t* col_ptr;
  __nv_bfloat16* y;
  int64_t batch, x_stride, y_stride, grid_n;
  int bm, bn, epilogue;
  float slope;
  int device;
  cudaStream_t stream;
};

template <int kNB>
cudaError_t launch_decode(const Bf16Call& a) {
  static bool done[64];
  constexpr int smem = decode_smem<kNB>();
  auto kernel = &bsmm_fwd_bf16_decode<kNB>;
  const cudaError_t err = tf32x3::allow_smem(kernel, a.device, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(a.grid_n * (a.bn / kDecodeFeat)));
  kernel<<<grid, kThreads, smem, a.stream>>>(a.x, a.values, a.rows, a.col_ptr, a.y,
                                              static_cast<int>(a.batch), a.x_stride, a.y_stride,
                                              a.bm, a.bn, a.epilogue, a.slope);
  return cudaGetLastError();
}

template <int kRT, int kFeat>
cudaError_t launch_rows(const Bf16Call& a) {
  static bool done[64];
  constexpr int smem = rows_smem<kRT, kFeat>();
  auto kernel = &bsmm_fwd_bf16_rows<kRT, kFeat>;
  const cudaError_t err = tf32x3::allow_smem(kernel, a.device, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(a.grid_n * (a.bn / kFeat)),
                  static_cast<unsigned int>((a.batch + kRT - 1) / kRT));
  kernel<<<grid, kThreads, smem, a.stream>>>(a.x, a.values, a.rows, a.col_ptr, a.y, a.batch,
                                              a.x_stride, a.y_stride, a.bm, a.bn, a.epilogue,
                                              a.slope);
  return cudaGetLastError();
}

constexpr int kRouteTiled = 0, kRouteDecode = 1, kRouteRows = 2;

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

// The bf16 instance: x, values and y bf16; part (tiled route, parts > 1)
// f32. route 0 is the tiled route (its split into parts runs); 1 the decode
// route (batch <= 16; tile_feat 16 features a block); 2 the rows route
// (tile_rows x tile_feat 32 x 32 or 64 x 64 batch rows x features). The
// new routes take bm and bn multiples of 32, 16-byte aligned x, values and
// y, and parts 1. epilogue != 0: All-ReLU with slope (a bf16 value) in the
// store.
extern "C" int bsmm_fwd_bf16(const void* x, const void* values, const void* rows,
                             const void* col_ptr, void* y, void* part,
                             int64_t batch, int64_t grid_m, int64_t grid_n,
                             int bm, int bn, int parts, int route, int tile_rows, int tile_feat,
                             int epilogue, float slope, int device, void* stream) {
  if (bm < 1 || bm > kMaxBlock || bn < 1 || bn > kMaxBlock || batch < 0 ||
      grid_m < 1 || grid_n < 1 || parts < 1 || grid_n * parts > 0x7fffffff ||
      (parts > 1 && part == nullptr) || route < kRouteTiled || route > kRouteRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (route != kRouteTiled) {
    const bool ok = parts == 1 && bm % 32 == 0 && bn % 32 == 0 && tf32x3::aligned16(x) &&
                    tf32x3::aligned16(values) && tf32x3::aligned16(y) &&
                    grid_n * (bn / 16) <= 0x7fffffff;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return static_cast<int>(cudaGetLastError());
    const Bf16Call a{static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(values),
                     static_cast<const int32_t*>(rows), static_cast<const int64_t*>(col_ptr),
                     static_cast<__nv_bfloat16*>(y), batch, grid_m * bm, grid_n * bn, grid_n,
                     bm, bn, epilogue, slope, device, s};
    if (route == kRouteDecode) {
      if (batch > 16) return static_cast<int>(cudaErrorInvalidValue);
      const bool two = batch > 8;
      if (tile_feat != kDecodeFeat) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(two ? launch_decode<2>(a) : launch_decode<1>(a));
    }
    if (tile_rows < 1 || (batch + tile_rows - 1) / tile_rows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (tile_rows == 32 && tile_feat == 32) return static_cast<int>(launch_rows<32, 32>(a));
    if (tile_rows == 64 && tile_feat == 64 && bn % 64 == 0)
      return static_cast<int>(launch_rows<64, 64>(a));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t batch_tiles = (batch + kTileB - 1) / kTileB;
  if (batch_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tiles == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = bm % 8 == 0 && bn % 8 == 0 && tf32x3::aligned16(x) &&
                   tf32x3::aligned16(values);
  auto kernel = vec ? &bsmm_fwd_bf16_kernel<true> : &bsmm_fwd_bf16_kernel<false>;
  const dim3 grid(static_cast<unsigned int>(grid_n * parts),
                  static_cast<unsigned int>(batch_tiles),
                  static_cast<unsigned int>((bn + kTileN - 1) / kTileN));
  kernel<<<grid, kThreads, kSmemBytesBf16, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(values),
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(col_ptr),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), batch, grid_m * bm,
      grid_n * bn, bm, bn, parts, epilogue, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const int64_t total = batch * grid_n * bn;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + 255) / 256;
  sum_parts_bf16<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(y), total, parts, epilogue,
      slope);
  return static_cast<int>(cudaGetLastError());
}
