// Kernel A: the element-sparse (COO) product in transposed layout.
//
//   outT[s, b] = acc[s, b] + sum_{j in [seg_ptr[s], seg_ptr[s+1])} srcT[gather[j], b] * values[j]
//
// Replaces src/repro/core/sparsity.py::coo_matmul_T, an XLA lax.scan of
// sorted segment_sums (not a Pallas kernel). The serving path runs it as the
// forward product (gather = rows, segments = cols, canonical (col, row)
// order); the element training path runs it for the forward too, and for dX
// (gather = cols_r, segments = rows_r, values gathered through perm_r by the
// caller; the dual order's segments are 10-136 slots at full width, so route
// 0 serves them).
//
// The sum. Every output is one f32 chain in slot order:
//
//   sum = acc ? acc[s, b] : 0;  for j in [seg_ptr[s], seg_ptr[s+1]): sum = fmaf(x[gather[j], b], values[j], sum)
//
// and both routes below run exactly this chain, so they give the same bits,
// on every launch. The chain is not split into runs summed apart: lossless
// compaction removes the slots whose value is 0 and must leave the served
// logits bit-equal (tests/test_serve.py::test_eliminate_dead_neurons_bit_equivalent,
// and chip_smoke.py on the card). fmaf(x, 0, sum) == sum, so dropping a zero
// slot from one left-to-right chain changes nothing; a split whose runs end
// at fixed slot counts would put other slots in each run once the zeros are
// gone, and the rounding would change.
//
// What bounds it on an H100: 2 flops per slot and batch column against at
// least 4 bytes of srcT per slot and column read through L2, so bytes, never
// the f32 units, bound a layer whose segments are short (the served hidden
// layers: 19-73 slots on average). A long segment is bound by its chain's
// latency, ~4.2 cycles per dependent FMA: the Table-4 output layer's
// 500,000 slots are ~2.1 M cycles (~1.06 ms at 1.99 GHz) whatever the batch,
// against a bytes bound of ~21 us at batch 32; the served output layer's
// 2,800 slots ~6 us. Behind the chain, one SM gathers srcT rows at no more
// than ~6.3 cycles a 128-byte row (cp.async, however much is in flight), so
// a block stages 16 columns, 64 bytes a slot, not 32.
//
// Two routes, chosen by the wrapper from host ints (the longest segment,
// core/sparsity.py::coo_route); the same code computes both chains:
//
//   * route 0, short segments: one thread per (segment, batch column),
//     flattened as s * B + b. At B = 128 the 32 lanes of a warp read 32
//     consecutive floats of one srcT row (coalesced) and gather[j] / values[j]
//     are one broadcast load; at B = 1 the lanes cover consecutive segments.
//     Loads are issued kUnroll at a time ahead of the FMAs. Many warps hide
//     the latency of short walks.
//   * route 1, long segments: one block of 192 threads per (segment, 16-wide
//     slice of the batch columns); at B = 32 the Table-4 output layer's 2
//     segments make 4 blocks, at B = 128 the served one's 10 make 80. Warp 0
//     runs the chains, lanes 0-15 one batch column each. Warps 1, 2, 3 and 5
//     stage the segment through shared memory in chunks of 512 slots, a ring
//     of 4 stages (~136 KB), each with a full and an empty mbarrier: the
//     chunk's values (4-byte cp.async) and its gathered srcT rows (16-byte
//     cp.async where B is a multiple of 4 and srcT is 16-byte aligned, else
//     4-byte), the full barrier completing as every loader's copies land
//     (cp.async.mbarrier.arrive). The summing warp waits for the stage it
//     needs alone and frees it with one arrive; warp 4 leaves at once, so
//     the summing warp has its SM sub-partition's scheduler to itself. The
//     loaders hold the gather indices of 3 chunks in registers: a row's
//     address needs its index, and with one chunk's indices in flight each
//     chunk's copies waited for a global load. The summing warp issues in
//     order. A full chunk is straight-line code: each run of 32 slots loads
//     its operands in 16 instructions (ldmatrix.x4 hands each lane its
//     column's x of 4 slots; float4 broadcasts of 4 values) among the 32
//     FMAs of the run before, which the compiler spreads one or two FMAs
//     apart, and the chunk's last run loads the next chunk's first. Over
//     the chain's ~4.2 cycles a slot this leaves ~0.25 of loads and chunk
//     turns and ~0.15 of waits for a stage to land (tools/block_span_probe.py).
//
// Segment offsets come from seg_ptr (n_segments + 1 int64 offsets); all
// offset arithmetic is 64-bit. An empty segment yields acc, or exactly 0
// (then the epilogue's value of it).
//
// out may be acc itself: the out-of-core stream (src/repro_torch/xl/
// stream.py) accumulates each connection shard in place into the rows of
// its carried (d_max, B) buffer that the shard's segments cover, the torch
// form of the reference's donated accumulator. It is safe because the one
// thread (route 0) or lane (route 1) that owns an output reads its acc once,
// before its chain, and writes its out once, after it, and no other thread
// touches that element; so acc and out carry no __restrict__, and acc is
// read with a plain load, not through the read-only cache.
//
// The epilogue (kernel B's work, fused into the store). The served forward
// keeps every activation in this (features, batch) layout, and each layer
// ends in its bias and, on a hidden layer, All-ReLU (paper Eq. 3), so the
// store applies them itself, with one bias value per segment (= output
// feature):
//
//   epilogue 0: out = sum
//   epilogue 1: out = v,                          v = __fadd_rn(sum, bias[s])
//   epilogue 2: out = v > 0 ? v : __fmul_rn(slope, v)
//   epilogue 3: out as epilogue 2, and mask = v > 0 (uint8, one per output)
//
// Epilogue 3 is the training forward's: All-ReLU's backward (kernel G's
// work, in csrc/coo_dw.cu's epilogue) needs the branch each output took, and
// the output alone does not give it: on the paper's even hidden layers the
// slope is -alpha, so a negative v gives a positive output
// (src/repro/core/all_relu.py). The mask costs one byte an output (512 KB a
// 4000-wide layer at batch 128) against the four of keeping v. At v == 0 it
// is 0, the slope branch, as the reference's jnp.where(x > 0, ...) takes.
//
// This replaces the standalone pass src/repro/kernels/all_relu_fused.py::
// bias_all_relu (kernel B, csrc/bias_all_relu.cu, which the block path
// still runs) on the element serving path, and with it the transposes that
// pass needed around it. The bias is added after the whole chain, never as
// its start value and never through acc: starting the chain at the bias
// would round every partial sum differently, so dropping a zero slot would
// no longer leave the bits alone (the compaction contract above), and acc
// stays a pure carry-in (the XL shard path). The _rn intrinsics keep the
// compiler from contracting the add and the multiply into an FMA, so the
// result is bit for bit kernel A followed by kernel B (or by `+ bias`):
// the same IEEE add, compare and multiply as B and as the plain `where`.
// Each summing thread loads its bias value before its chain, so the load's
// latency hides under the chain's. Route 0 at batch 1 walks consecutive
// segments, so its bias loads coalesce; at larger batches and on the staged
// route (one segment a block) a warp's lanes load one bias value, a
// broadcast. Its bound is the bias's bytes, 4 per segment (11 KB, ~3 ns,
// on the widest served layer), against the 8 bytes per element that
// kernel B's own pass reads and writes.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

// --- route 0: one thread per (segment, batch column) --------------------------

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// The store's epilogue: 0 none, 1 + b, 2 and 3 + b then All-ReLU with slope,
// where b = bias[s] was loaded before the chain (its latency hides under it),
// and with mode 3 the sign mask of v. The add and the multiply round apart
// (no FMA contraction).
__device__ __forceinline__ void store(float sum, float b, float slope, int mode, float* out,
                                      uint8_t* mask, int64_t t) {
  if (mode == 0) {
    out[t] = sum;
    return;
  }
  const float v = __fadd_rn(sum, b);
  const bool positive = v > 0.0f;
  out[t] = mode == 1 || positive ? v : __fmul_rn(slope, v);
  if (mode == 3) mask[t] = positive ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
coo_matmul_T_kernel(const float* __restrict__ srcT,
                    const float* __restrict__ values,
                    const int32_t* __restrict__ gather,
                    const int64_t* __restrict__ seg_ptr,
                    const float* acc,
                    const float* __restrict__ bias,
                    float* out,
                    uint8_t* __restrict__ mask,
                    int64_t n_segments,
                    int64_t batch,
                    float slope,
                    int mode) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_segments * batch) return;
  const int64_t s = t / batch;
  const int64_t b = t - s * batch;
  const int64_t end = seg_ptr[s + 1];
  int64_t j = seg_ptr[s];
  float sum = acc != nullptr ? acc[t] : 0.0f;
  const float bias_s = mode != 0 ? __ldg(bias + s) : 0.0f;
  for (; j + kUnroll <= end; j += kUnroll) {
    float x[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(values + j + u);
      x[u] = __ldg(srcT + static_cast<int64_t>(__ldg(gather + j + u)) * batch + b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sum = fmaf(x[u], v[u], sum);
  }
  for (; j < end; ++j) {
    const float x = __ldg(srcT + static_cast<int64_t>(__ldg(gather + j)) * batch + b);
    sum = fmaf(x, __ldg(values + j), sum);
  }
  store(sum, bias_s, slope, mode, out, mask, t);
}

// --- route 1: one block per (segment, 16 batch columns), staged ---------------

constexpr int kCols = 16;                     // batch columns per block: warp 0's lanes 0-15
constexpr int kLoaders = 128;                 // warps 1, 2, 3 and 5 copy
constexpr int kStagedThreads = 6 * 32;        // warp 4 leaves at once
constexpr int kChunk = 512;                   // slots per stage
constexpr int kStagedStages = 4;
constexpr int kIdxAhead = 3;                  // chunks of gather indices a loader holds
constexpr int kRun = 32;                      // slots per register block of the summing lane
constexpr int kRunsPerChunk = kChunk / kRun;
constexpr int kStageFloats = kChunk * kCols + kChunk;  // rows, then values
// the stages, then a full and an empty mbarrier per stage
constexpr int kStagedSmemBytes =
    kStagedStages * (kStageFloats * static_cast<int>(sizeof(float)) + 2 * 8);
// Each loader copies, per chunk, kIdx slots' rows: in 16-byte copies the
// (slot, quad) pairs lt + kLoaders * i, in 4-byte copies whole slots lt + kLoaders * i.
constexpr int kQuads = kCols / 4;
constexpr int kIdxVec = kChunk * kQuads / kLoaders;
constexpr int kIdxScalar = kChunk / kLoaders;
static_assert(kChunk * kQuads % kLoaders == 0 && kLoaders % kQuads == 0, "vector mapping");
static_assert(kChunk % kLoaders == 0 && kChunk % kRun == 0, "scalar mapping, runs");

// v.x, v.y, v.z or v.w; k is a constant once the caller's loop is unrolled.
__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Arrive on the mbarrier once every cp.async this thread issued before has
// landed (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kStagedThreads)
coo_matmul_T_staged(const float* __restrict__ srcT,
                    const float* __restrict__ values,
                    const int32_t* __restrict__ gather,
                    const int64_t* __restrict__ seg_ptr,
                    const float* acc,
                    const float* __restrict__ bias,
                    float* out,
                    uint8_t* __restrict__ mask,
                    int64_t batch,
                    float slope,
                    int mode) {
  constexpr int kIdx = kVec ? kIdxVec : kIdxScalar;
  extern __shared__ __align__(16) float smem[];
  const uint32_t full0 = sm90::smem_u32(smem + kStagedStages * kStageFloats);
  const uint32_t empty0 = full0 + 8 * kStagedStages;
  const int64_t s = blockIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int b_valid = batch - b0 < kCols ? static_cast<int>(batch - b0) : kCols;
  const int64_t lo = seg_ptr[s];
  const int64_t hi = seg_ptr[s + 1];
  const int n_chunks = static_cast<int>((hi - lo + kChunk - 1) / kChunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStagedStages; ++st) {
      sm90::mbar_init(full0 + 8 * st, kLoaders);  // each loader's cp.async arrive
      sm90::mbar_init(empty0 + 8 * st, 1);        // the summing warp's release
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0) {
    // The chains, lanes 0-15 one batch column each (lanes 16-31 sum copies
    // of the same columns and store nothing), a full chunk in straight-line
    // code as the note at the top says. The segment's short last chunk
    // takes a loop whose reads past its end stay inside the stage and feed
    // no FMA; lanes past the batch sum what they read and store nothing.
    const int b = lane;
    const bool summer = b < b_valid;
    float sum = 0.0f;
    if (summer && acc != nullptr) sum = acc[s * batch + b0 + b];
    const float bias_s = summer && mode != 0 ? __ldg(bias + s) : 0.0f;  // a broadcast
    const uint32_t xlane = sm90::smem_u32(smem) + ((lane / 8) * kCols + (lane % kQuads) * 4) * 4;
    auto x_of = [&](int c) { return xlane + (c % kStagedStages) * kStageFloats * 4; };
    auto v_of = [&](int c) {
      return reinterpret_cast<const float4*>(smem + (c % kStagedStages) * kStageFloats +
                                             kChunk * kCols);
    };
    uint32_t xa[kRun], xb[kRun];
    float4 va[kRun / 4], vb[kRun / 4];
    auto load = [&](uint32_t (&x)[kRun], float4 (&v)[kRun / 4], uint32_t xr, const float4* vr) {
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        v[q] = vr[q];
        tf32x3::ldmatrix_x4(xr + 4 * q * kCols * 4, x[4 * q], x[4 * q + 1], x[4 * q + 2],
                            x[4 * q + 3]);
      }
    };
    auto fma_run = [&](const uint32_t (&x)[kRun], const float4 (&v)[kRun / 4], int m) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (u < m) sum = fmaf(__uint_as_float(x[u]), component(v[u / 4], u % 4), sum);
      }
    };
    // A full run's FMAs with the next run's 16 loads written among them.
    auto fma_load = [&](const uint32_t (&x)[kRun], const float4 (&v)[kRun / 4],
                        uint32_t (&xn)[kRun], float4 (&vn)[kRun / 4], uint32_t xr,
                        const float4* vr) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        sum = fmaf(__uint_as_float(x[u]), component(v[u / 4], u % 4), sum);
        const int q = u / 4;
        if (u % 4 == 1) vn[q] = vr[q];
        if (u % 4 == 3) {
          tf32x3::ldmatrix_x4(xr + 4 * q * kCols * 4, xn[4 * q], xn[4 * q + 1], xn[4 * q + 2],
                              xn[4 * q + 3]);
        }
      }
    };
    auto wait_full = [&](int c) {
      while (!sm90::mbar_try_wait(full0 + 8 * (c % kStagedStages), (c / kStagedStages) & 1)) {
      }
    };
    auto release = [&](int c) {
      __syncwarp();  // every lane's reads of the stage are done
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * (c % kStagedStages));
    };
    if (n_chunks > 0) {
      wait_full(0);
      load(xa, va, x_of(0), v_of(0));  // run 0 of chunk c is in xa, va at each chunk's start
    }
    for (int c = 0; c < n_chunks; ++c) {
      const uint32_t xs = x_of(c);
      const float4* vs = v_of(c);
      const int64_t left = hi - lo - static_cast<int64_t>(c) * kChunk;
      if (left >= kChunk) {
#pragma unroll
        for (int r = 0; r + 2 < kRunsPerChunk; r += 2) {
          fma_load(xa, va, xb, vb, xs + (r + 1) * kRun * kCols * 4, vs + (r + 1) * kRun / 4);
          fma_load(xb, vb, xa, va, xs + (r + 2) * kRun * kCols * 4, vs + (r + 2) * kRun / 4);
        }
        constexpr int kLast = kRunsPerChunk - 1;
        fma_load(xa, va, xb, vb, xs + kLast * kRun * kCols * 4, vs + kLast * kRun / 4);
        if (c + 1 < n_chunks) {
          wait_full(c + 1);
          fma_load(xb, vb, xa, va, x_of(c + 1), v_of(c + 1));
        } else {
          fma_run(xb, vb, kRun);
        }
      } else {  // the segment's last chunk
        const int n = static_cast<int>(left);
        fma_run(xa, va, n);
        for (int j = kRun; j < n; j += kRun) {
          load(xa, va, xs + j * kCols * 4, vs + j / 4);
          fma_run(xa, va, n - j);
        }
      }
      release(c);
    }
    if (summer) store(sum, bias_s, slope, mode, out, mask, s * batch + b0 + b);
  } else if (warp != 4) {
    // The loaders: each chunk into its stage once the summing warp has freed
    // it, the values (4-byte cp.async) and the gathered srcT rows (16-byte
    // where B is a multiple of 4 and srcT is 16-byte aligned, else 4-byte);
    // the stage's full barrier completes when every loader's copies have
    // landed. A row's address needs its gather index, a global load: the
    // indices are read into registers kIdxAhead chunks ahead, so that no
    // chunk's copies wait for their latency.
    const int lt = (warp < 4 ? warp - 1 : 3) * 32 + lane;
    // the chunk-local slot of a loader's i-th copy (and its quad, 16-byte copies)
    auto slot_of = [&](int i) {
      return kVec ? lt / kQuads + (kLoaders / kQuads) * i : lt + kLoaders * i;
    };
    auto chunk_len = [&](int c) {
      const int64_t left = hi - lo - static_cast<int64_t>(c) * kChunk;
      return left < kChunk ? static_cast<int>(left) : kChunk;
    };
    int idx[kIdxAhead][kIdx];  // gather indices of chunks c to c + kIdxAhead - 1
    auto fetch_idx = [&](int c, int (&to)[kIdx]) {
      const int n = chunk_len(c);
      const int32_t* gc = gather + lo + static_cast<int64_t>(c) * kChunk;
#pragma unroll
      for (int i = 0; i < kIdx; ++i) to[i] = slot_of(i) < n ? __ldg(gc + slot_of(i)) : 0;
    };
    auto copy = [&](int c, const int (&from)[kIdx]) {
      const int st = c % kStagedStages;
      if (c >= kStagedStages) sm90::mbar_wait(empty0 + 8 * st, ((c / kStagedStages) + 1) & 1);
      float* xs = smem + st * kStageFloats;
      float* vs = xs + kChunk * kCols;
      const int n = chunk_len(c);
      const float* vg = values + lo + static_cast<int64_t>(c) * kChunk;
      for (int i = lt; i < n; i += kLoaders) tf32x3::cp_async4(vs + i, vg + i, 4);
#pragma unroll
      for (int i = 0; i < kIdx; ++i) {
        const int jj = slot_of(i);
        if (jj >= n) continue;
        const float* row = srcT + static_cast<int64_t>(from[i]) * batch + b0;
        if constexpr (kVec) {
          const int q = (lt % kQuads) * 4;
          if (q < b_valid) tf32x3::cp_async16(xs + jj * kCols + q, row + q, 16);
        } else {
          for (int b = 0; b < b_valid; ++b) tf32x3::cp_async4(xs + jj * kCols + b, row + b, 4);
        }
      }
      cp_async_arrive(full0 + 8 * st);
    };
#pragma unroll
    for (int k = 0; k < kIdxAhead; ++k) {
      if (k < n_chunks) fetch_idx(k, idx[k]);
    }
    for (int c0 = 0; c0 < n_chunks; c0 += kIdxAhead) {
#pragma unroll
      for (int k = 0; k < kIdxAhead; ++k) {
        const int c = c0 + k;
        if (c < n_chunks) {
          copy(c, idx[k]);
          if (c + kIdxAhead < n_chunks) fetch_idx(c + kIdxAhead, idx[k]);
        }
      }
    }
    tf32x3::cp_async_wait<0>();
    // The summing warp spins on its stages with no bound of its own: a bound
    // in its loop cost the chain ~3 %. One loader waits, with sm90::mbar_wait's
    // bound, for the last stage to be freed, so a stage that never lands
    // fails the launch after 4 s instead of hanging the card.
    if (lt == 0 && n_chunks > 0) {
      const int last = n_chunks - 1;
      sm90::mbar_wait(empty0 + 8 * (last % kStagedStages), (last / kStagedStages) & 1);
    }
  }
}

bool smem_set[2][64];

}  // namespace

// route: 0 = one thread per (segment, column), 1 = one staged block per
// (segment, kCols columns). Both give the same bits. epilogue: 0 = none,
// 1 = + bias, 2 = + bias then All-ReLU with slope, 3 = as 2 and the uint8
// mask of v > 0 (n_segments x batch, like out); bias (n_segments f32) may be
// null only for epilogue 0, mask only below epilogue 3.
extern "C" int coo_matmul_T_f32(const void* srcT, const void* values,
                                const void* gather, const void* seg_ptr,
                                const void* acc, const void* bias, void* out, void* mask,
                                int64_t n_segments, int64_t batch, int route,
                                float slope, int epilogue,
                                int device, void* stream) {
  if (n_segments < 0 || batch < 0 || (route != 0 && route != 1) || epilogue < 0 ||
      epilogue > 3 || (epilogue != 0 && bias == nullptr) ||
      (epilogue == 3 && mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t total = n_segments * batch;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  if (route == 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    coo_matmul_T_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(srcT), static_cast<const float*>(values),
        static_cast<const int32_t*>(gather),
        static_cast<const int64_t*>(seg_ptr), static_cast<const float*>(acc),
        static_cast<const float*>(bias), static_cast<float*>(out), static_cast<uint8_t*>(mask),
        n_segments, batch, slope, epilogue);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t slices = (batch + kCols - 1) / kCols;
  if (n_segments > 0x7fffffff || slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = batch % 4 == 0 && tf32x3::aligned16(srcT);
  auto kernel = vec ? &coo_matmul_T_staged<true> : &coo_matmul_T_staged<false>;
  err = tf32x3::allow_smem(kernel, device, kStagedSmemBytes, smem_set[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(n_segments), static_cast<unsigned int>(slices));
  kernel<<<grid, kStagedThreads, kStagedSmemBytes, st>>>(
      static_cast<const float*>(srcT), static_cast<const float*>(values),
      static_cast<const int32_t*>(gather), static_cast<const int64_t*>(seg_ptr),
      static_cast<const float*>(acc), static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<uint8_t*>(mask), batch, slope, epilogue);
  return static_cast<int>(cudaGetLastError());
}
