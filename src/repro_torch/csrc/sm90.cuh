// Hopper (sm_90a) building blocks of kernels D's and E's bf16 instances
// (bsmm_dx.cu, bsmm_dw.cu; the cluster parts E's alone; the mbarriers also
// kernel A's staged route, coo_matmul_T.cu), in inline PTX:
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     wait on a phase's parity (trapping after 4 s instead of hanging);
//   * TMA: 3-D tile loads into shared memory that complete on an mbarrier,
//     and the host's tensor maps, encoded through cuTensorMapEncodeTiled
//     taken from the driver with cudaGetDriverEntryPoint (no -lcuda);
//   * wgmma: shared-memory descriptors of bf16 operands in the 128-byte
//     swizzle that TMA writes, K-major or MN-major, m64n128k16 into f32
//     registers, fence, commit and wait;
//   * clusters: mapa, the split cluster barrier, bulk copies between the
//     CTAs' shared memories, and ClusterSum, which sums the cluster's f32
//     partials of a tile in rank order and rounds once to bf16;
//   * a ring of kStages stages, each with a "full" mbarrier (the producer's
//     arrive plus the TMA bytes) and an "empty" one (one arrive a consumer
//     warpgroup), as cuda_guide.md's producer / consumer pipeline.
//
// Layouts. A TMA box of 64 bf16 (128 bytes) by R rows lands with the 128-byte
// swizzle (the 16-byte chunk c of row r at chunk c ^ (r % 8)), in atoms of
// 8 rows x 128 bytes (1,024 bytes; stages are 1,024-byte aligned). A wgmma
// descriptor names such a tile by its start, the layout (1 = 128-byte
// swizzle), the stride byte offset (SBO) and the leading one (LBO):
//   * K-major (the contraction along the 128-byte rows; rows are M or N):
//     SBO = 1,024 (the next 8 rows), LBO unused; a k16 step moves the start
//     32 bytes along the row;
//   * MN-major (M or N along the 128-byte rows; rows are k): SBO = 1,024
//     (the next 8 k), LBO = the distance to the next 64 M or N (the next
//     box); a k16 step moves the start 16 rows (2,048 bytes).
// The accumulator of m64n128k16 for thread 32q + 4g + t of a warpgroup:
// d[4j + 2h + c] = D[16q + g + 8h][8j + 2t + c], j < 16, h, c < 2.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

// --- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Makes the inits visible to the async proxy (TMA) and the cluster.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrive, and `bytes` more transaction bytes to wait for in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// ... with acquire at cluster scope: for bytes that other CTAs stored.
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed (kCluster: and see
// what other CTAs of the cluster stored to complete it). A wait of more than
// 4 s can only be a lost arrival or a wrong byte count: it traps (the launch
// fails with an error) rather than hang the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  auto ready = [&] {
    return kCluster ? mbar_try_wait_cluster(bar, parity) : mbar_try_wait(bar, parity);
  };
  if (ready()) return;
  const uint64_t start = global_ns();
  while (!ready())
    if (global_ns() - start > 4000000000ull) __trap();
}

// --- TMA -----------------------------------------------------------------------

// The box at coordinates (c0, c1, c2) of `map` (innermost first) into shared
// memory at dst; completes `bytes` of the barrier's transaction count.
// Elements outside the tensor land as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) { return (bytes & 0x3FFFF) >> 4; }

// A descriptor of a bf16 operand in the 128-byte swizzle at shared address `start`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t start, uint32_t lbo, uint32_t sbo) {
  return desc_field(start) | (desc_field(lbo) << 16) | (desc_field(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending committed groups of this warp are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// a wgmma fence or wait (the asynchronous product writes it behind its back).
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 16) * B (16 x 128), both bf16 in shared memory;
// kTransA / kTransB: 0 K-major, 1 MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// --- clusters ------------------------------------------------------------------

// A cluster barrier in two halves: every thread of every CTA arrives, then
// waits for all the arrivals. The arrive is relaxed: what it orders is
// published by a fence of its own (fence_barrier_init) or by mbarriers.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in CTA `rank`'s shared memory of what lies at `addr` in ours.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// --- named barriers ---------------------------------------------------------------

// Barrier `id` (1..15; 0 is __syncthreads') of `threads` threads: arrive
// without waiting, or arrive and wait.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// --- the ring ------------------------------------------------------------------

// kStages stages of kStageBytes at a 1,024-byte aligned start in dynamic
// shared memory, then the mbarriers: full and empty a stage, and recv, on
// which a CTA of a cluster waits for the others' shares of the sum
// (ClusterSum). The sum's area is the ring itself once the ring is free, or
// lies after the barriers (kAreaOffset). kSmem is what to ask for without it.
template <int kStages, int kStageBytes>
struct Ring {
  static constexpr int kBarBytes = 256;
  static constexpr int kSmem = kStages * kStageBytes + kBarBytes + 1024;
  static_assert(2 * kStages * 8 + 8 <= kBarBytes, "the barriers fit");
  uint32_t base;
  unsigned char* ptr;

  __device__ explicit Ring(unsigned char* smem) {
    const uint32_t raw = smem_u32(smem);
    base = (raw + 1023u) & ~1023u;
    ptr = smem + (base - raw);
  }
  __device__ uint32_t stage(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t full(int s) const { return base + kStages * kStageBytes + 8 * s; }
  __device__ uint32_t empty(int s) const { return full(kStages + s); }
  __device__ uint32_t recv_bar() const { return full(2 * kStages); }
  // a separate area's offset from base
  static constexpr int kAreaOffset = kStages * kStageBytes + kBarBytes;

  // One thread: full barriers wait for the producer's arrive (and the bytes),
  // empty ones for one arrive from each of `consumers` warpgroups, recv for
  // this thread's arrive and `recv_bytes` of bulk copies from the cluster.
  __device__ void init(int consumers, uint32_t recv_bytes) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    mbar_init(recv_bar(), 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(recv_bar(), recv_bytes);
  }
};

// --- the epilogue ----------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warpgroup's m64n128 accumulator as 16 runs of 4 columns a thread: each
// lane pair (t, t ^ 1) swaps a pair of values, so that an even lane holds
// row 16q + g, columns 8j + 2t .. + 3 and an odd lane row 16q + g + 8,
// columns 8j + 2t - 2 .. + 1, for j = 0..15: quad_row, quad_col + 8j.
__device__ __forceinline__ int quad_row(int tid_in_wg) {
  const int lane = tid_in_wg % 32;
  return 16 * (tid_in_wg / 32) + lane / 4 + (lane & 1) * 8;
}
__device__ __forceinline__ int quad_col(int tid_in_wg) {
  const int t = tid_in_wg % 4;
  return 2 * t - (t & 1) * 2;
}

// f(j, value) for j = 0..15; every lane of the warp takes part.
template <typename F>
__device__ __forceinline__ void for_each_quad(const float (&d)[64], int tid_in_wg, F f) {
  const bool odd = tid_in_wg & 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float s0 = odd ? d[4 * j] : d[4 * j + 2], s1 = odd ? d[4 * j + 1] : d[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    f(j, odd ? make_float4(r0, r1, d[4 * j + 2], d[4 * j + 3])
             : make_float4(d[4 * j], d[4 * j + 1], r0, r1));
  }
}


// A warpgroup's accumulator rows row0.. rounded once to bf16 into `stage`
// (row pitch kPitch bf16; 136 spreads a warp's 8-byte stores over the banks).
template <int kPitch>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* stage, int row0, int tid_in_wg,
                                           const float (&d)[64]) {
  __nv_bfloat16* at = stage + (row0 + quad_row(tid_in_wg)) * kPitch + quad_col(tid_in_wg);
  for_each_quad(d, tid_in_wg, [&](int j, float4 v) {
    *reinterpret_cast<uint2*>(at + 8 * j) =
        make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  });
}

// Rows [0, rows) of a bf16 tile staged at `stage` (row pitch kPitch),
// columns below cols (a multiple of 8), to dst (row stride dst_stride): 16
// bytes a thread, a warp on two whole rows of 128 columns.
template <int kPitch>
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* stage, int rows, int cols,
                                          __nv_bfloat16* dst, int64_t dst_stride, int tid,
                                          int threads) {
  for (int idx = tid; idx < rows * 16; idx += threads) {
    const int r = idx / 16, c = idx % 16 * 8;
    if (c < cols)
      *reinterpret_cast<uint4*>(dst + r * dst_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + c);
  }
}

// Generic-proxy shared memory writes visible to the async proxy (bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from this CTA's shared memory at src to a CTA of
// the cluster at dst, completing as many bytes of that CTA's mbarrier at bar.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// The cluster's sum of its CTAs' f32 partials of one tile (rows x 128
// columns, the consumer warpgroups' accumulators), rounded once to bf16.
// Rows [0, rows) are dealt to the ranks in contiguous shares, rank q owning
// [rows*q/size, rows*(q+1)/size). Each CTA
//   1. stages its partial in shared memory (store_partial, row pitch kPitch
//      floats);
//   2. sends each other rank its share by one bulk copy (send) into that
//      rank's receive slot for this sender: the other senders' slots, in
//      rank order, ceil(rows / size) rows each, at the same address in
//      every CTA;
//   3. once its recv barrier has all (size - 1) x its share's bytes, adds the
//      ranks' values of each of its rows in rank order 0, 1, ..., size - 1
//      and rounds once, spread over all threads, straight to the output
//      (sum_store).
// A fixed order: the same bits on every launch. Each partial row crosses
// the cluster once.
template <int kPitch, int kMaxRanks>
struct ClusterSum {
  int rows, size, rank, share, first, own;

  __device__ ClusterSum(int rows_, int size_, int rank_)
      : rows(rows_), size(size_), rank(rank_), share((rows_ + size_ - 1) / size_),
        first(rows_ * rank_ / size_), own(rows_ * (rank_ + 1) / size_ - rows_ * rank_ / size_) {}
  __device__ int lo(int q) const { return rows * q / size; }
  __device__ int hi(int q) const { return rows * (q + 1) / size; }
  // sender q's receive slot in this CTA, in rows
  __device__ int slot(int q) const { return (q < rank ? q : q - 1) * share; }
  // the bytes this CTA receives: its share, from each other rank
  __device__ uint32_t recv_bytes() const {
    return static_cast<uint32_t>((size - 1) * own * kPitch * 4);
  }
  // bytes of the receive slots, at most (rows at most 128)
  static __host__ __device__ constexpr int recv_area_bytes(int size) {
    return (size - 1) * ((128 + size - 1) / size) * kPitch * 4;
  }

  // 2. One thread, once every staging thread has fenced its writes for the
  // async proxy and every CTA's receive slots are free and its barrier ready.
  __device__ void send(uint32_t stage, uint32_t recv, uint32_t bar) const {
    for (int q = 0; q < size; ++q) {
      if (q == rank || hi(q) == lo(q)) continue;
      const int at = (rank < q ? rank : rank - 1) * share;  // this sender's slot at q
      bulk_copy_cluster(mapa(recv + static_cast<uint32_t>(at * kPitch * 4), q),
                        stage + static_cast<uint32_t>(lo(q) * kPitch * 4),
                        static_cast<uint32_t>((hi(q) - lo(q)) * kPitch * 4), mapa(bar, q));
    }
  }

  // 3. After the recv barrier, over all threads: this rank's rows, its own
  // values from the full staging `part`, to dst (the tile's row 0, row
  // stride dst_stride), columns below cols, 8 bytes a thread.
  __device__ void sum_store(const float* part, const float* recv, int cols, __nv_bfloat16* dst,
                            int64_t dst_stride, int tid, int threads) const {
    for (int idx = tid; idx < own * 32; idx += threads) {
      const int r = idx / 32, c = idx % 32 * 4;
      if (c >= cols) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q >= size) break;
        const float4 u = *reinterpret_cast<const float4*>(
            q == rank ? part + (first + r) * kPitch + c : recv + (slot(q) + r) * kPitch + c);
        if (q == 0) {
          s = u;
        } else {
          s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
        }
      }
      *reinterpret_cast<uint2*>(dst + (first + r) * dst_stride + c) =
          make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
    }
  }
};

// A warpgroup's m64n128 accumulator into an f32 tile in shared memory at
// rows row0.. (row pitch kPitch floats; 136 puts a warp's 8-byte stores on
// distinct banks in each half-warp).
template <int kPitch>
__device__ __forceinline__ void store_partial(float* part, int row0, int tid_in_wg,
                                              const float (&d)[64]) {
  const int q = tid_in_wg / 32, g = (tid_in_wg % 32) / 4, t = tid_in_wg % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (row0 + 16 * q + g + 8 * h) * kPitch + 8 * j + 2 * t) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// Exact +0 in rows [0, rows), columns [0, cols) (a multiple of 8).
__device__ __forceinline__ void store_zero_rows(__nv_bfloat16* dst, int64_t dst_stride, int rows,
                                                int cols, int tid, int threads) {
  const int groups = cols / 8;
  for (int idx = tid; idx < rows * groups; idx += threads)
    *reinterpret_cast<uint4*>(dst + (idx / groups) * dst_stride + (idx % groups) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// --- host ------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, once.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor of dims (d0, d1, d2), innermost first, with row strides s1
// and s2 in elements, read in boxes of (b0, b1, b2) into the 128-byte
// swizzle; out-of-bounds elements read as zero.
inline cudaError_t encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                                  uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0,
                                  uint32_t b1, uint32_t b2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1 * 2, s2 * 2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A launch in clusters of `cluster` CTAs along x (grid.x a multiple of it).
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int cluster, int threads,
                                   int smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

// How many clusters of `cluster` CTAs the card holds at once.
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...), int cluster, int threads,
                                       int smem, int* out) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * 64);
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace sm90
