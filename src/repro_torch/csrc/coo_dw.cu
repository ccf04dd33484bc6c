// Kernel F: the element-sparse (COO) weight gradient, with the backward of
// kernel A's training epilogue (bias, then All-ReLU) in the same pass.
//
//   dz[n, b] = mask[n, b] ? dy[n, b] : slope * dy[n, b]     (no mask: dy)
//   dbias[n] = sum_b dz[n, b]
//   dv[j]    = sum_b xT[rows[j], b] * dz[cols[j], b]
//
// xT is the layer's input (in_dim, B) and dy the gradient of its output
// (out_dim, B), in the (features, batch) layout the element path keeps.
// Replaces src/repro/core/sparsity.py::coo_dw, an XLA lax.scan over chunks
// of slots whose gathered (chunk, B) slabs are multiplied and reduced over
// the batch (not a Pallas kernel), which src/repro/kernels/ops.py::
// _espmm_core_bwd runs as the element product's dW; and what XLA derives for
// the backward of src/repro/core/all_relu.py::all_relu(z + b): jax.grad of
// jnp.where(x > 0, x, slope * x) gives dy where x > 0 and slope * dy where
// not (x == 0 included). mask is the branch kernel A's epilogue 3 recorded
// (v > 0). dv is in the canonical (col, row) slot order, so it lines up
// with values.
//
// Epilogue modes, chosen by which pointers are given:
//
//   0  no bias (espmm_custom):           dz = dy, not written; no dbias
//   1  bias alone (the output layer):    dz = dy, not written; dbias
//   2  bias + All-ReLU (hidden layers):  dz written; dbias
//
// With no run plan (runs null) the kernel does the epilogue alone, one
// empty run per row: kernel G's standalone pass (all_relu_bwd).
//
// The work unit. The wrapper (core/sparsity.py::dw_runs, made once per
// topology) cuts each column's slot range, in the canonical order, into
// runs of at most 32 consecutive slots, and gives every column one empty
// run besides: runs[r] = (column, first slot, slots). One warp takes one
// run. A plan made on the device (dw_runs_device, after SET evolution on
// the card) has a fixed number of slot runs, the ones past its slot runs
// padding with column -1: their warps return at once and write nothing.
// A run with slots:
//
//   * makes its column's dz row from dy, the mask and the slope (one
//     rounded multiply, __fmul_rn) into registers, for B <= 512, and keeps
//     it for the whole run: dz is read once a run. A larger B recomputes
//     each element from dy and the mask, read again through L1 (slower, the
//     same bits);
//   * loads its rows[j] with one coalesced load, lane l the run's slot l,
//     and hands each to the warp with __shfl_sync;
//   * loads the x rows of 8 slots with no branch between the loads, so all
//     8 are in flight together, then sums them: x is read once a slot.
//     Slots past the run's end read its last slot's row again (an L1 hit)
//     and their sums are never stored;
//   * meets its 32 slots' partial sums in one transposed tree (below), and
//     lane l stores slot l's dv: one coalesced store a run.
//
// A column's empty run writes its dz row (mode 2) and dbias, whether or not
// the column has slots (importance pruning empties columns). The empty runs
// come after every slot run, so this short work fills the SMs while the
// slot runs drain, instead of lengthening one slot run per column. The slot
// runs are ordered by their first slot's row: each column's rows ascend,
// so warps that start together walk the same rows of x and find more of
// them in L1 and L2 (the dense output layer's 10 columns share every row).
// Without an epilogue the wrapper launches the slot runs alone.
//
// The sums. Each keeps, on purpose, the order of the one-warp-a-slot kernel
// F and the one-warp-a-row kernel G this pass replaced, so the card's
// training trajectory does not move by a bit:
//
//   * dv: lane l sums its batch columns in one f32 chain (fmaf) in column
//     order, then the 32 partials meet in the xor-shuffle tree 16, 8, 4, 2,
//     1 (__fadd_rn). Where B is a multiple of 4 and xT and dy are both
//     16-byte aligned, lane l reads the float4s at b = 4l + 128k
//     (k = 0, 1, ...), its chain running k by k, x/y/z/w within each; else
//     lane l reads b = l + 32k. The two differ in the last bits; which one
//     runs is a pure function of B and the two base addresses.
//   * The tree is run for all 32 slots of a run at once, transposed: at the
//     level of offset o each lane keeps the half of its slots whose bit o
//     matches its own lane's, sends the other half to lane l ^ o, and adds
//     what it receives to what it keeps. Each add is the one the per-slot
//     tree makes at that level (own partial + lane l ^ o's, for the same
//     slot), so the bits are the same, and lane l ends with slot l's sum.
//     It costs 31 shuffles and 31 adds a run where the per-slot tree took
//     5 of each a slot.
//   * dbias: lane l sums dz[b] at b = l + 32k in order (__fadd_rn), then
//     the same xor tree; lane 0 stores.
//
// No atomics: the same inputs give the same bits on every launch.
//
// What bounds it on an H100: bytes. Counted once, the compulsory bytes at
// the CIFAR-10 SET-MLP's four layers at batch 128 are ~20 MB (xT, dy, the
// mask, dz, the indices, dv), ~6 us at 3.35 TB/s, against ~98 MFLOP, 1.5 us
// at 67 TFLOP/s. The gathers read each slot's x row through L2 (512 B a
// slot at B = 128, ~195 MB a step), and every layer's xT fits in L2; what
// the design attacks is latency: with 8 rows in flight per warp, and many
// warps, the L2 round trips overlap instead of following each other slot by
// slot, and the rate of those gathers through L2 is what is left.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;  // runs per block
constexpr int kRun = 32;               // slots per run at most: one lane each
constexpr int kGroup = 8;              // x rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// One lane's piece of a row at one step k of its walk over the batch: a
// float4 at b = 4 * lane + 128k, or a float at b = lane + 32k.
template <bool kVec>
struct Lane;

template <>
struct Lane<true> {
  using T = float4;
  static constexpr int kStride = 128;
  __device__ static int64_t start(int lane) { return 4 * lane; }
  __device__ static float4 load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static float fma(float4 x, float4 d, float p) {
    p = fmaf(x.x, d.x, p);
    p = fmaf(x.y, d.y, p);
    p = fmaf(x.z, d.z, p);
    return fmaf(x.w, d.w, p);
  }
};

template <>
struct Lane<false> {
  using T = float;
  static constexpr int kStride = 32;
  __device__ static int64_t start(int lane) { return lane; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float zero() { return 0.0f; }
  __device__ static float fma(float x, float d, float p) { return fmaf(x, d, p); }
};

// dz of one element: the rounded multiply on the slope branch (mask 0).
__device__ __forceinline__ float dz_of(float g, const uint8_t* m, float slope) {
  return m != nullptr && __ldg(m) == 0 ? __fmul_rn(slope, g) : g;
}

__device__ __forceinline__ float4 dz_of(float4 g, const uint8_t* m, float slope) {
  return make_float4(dz_of(g.x, m, slope), dz_of(g.y, m == nullptr ? m : m + 1, slope),
                     dz_of(g.z, m == nullptr ? m : m + 2, slope),
                     dz_of(g.w, m == nullptr ? m : m + 3, slope));
}

// One level of the transposed tree, offset kO: p[i + kO] and p[i] (i < kO)
// hold two slots that differ in bit kO; this lane keeps the one whose bit kO
// is its own and adds lane ^ kO's partial of it. After the level p[i]
// holds the slot whose low bits are i and whose bits kO and up are this
// lane's. kO is a template argument so that every index into p is known
// at compile time and p stays in registers.
template <int kO>
__device__ __forceinline__ void tree_level(float (&p)[kRun], int lane) {
  const bool upper = lane & kO;
#pragma unroll
  for (int i = 0; i < kO; ++i) {
    const float send = upper ? p[i] : p[i + kO];
    const float keep = upper ? p[i + kO] : p[i];
    p[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kO));
  }
}

// kK: the lane's steps over the batch held in registers (the dz row), a
// power of two covering B; 0 for B > 512, where each dz element is
// recomputed from dy and the mask at each use.
template <bool kVec, int kK>
__global__ void __launch_bounds__(kThreads)
coo_dw_kernel(const float* __restrict__ xT,
              const float* __restrict__ dy,
              const uint8_t* __restrict__ mask,
              float slope,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ runs,
              float* __restrict__ dv,
              float* __restrict__ dz,
              float* __restrict__ dbias,
              int64_t n_runs,
              int64_t batch) {
  using L = Lane<kVec>;
  using T = typename L::T;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= n_runs) return;  // the whole warp: r is the warp's
  const int lane = threadIdx.x % 32;
  int64_t col = r;
  int lo = 0, n = 0;
  if (runs != nullptr) {
    col = __ldg(runs + 3 * r);
    lo = __ldg(runs + 3 * r + 1);
    n = __ldg(runs + 3 * r + 2);
  }
  if (col < 0) return;  // a padding run (a plan made on the device): nothing to do
  const float* dy_row = dy + col * batch;
  const uint8_t* m_row = mask == nullptr ? nullptr : mask + col * batch;
  const int64_t b0 = L::start(lane);

  if (n > 0) {
    T d[kK > 0 ? kK : 1];
    if constexpr (kK > 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int64_t b = b0 + k * L::kStride;
        d[k] = b < batch ? dz_of(L::load(dy_row + b), m_row == nullptr ? m_row : m_row + b, slope)
                         : L::zero();
      }
    }
    const int my_row = __ldg(rows + lo + min(lane, n - 1));
    float p[kRun];
#pragma unroll
    for (int s = 0; s < kRun; ++s) p[s] = 0.0f;
#pragma unroll
    for (int g = 0; g < kRun; g += kGroup) {
      if (g < n) {  // the whole warp
#pragma unroll
        for (int s = g; s < g + kGroup; ++s) {
          const float* x = xT + static_cast<int64_t>(__shfl_sync(kFull, my_row, s)) * batch;
          float acc = 0.0f;
          if constexpr (kK > 0) {
#pragma unroll
            for (int k = 0; k < kK; ++k) {
              const int64_t b = b0 + k * L::kStride;
              if (b < batch) acc = L::fma(L::load(x + b), d[k], acc);
            }
          } else {
            for (int64_t b = b0; b < batch; b += L::kStride) {
              acc = L::fma(L::load(x + b),
                           dz_of(L::load(dy_row + b), m_row == nullptr ? m_row : m_row + b, slope),
                           acc);
            }
          }
          p[s] = acc;
        }
      }
    }
    tree_level<16>(p, lane);
    tree_level<8>(p, lane);
    tree_level<4>(p, lane);
    tree_level<2>(p, lane);
    tree_level<1>(p, lane);
    if (lane < n) dv[lo + lane] = p[0];
  } else if (dbias != nullptr) {  // an empty run: its column's epilogue
    float acc = 0.0f;
    for (int64_t b = lane; b < batch; b += 32) {
      const float g = dz_of(__ldg(dy_row + b), m_row == nullptr ? m_row : m_row + b, slope);
      if (dz != nullptr) dz[col * batch + b] = g;
      acc = __fadd_rn(acc, g);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
    if (lane == 0) dbias[col] = acc;
  }
}

using Kernel = void (*)(const float*, const float*, const uint8_t*, float, const int32_t*,
                        const int32_t*, float*, float*, float*, int64_t, int64_t);

// The instance for B: the fewest register steps that cover it.
Kernel pick(bool vec, int64_t batch) {
  const int64_t steps = vec ? (batch + 127) / 128 : (batch + 31) / 32;
  if (vec) {
    if (steps <= 1) return &coo_dw_kernel<true, 1>;
    if (steps <= 2) return &coo_dw_kernel<true, 2>;
    if (steps <= 4) return &coo_dw_kernel<true, 4>;
    return &coo_dw_kernel<true, 0>;
  }
  if (steps <= 1) return &coo_dw_kernel<false, 1>;
  if (steps <= 2) return &coo_dw_kernel<false, 2>;
  if (steps <= 4) return &coo_dw_kernel<false, 4>;
  if (steps <= 8) return &coo_dw_kernel<false, 8>;
  if (steps <= 16) return &coo_dw_kernel<false, 16>;
  return &coo_dw_kernel<false, 0>;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// xT (in_dim x batch), dy and dz (n_cols x batch f32), mask (n_cols x batch
// uint8, or null: dz = dy), dbias (n_cols f32, or null: no epilogue), rows
// (nnz int32, inside xT's first dimension: the wrapper checks), dv (nnz
// f32), and the run plan: runs (n_runs x 3 int32: column in [0, n_cols)
// or -1 for a padding run, first slot, 0 to 32 slots inside one column's
// range). With runs null, n_runs = n_cols empty runs, run r on column r,
// and xT, rows and dv are not read.
extern "C" int coo_dw_f32(const void* xT, const void* dy, const void* mask, float slope,
                          const void* rows, const void* runs, void* dv, void* dz, void* dbias,
                          int64_t n_runs, int64_t batch, int device, void* stream) {
  if (n_runs < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_runs == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n_runs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = batch % 4 == 0 && aligned16(xT) && aligned16(dy);
  pick(vec, batch)<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xT), static_cast<const float*>(dy),
      static_cast<const uint8_t*>(mask), slope, static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(runs), static_cast<float*>(dv), static_cast<float*>(dz),
      static_cast<float*>(dbias), n_runs, batch);
  return static_cast<int>(cudaGetLastError());
}
