// Min/max semiring SpMV over one CSR array triple, for Hopper (sm_90a):
//
//     y[r] = REDUCE over e in [offsets[r], offsets[r+1]) of COMBINE(x[indices[e]], w[e])
//
// REDUCE is min or max.  COMBINE is "add" (x + w, the SSSP relaxation),
// "left" (x alone: BFS frontier masks, WCC labels), "mul" (x * w) or
// "right" (w alone; x is not read).  In fp32 every edge value is clipped to
// [-1e30, 1e30] before the reduction, and a row with no edges writes the
// identity, +1e30 for min and -1e30 for max.  The int32 instantiation
// (combine "left" only) carries vertex ids and 0/1 masks with no f32 bound;
// its identity is INT32_MAX for min and INT32_MIN for max.
//
// NaN (fp32): a NaN edge value, from x or from the weight, makes the row's
// result NaN (the canonical 0x7fffffff), for min and for max, as the plain
// version (clamp, then scatter_reduce_) and the reference's XLA route
// (jax.ops.segment_min/max) do.  The clip and the reduction are PTX
// min.NaN / max.NaN (sm_80+), which return NaN when either operand is one
// and order -0 below +0, so a row of zeros of both signs gives -0 for min
// and +0 for max.  The TPU kernel reads a NaN weight as a padding lane and
// skips the edge (spmv_onehot.py:503); the port does not copy that.
//
// Replaces the min/max path of the TPU kernel
// cugraph_tpu/kernels/spmv_onehot.py:565-592 (_kernel with reduce="min"/
// "max"; clip at :576, identity at :415, SEMIRING_BIG at :58).  That kernel
// reduces each dst-sorted lane run with a shifted scan and scatters it with
// one-hot MXU selections, because the TPU has no vector gather or scatter;
// this kernel reads the CSR directly and keeps none of that machinery.
//
// Bound: bytes.  Every edge costs 4 B for "left" and "right" (the int32
// index, or the fp32 weight) and 8 B for "add" and "mul", every vertex 4 B
// each of offsets, x and y, against one or two operations per edge: 0.0773
// ms for "add" on the undirected RMAT-20 CSC (31.4 M edges) at 3.35 TB/s.
// The x gather is random but x fits in the 50 MB L2 at RMAT-20.
//
// Design: that of the sum SpMV spmv_csr.cu, two passes launched here on the
// caller's stream (csr_spans.cuh):
//   - the span pass: one warp per span of `span` edges reduces the part of
//     each heavy row (degree > span) that lies in its span; its lanes
//     stride over the edges, each keeps a partial, and a butterfly of warp
//     shuffles combines the 32; lane 0 writes the row's slot of the span;
//   - the row pass: a group of kGroup = 8 lanes per row, 4 rows per warp.
//     A light row's lanes stride over its edges and a butterfly over the
//     group combines their partials; the first lane of a heavy row's group
//     reduces its slots in span order; a row with no edges writes the
//     identity.
// The slots have x's type: fp32, or int32 for the int32 arm.  Min and max
// are exact and order-free, so there are no atomics and two launches give
// bit-identical output.  The wrapper allocates the slots, 2 * ceil(m /
// span) of them, and passes the span (kernels/semiring.py).  n = 0
// launches nothing.
//
// Before the split one warp walked each row: the undirected Graph500
// RMAT-20 CSC's heaviest row (64,633 edges, 2,020 strides of 32) set the
// tail, and most rows, of a few edges, left most of a warp's lanes idle.
//
// Chosen on the card: 8 lanes per light row and T = 1024, K1's span
// (kernels/semiring.py SPMV_SEMIRING_SPAN).  chip_smoke.py's sweep over
// the undirected RMAT-20 CSC (mean degree 48.6), which carries 101 of
// K2's 107 launches on the paths (NVIDIA H100 80GB HBM3, 700 W; ms per
// call at T = 256, 512, 1024, 2048; one run while it also timed 4 lanes,
// since removed):
//   (min, add)      4 lanes  0.2267 0.2122 0.1985 0.2244
//                   8 lanes  0.2112 0.2094 0.1964 0.1966
//   (max, left) i32 4 lanes  0.2068 0.1722 0.1510 0.1597
//                   8 lanes  0.1888 0.1709 0.1552 0.1490
// Weighted by the paths' launches (74 and 27), 8 lanes at T = 1024 and
// 2048 lie within 1 % of each other; 1024 is kept, since a longer span
// leaves rows of up to T edges to one group, which cost K1 with 8 lanes
// 15 % on the directed CSC (spmv_csr.cu's sweep), where WCC's K2 launches
// also run.  The heaviest row no
// longer sets the time: (min, add) takes 0.1965 ms with it and 0.1962 ms
// with it emptied (0.5097 ms before the split).

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "csr_spans.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr int kGroup = 8;  // lanes per light row
constexpr float kBig = 1e30f;

enum Reduce { kMin = 0, kMax = 1 };
enum Combine { kAdd = 0, kLeft = 1, kMul = 2, kRight = 3 };

// min and max that give NaN when either operand is NaN, -0 below +0
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename T, int R>
struct Op;

template <>
struct Op<float, kMin> {
  static __device__ __forceinline__ float identity() { return kBig; }
  static __device__ __forceinline__ float apply(float a, float b) { return min_nan(a, b); }
};

template <>
struct Op<float, kMax> {
  static __device__ __forceinline__ float identity() { return -kBig; }
  static __device__ __forceinline__ float apply(float a, float b) { return max_nan(a, b); }
};

template <>
struct Op<int32_t, kMin> {
  static __device__ __forceinline__ int32_t identity() { return INT_MAX; }
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) { return min(a, b); }
};

template <>
struct Op<int32_t, kMax> {
  static __device__ __forceinline__ int32_t identity() { return INT_MIN; }
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) { return max(a, b); }
};

// The edge value, clipped in fp32 (:576); the _rn intrinsics keep nvcc
// from contracting anything, so each operation rounds once, as the plain
// version's do.
template <typename T, int C>
__device__ __forceinline__ T edge_value(const int32_t* __restrict__ indices,
                                        const float* __restrict__ weights,
                                        const T* __restrict__ x, int64_t e) {
  T v;
  if constexpr (C == kRight) {
    v = __ldg(weights + e);
  } else {
    const T xv = __ldg(x + __ldg(indices + e));
    if constexpr (C == kLeft) {
      v = xv;
    } else if constexpr (C == kAdd) {
      v = __fadd_rn(xv, __ldg(weights + e));
    } else {
      v = __fmul_rn(xv, __ldg(weights + e));
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    v = min_nan(max_nan(v, -kBig), kBig);
  }
  return v;
}

// REDUCE of the edge values of [begin, end), strided over `stride` lanes
// from `lane`
template <typename T, int R, int C>
__device__ __forceinline__ T strided_reduce(const int32_t* __restrict__ indices,
                                            const float* __restrict__ weights,
                                            const T* __restrict__ x,
                                            int64_t begin, int64_t end,
                                            int lane, int stride) {
  T acc = Op<T, R>::identity();
#pragma unroll 4
  for (int64_t e = begin + lane; e < end; e += stride) {
    acc = Op<T, R>::apply(acc, edge_value<T, C>(indices, weights, x, e));
  }
  return acc;
}

// a butterfly over aligned groups of `width` lanes: every lane of a group
// ends with the group's REDUCE
template <typename T, int R, int kWidth>
__device__ __forceinline__ T group_reduce(T acc) {
#pragma unroll
  for (int offset = kWidth / 2; offset > 0; offset /= 2) {
    acc = Op<T, R>::apply(acc, __shfl_xor_sync(kFull, acc, offset));
  }
  return acc;
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_semiring_span_pass(const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ indices,
                        const float* __restrict__ weights,
                        const T* __restrict__ x, T* __restrict__ partials,
                        int64_t n, int64_t m, int64_t span) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (s >= (m + span - 1) / span) return;  // whole warps exit together
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, n, m, span, s, piece);
  for (int slot = 0; slot < 2; ++slot) {
    if (piece[slot].begin == piece[slot].end) continue;  // warp-uniform
    const T acc = group_reduce<T, R, kWarp>(strided_reduce<T, R, C>(
        indices, weights, x, piece[slot].begin, piece[slot].end, lane, kWarp));
    if (lane == 0) partials[2 * s + slot] = acc;
  }
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_semiring_row_pass(const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ indices,
                       const float* __restrict__ weights,
                       const T* __restrict__ x, const T* __restrict__ partials,
                       T* __restrict__ y, int64_t n, int64_t span) {
  constexpr int kRowsPerWarp = kWarp / kGroup;
  const int sub = threadIdx.x % kGroup;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp * kRowsPerWarp >= n) return;  // whole warps exit together
  // the last warp's groups past n keep to the shuffles with no edges
  const int64_t row = warp * kRowsPerWarp + threadIdx.x % kWarp / kGroup;
  const bool valid = row < n;
  const int64_t begin = valid ? __ldg(offsets + row) : 0;
  const int64_t end = valid ? __ldg(offsets + row + 1) : 0;
  T acc = Op<T, R>::identity();
  if (end - begin > span) {
    if (sub == 0) {
      for (int64_t s = begin / span; s <= (end - 1) / span; ++s) {
        acc = Op<T, R>::apply(acc, partials[2 * s + csr_spans::slot_of(begin, span, s)]);
      }
    }
  } else {
    acc = strided_reduce<T, R, C>(indices, weights, x, begin, end, sub, kGroup);
  }
  acc = group_reduce<T, R, kGroup>(acc);
  if (valid && sub == 0) y[row] = acc;
}

template <typename T, int R, int C>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, void* partials,
                   int64_t n, int64_t m, int64_t span, cudaStream_t stream) {
  const int64_t span_blocks =
      ((m + span - 1) / span + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t rows_per_block = kThreadsPerBlock / kGroup;
  const int64_t row_blocks = (n + rows_per_block - 1) / rows_per_block;
  if (span_blocks > INT_MAX || row_blocks > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* xv = static_cast<const T*>(x);
  auto* part = static_cast<T*>(partials);
  if (span_blocks > 0) {
    spmv_semiring_span_pass<T, R, C><<<static_cast<unsigned>(span_blocks),
                                       kThreadsPerBlock, 0, stream>>>(
        off, idx, w, xv, part, n, m, span);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmv_semiring_row_pass<T, R, C><<<static_cast<unsigned>(row_blocks),
                                    kThreadsPerBlock, 0, stream>>>(
      off, idx, w, xv, part, static_cast<T*>(y), n, span);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_f32(int combine, const void* offsets, const void* indices,
                       const void* weights, const void* x, void* y,
                       void* partials, int64_t n, int64_t m, int64_t span,
                       cudaStream_t s) {
  switch (combine) {
    case kAdd:
      return launch<float, R, kAdd>(offsets, indices, weights, x, y, partials,
                                    n, m, span, s);
    case kLeft:
      return launch<float, R, kLeft>(offsets, indices, weights, x, y,
                                     partials, n, m, span, s);
    case kMul:
      return launch<float, R, kMul>(offsets, indices, weights, x, y, partials,
                                    n, m, span, s);
    case kRight:
      return launch<float, R, kRight>(offsets, indices, weights, x, y,
                                      partials, n, m, span, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// reduce: 0 = min, 1 = max.  combine: 0 = add, 1 = left, 2 = mul, 3 = right.
// is_int32: x, y and partials are int32 (combine "left" only), else fp32.
// partials holds 2 * ceil(m / span) elements of scratch (the heavy rows'
// slots).  Pointers that the mode does not read (weights for "left", x for
// "right"), and those of empty arrays, may be null.  Launches both passes
// on `stream`, without a sync, and returns cudaGetLastError() as an int (0
// on success).
extern "C" int spmv_semiring(const void* offsets, const void* indices,
                             const void* weights, const void* x, void* y,
                             void* partials, int64_t n, int64_t m, int reduce,
                             int combine, int is_int32, int64_t span,
                             void* stream) {
  if ((reduce != kMin && reduce != kMax) || combine < kAdd ||
      combine > kRight || (is_int32 && combine != kLeft) || n < 0 || m < 0 ||
      span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_int32) {
    err = reduce == kMin
        ? launch<int32_t, kMin, kLeft>(offsets, indices, weights, x, y,
                                       partials, n, m, span, s)
        : launch<int32_t, kMax, kLeft>(offsets, indices, weights, x, y,
                                       partials, n, m, span, s);
  } else {
    err = reduce == kMin
        ? launch_f32<kMin>(combine, offsets, indices, weights, x, y, partials,
                           n, m, span, s)
        : launch_f32<kMax>(combine, offsets, indices, weights, x, y, partials,
                           n, m, span, s);
  }
  return static_cast<int>(err);
}
