// Min/max semiring SpMM over one CSR array triple, for Hopper (sm_90a):
//
//     Y[r, :] = REDUCE over e in [offsets[r], offsets[r+1]) of COMBINE(w[e], X[indices[e], :])
//
// X and Y are fp32 [n, F], row-major, any F >= 1.  REDUCE is min or max.
// COMBINE is "add" (x + w: batched Bellman-Ford, the weighted OD panels),
// "left" (x alone; the weight array is not read) or "mul" (x * w).  Every
// edge value is clipped to [-1e30, 1e30] before the reduction, and a row
// with no edges writes the identity, +1e30 for min and -1e30 for max.
//
// NaN: a NaN edge value, from X or from the weight, makes the row's result
// NaN (the canonical 0x7fffffff), for min and for max, as the plain version
// (clamp, then scatter_reduce_) and the reference's XLA route
// (jax.ops.segment_min/max) do.  The clip and the reduction are PTX
// min.NaN / max.NaN (sm_80+), which return NaN when either operand is one
// and order -0 below +0, so a row of zeros of both signs gives -0 for min
// and +0 for max.  The TPU kernel reads a NaN weight as a padding lane and
// skips the edge (spmm_onehot.py:368,379); the port does not copy that.
//
// Replaces the min/max path of the TPU kernel
// cugraph_tpu/kernels/spmm_onehot.py:365-416 (_kernel with reduce="min"/
// "max"; combines :386-397, clip :398, identity :281).  That kernel moves
// values between lanes and sublanes with identity matmuls, reduces each
// dst-sorted run with a shifted scan (:400-405) and scatters the run heads
// with one-hot MXU selections, because the TPU has no vector gather or
// scatter; this kernel reads the CSR directly and keeps none of that.
//
// Bound: bytes.  Counting each input once and each output once, a launch
// moves 4 (n + 1) + 4 m [+ 4 m weights] + 8 n F bytes (0.2733 ms for "add"
// at F = 128 on the undirected RMAT-20 CSC, 31.4 M edges, at 3.35 TB/s).
// The gathers read a 4 F B row of X per edge, 16 GB at F = 128 there,
// against a 331 MB X that does not fit the 50 MB L2, so no gather kernel
// comes near the byte bound.
//
// Design: that of the sum SpMM spmm_csr.cu, two passes launched here on
// the caller's stream, so that no row is walked by one warp, however heavy
// (csr_spans.cuh):
//   - the span pass: one warp per (span of `span` edges, 128-feature chunk)
//     reduces the part of each heavy row (degree > span) that lies in its
//     span into the row's fp32 slot of that span; light rows are skipped;
//   - the row pass: one warp per (row, chunk).  A light row reduces its
//     edges; a heavy row reduces its slots in span order; a row with no
//     edges writes the identity.
// A warp gathers its rows of X as K4's do (csr_gather.cuh): 8 rows in
// flight, through a cp.async ring in shared memory where F % 4 == 0 and X
// and Y are 16 B aligned (the float4 path), else through registers.
// Min and max are exact, and each combine rounds once (the _rn intrinsics
// keep nvcc from contracting), so the output equals the plain version's
// bit for bit (NaN for NaN) and two launches agree; no atomics.  The
// wrapper allocates the slots, 2 * ceil(m / span) * F floats, and passes
// the span (kernels/spmm.py).
//
// Chosen on the card: T = 512, as for K4 (kernels/spmm.py
// SPMM_SEMIRING_SPAN).  chip_smoke.py's sweep of (min, add) at F = 128
// over the undirected Graph500 RMAT-20 CSC, the weighted OD's shape
// (NVIDIA H100 80GB HBM3, 700 W; ms per call at T = 256, 512, 1024,
// 2048): 2.359 2.343 2.490 2.730.  Before the split one warp walked each
// row, and the heaviest row (64,633 edges) set the tail of a 22.65 ms
// launch; now it no longer does: 2.337 ms with it, 2.329 ms with it
// emptied.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "csr_gather.cuh"
#include "csr_spans.cuh"

namespace {

using csr_gather::Blocks;
using csr_gather::col;
using csr_gather::kChunk;
using csr_gather::kPer;
using csr_gather::kWarp;
constexpr float kBig = 1e30f;

enum Reduce { kMin = 0, kMax = 1 };
enum Combine { kAdd = 0, kLeft = 1, kMul = 2 };

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

template <int R>
__device__ __forceinline__ float reduce_op(float a, float b) {
  return R == kMin ? min_nan(a, b) : max_nan(a, b);
}

template <int R>
__device__ __forceinline__ float identity() {
  return R == kMin ? kBig : -kBig;
}

// REDUCE(acc, clip(COMBINE(x, w))), the clip of :398
template <int R, int C>
struct Fold {
  __device__ __forceinline__ float operator()(float acc, float w,
                                              float xv) const {
    float v = xv;
    if (C == kAdd) v = __fadd_rn(xv, w);
    if (C == kMul) v = __fmul_rn(xv, w);
    return reduce_op<R>(acc, min_nan(max_nan(v, -kBig), kBig));
  }
};

template <int R, int C, bool kVec>
__global__ void __launch_bounds__(Blocks<kVec>::kThreadsPerBlock)
spmm_semiring_span_pass(const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ indices,
                        const float* __restrict__ weights,
                        const float* __restrict__ x,
                        float* __restrict__ partials, int64_t n, int64_t m,
                        int64_t f, int64_t span, int64_t chunks) {
  using B = Blocks<kVec>;
  __shared__ float4 ring[B::kRingSize];
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * B::kWarps + threadIdx.x / kWarp;
  if (warp >= (m + span - 1) / span * chunks) return;  // whole warps exit
  const int64_t s = warp / chunks;
  const int64_t col0 = (warp % chunks) * kChunk;
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, n, m, span, s, piece);
  for (int slot = 0; slot < 2; ++slot) {
    if (piece[slot].begin == piece[slot].end) continue;
    float acc[kPer] = {identity<R>(), identity<R>(), identity<R>(),
                       identity<R>()};
    csr_gather::gather<kVec, C != kLeft>(indices, weights, x, f, col0, lane,
                                         piece[slot].begin, piece[slot].end,
                                         ring, acc, Fold<R, C>());
    float* out = partials + (2 * s + slot) * f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t c = col<kVec>(col0, lane, k);
      if (c < f) out[c] = acc[k];
    }
  }
}

template <int R, int C, bool kVec>
__global__ void __launch_bounds__(Blocks<kVec>::kThreadsPerBlock)
spmm_semiring_row_pass(const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ indices,
                       const float* __restrict__ weights,
                       const float* __restrict__ x,
                       const float* __restrict__ partials,
                       float* __restrict__ y, int64_t n, int64_t f,
                       int64_t span, int64_t chunks) {
  using B = Blocks<kVec>;
  __shared__ float4 ring[B::kRingSize];
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * B::kWarps + threadIdx.x / kWarp;
  if (warp >= n * chunks) return;  // whole warps exit together
  const int64_t row = warp / chunks;
  const int64_t col0 = (warp % chunks) * kChunk;
  const int64_t begin = __ldg(offsets + row);
  const int64_t end = __ldg(offsets + row + 1);
  float acc[kPer] = {identity<R>(), identity<R>(), identity<R>(),
                     identity<R>()};
  if (end - begin > span) {
    for (int64_t s = begin / span; s <= (end - 1) / span; ++s) {
      const float* part = partials + (2 * s + csr_spans::slot_of(begin, span, s)) * f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int64_t c = col<kVec>(col0, lane, k);
        if (c < f) acc[k] = reduce_op<R>(acc[k], part[c]);
      }
    }
  } else {
    csr_gather::gather<kVec, C != kLeft>(indices, weights, x, f, col0, lane,
                                         begin, end, ring, acc, Fold<R, C>());
  }
  float* yr = y + row * f;
  if (kVec) {
    const int64_t c = col<true>(col0, lane, 0);
    if (c < f) {
      *reinterpret_cast<float4*>(yr + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t c = col<false>(col0, lane, k);
      if (c < f) yr[c] = acc[k];
    }
  }
}

template <int R, int C, bool kVec>
cudaError_t launch(const void* offsets, const void* indices, const void* weights,
                   const void* x, void* y, void* partials, int64_t n, int64_t m,
                   int64_t f, int64_t span, cudaStream_t stream) {
  using B = Blocks<kVec>;
  const int64_t chunks = (f + kChunk - 1) / kChunk;
  const int64_t span_blocks =
      ((m + span - 1) / span * chunks + B::kWarps - 1) / B::kWarps;
  const int64_t row_blocks = (n * chunks + B::kWarps - 1) / B::kWarps;
  if (span_blocks > INT_MAX || row_blocks > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* xv = static_cast<const float*>(x);
  auto* part = static_cast<float*>(partials);
  if (span_blocks > 0) {
    spmm_semiring_span_pass<R, C, kVec>
        <<<static_cast<unsigned>(span_blocks), B::kThreadsPerBlock, 0, stream>>>(
            off, idx, w, xv, part, n, m, f, span, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmm_semiring_row_pass<R, C, kVec>
      <<<static_cast<unsigned>(row_blocks), B::kThreadsPerBlock, 0, stream>>>(
          off, idx, w, xv, part, static_cast<float*>(y), n, f, span, chunks);
  return cudaGetLastError();
}

template <int R, int C>
cudaError_t dispatch_vec(bool vec, const void* offsets, const void* indices,
                         const void* weights, const void* x, void* y,
                         void* partials, int64_t n, int64_t m, int64_t f,
                         int64_t span, cudaStream_t s) {
  return vec ? launch<R, C, true>(offsets, indices, weights, x, y, partials,
                                  n, m, f, span, s)
             : launch<R, C, false>(offsets, indices, weights, x, y, partials,
                                   n, m, f, span, s);
}

template <int R>
cudaError_t dispatch_combine(int combine, bool vec, const void* offsets,
                             const void* indices, const void* weights,
                             const void* x, void* y, void* partials, int64_t n,
                             int64_t m, int64_t f, int64_t span,
                             cudaStream_t s) {
  switch (combine) {
    case kAdd:
      return dispatch_vec<R, kAdd>(vec, offsets, indices, weights, x, y,
                                   partials, n, m, f, span, s);
    case kLeft:
      return dispatch_vec<R, kLeft>(vec, offsets, indices, weights, x, y,
                                    partials, n, m, f, span, s);
    case kMul:
      return dispatch_vec<R, kMul>(vec, offsets, indices, weights, x, y,
                                   partials, n, m, f, span, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// reduce: 0 = min, 1 = max.  combine: 0 = add, 1 = left, 2 = mul.  x and y
// are fp32 [n, f] row-major; partials holds 2 * ceil(m / span) * f floats
// of scratch (the heavy rows' slots).  weights is unread for "left" and
// may be null.  The float4 path runs where f % 4 == 0 and x and y are 16 B
// aligned, the scalar path elsewhere.  n = 0 or f = 0 launches nothing, so
// the pointers of empty arrays may be null.  Launches both passes on
// `stream`, without a sync, and returns cudaGetLastError() as an int (0 on
// success).
extern "C" int spmm_semiring(const void* offsets, const void* indices,
                             const void* weights, const void* x, void* y,
                             void* partials, int64_t n, int64_t m, int64_t f,
                             int reduce, int combine, int64_t span,
                             void* stream) {
  if ((reduce != kMin && reduce != kMax) || combine < kAdd || combine > kMul ||
      n < 0 || m < 0 || f < 0 || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || f == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaError_t err =
      reduce == kMin
          ? dispatch_combine<kMin>(combine, vec, offsets, indices, weights, x,
                                   y, partials, n, m, f, span, s)
          : dispatch_combine<kMax>(combine, vec, offsets, indices, weights, x,
                                   y, partials, n, m, f, span, s);
  return static_cast<int>(err);
}
