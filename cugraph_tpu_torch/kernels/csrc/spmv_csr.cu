// Sum SpMV over one CSR array triple, for Hopper (sm_90a):
//
//     y[r] = sum over e in [offsets[r], offsets[r+1]) of COMBINE(x[indices[e]], w[e])
//
// COMBINE is "mul" (w * x) or "left" (x alone, the k-core alive-neighbour
// count).  Pull runs it over the CSC (y[dst] = sum of w * x[src]), push over
// the CSR.
//
// Replaces the sum path of the TPU kernel cugraph_tpu/kernels/spmv_onehot.py:398
// (_kernel with reduce="sum", combine="mul"/"left").  That kernel re-expresses
// gather and scatter as one-hot MXU matmuls over host-built tile plans,
// because the TPU has no vector gather; the H100 has one, so this kernel reads
// the CSR directly and keeps none of that machinery.
//
// Bound: bytes.  Every edge costs 8 B (int32 index and fp32 weight; 4 B for
// "left"), every vertex 4 B each of offsets, x and y, against about two flops
// per edge: 0.0407 ms for "mul" on the directed RMAT-20 CSC at 3.35 TB/s.
// The x gather is random but x fits in the 50 MB L2 at RMAT-20.
//
// Design: two passes, both launched here on the caller's stream
// (csr_spans.cuh):
//   - the span pass: one warp per span of `span` edges sums the part of each
//     heavy row (degree > span) that lies in its span; its lanes stride over
//     the edges, each keeps an fp32 partial, and a fixed-order butterfly of
//     warp shuffles adds the 32; lane 0 writes the row's slot of the span;
//   - the row pass: a group of kGroup = 4 lanes per row, 8 rows per warp,
//     as cuSPARSE's vector CSR and the reference's low- and mid-degree
//     segments (per_v_transform_reduce_e.cuh:252-688).  A light row's
//     lanes stride over its edges and a butterfly over the 4 lanes adds
//     their partials; the first lane of a heavy row's group adds its slots
//     in span order; a row with no edges writes 0.
// Before the split one warp walked each row: the directed RMAT-20 CSC's
// heaviest row (39,539 in-edges, 1,236 strides of 32; the undirected
// Graph500 graph's has 64,633) set the tail, and half the rows, of at most
// 4 edges, left 28 or more of a warp's lanes idle.  There are no atomics
// and the orders are fixed, so two launches on the same inputs give
// bit-identical output; n = 0 launches nothing.  The wrapper allocates the
// slots, 2 * ceil(m / span) floats, and passes the span (kernels/spmv.py).
//
// Chosen on the card: span T1 = 1024 and 4 lanes per light row.
// chip_smoke.py's span sweep, "mul" over the directed RMAT-20 CSC, whose
// mean degree is 24.9 and which carries every K1 launch of the paths
// (NVIDIA H100 80GB HBM3, 700 W; ms per call, T1 = 256, 512, 1024, 2048,
// 4096; one run of chip_smoke.py's sweep while it also timed 8 lanes,
// since removed; its span sweep, which stays, gives the 4-lane row again
// within 1 % but at T1 = 256, 7 %):
//   4 lanes  0.134 0.117 0.117 0.186 0.231
//   8 lanes  0.139 0.122 0.125 0.144 0.183
// Longer spans leave light rows of up to T1 edges to 4 lanes; shorter ones
// send more rows through the span pass.  The heaviest row no longer sets
// the time: 0.118 ms with it, 0.118 ms with it emptied (0.298 and 0.157 ms
// before the split).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "csr_spans.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr int kGroup = 4;  // lanes per light row

template <bool kMul>
__device__ __forceinline__ float edge_value(const int32_t* __restrict__ indices,
                                            const float* __restrict__ weights,
                                            const float* __restrict__ x,
                                            int64_t e) {
  const float v = __ldg(x + __ldg(indices + e));
  return kMul ? v * __ldg(weights + e) : v;
}

template <bool kMul>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_span_pass(const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ indices,
               const float* __restrict__ weights, const float* __restrict__ x,
               float* __restrict__ partials, int64_t n, int64_t m,
               int64_t span) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (s >= (m + span - 1) / span) return;  // whole warps exit together
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, n, m, span, s, piece);
  for (int slot = 0; slot < 2; ++slot) {
    if (piece[slot].begin == piece[slot].end) continue;  // warp-uniform
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t e = piece[slot].begin + lane; e < piece[slot].end; e += kWarp) {
      acc += edge_value<kMul>(indices, weights, x, e);
    }
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
      acc += __shfl_xor_sync(kFull, acc, offset);
    }
    if (lane == 0) partials[2 * s + slot] = acc;
  }
}

template <bool kMul>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_row_pass(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ indices,
              const float* __restrict__ weights, const float* __restrict__ x,
              const float* __restrict__ partials, float* __restrict__ y,
              int64_t n, int64_t span) {
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
  float acc = 0.0f;
  if (end - begin > span) {
    if (sub == 0) {
      for (int64_t s = begin / span; s <= (end - 1) / span; ++s) {
        acc += partials[2 * s + csr_spans::slot_of(begin, span, s)];
      }
    }
  } else {
#pragma unroll 4
    for (int64_t e = begin + sub; e < end; e += kGroup) {
      acc += edge_value<kMul>(indices, weights, x, e);
    }
  }
#pragma unroll
  for (int offset = kGroup / 2; offset > 0; offset /= 2) {
    acc += __shfl_xor_sync(kFull, acc, offset);
  }
  if (valid && sub == 0) y[row] = acc;
}

template <bool kMul>
cudaError_t launch(const int32_t* offsets, const int32_t* indices,
                   const float* weights, const float* x, float* y,
                   float* partials, int64_t n, int64_t m, int64_t span,
                   cudaStream_t stream) {
  const int64_t span_blocks =
      ((m + span - 1) / span + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t rows_per_block = kThreadsPerBlock / kGroup;
  const int64_t row_blocks = (n + rows_per_block - 1) / rows_per_block;
  if (span_blocks > INT_MAX || row_blocks > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  if (span_blocks > 0) {
    spmv_span_pass<kMul><<<static_cast<unsigned>(span_blocks),
                           kThreadsPerBlock, 0, stream>>>(
        offsets, indices, weights, x, partials, n, m, span);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmv_row_pass<kMul><<<static_cast<unsigned>(row_blocks), kThreadsPerBlock,
                        0, stream>>>(
      offsets, indices, weights, x, partials, y, n, span);
  return cudaGetLastError();
}

}  // namespace

// combine: 0 = mul, 1 = left (weights unread, may be null).  partials holds
// 2 * ceil(m / span) floats of scratch (the heavy rows' slots).  The
// pointers of empty arrays may be null.  Launches both passes on `stream`,
// without a sync, and returns cudaGetLastError() as an int (0 on success).
extern "C" int spmv_csr_sum(const void* offsets, const void* indices,
                            const void* weights, const void* x, void* y,
                            void* partials, int64_t n, int64_t m, int combine,
                            int64_t span, void* stream) {
  if ((combine != 0 && combine != 1) || n < 0 || m < 0 || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto* part = static_cast<float*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      combine == 0 ? launch<true>(off, idx, w, xv, yv, part, n, m, span, s)
                   : launch<false>(off, idx, w, xv, yv, part, n, m, span, s);
  return static_cast<int>(err);
}
