// Sum SpMM over one CSR array triple, for Hopper (sm_90a):
//
//     Y[r, :] = sum over e in [offsets[r], offsets[r+1]) of w[e] * X[indices[e], :]
//
// X and Y are fp32 [n, F], row-major, any F >= 1.  The unit arm (w = 1)
// reads no weight array: the Brandes and BFS panels run it.  Pull runs over
// the CSC (Y[dst] = sum of w * X[src]), push over the CSR; the GNN's
// backward (kernels/spmm.py make_spmm_pair) is this kernel over the CSR.
//
// Replaces the sum path of the TPU kernel
// cugraph_tpu/kernels/spmm_onehot.py:272 (_kernel with reduce="sum",
// :332-363; called at :500).  That kernel turns the gather and the scatter
// into one-hot MXU products over host-built tile plans, chunks F to fit
// VMEM and offers split-bf16 precisions, because the TPU has no vector
// gather.  The H100 has one, so this kernel reads the CSR directly and
// keeps none of that machinery.
//
// Bound: bytes.  Counting each input once and each output once, a launch
// moves 4 (n + 1) + 4 m [+ 4 m weights] + 8 n F bytes (0.2175 ms for the
// unit arm at F = 128 on the directed RMAT-20 CSC at 3.35 TB/s).  The
// gathers read a 4 F B row of X per edge, m * 512 B at F = 128 (8.2 GB on
// that CSC), against a 331 MB X that does not fit the 50 MB L2, so no
// gather kernel comes near the byte bound; the hot rows of X stay in L2.
//
// Design: two passes, both launched here on the caller's stream, so that
// no row is walked by one warp, however heavy (csr_spans.cuh):
//   - the span pass: one warp per (span of `span` edges, feature chunk)
//     sums the part of each heavy row (degree > span) that lies in its span
//     into the row's fp64 slot of that span; light rows are skipped;
//   - the row pass: one warp per (row, feature chunk).  A light row sums
//     its edges in CSR order; a heavy row adds its slots in span order; a
//     row with no edges writes 0.
// The RMAT-20 CSC's heaviest row has 39,539 edges (the undirected
// Graph500 graph's 64,633); one warp walking it took ~10 ms of the 14.9 ms
// launch (NVIDIA H100 80GB HBM3, 700 W) before the split.
//
// A warp gathers its rows of X through csr_gather.cuh: 8 rows in flight,
// through a cp.async ring in shared memory where F % 4 == 0 and X and Y
// are 16 B aligned (the float4 path), else through registers.  A span pass
// warp finds its span's rows with two 33-ary searches of the offsets
// (csr_spans.cuh), so correctness does not depend on the order of rows.
//
// Chosen on the card, over the directed RMAT-20 (NVIDIA H100 80GB HBM3,
// 700 W; ms per call at T = 256, 512, 1024, 2048; one run of
// chip_smoke.py's sweep while it also timed the register schedule on the
// float4 path, since removed; its span sweep, which stays, gives the ring
// rows again within 1 %):
//   unit, F = 128, CSC:     cp.async ring 1.301 1.292 1.375 1.465
//                           registers     1.749 1.678 1.721 1.811
//   weighted, F = 256, CSC: cp.async ring 3.174 3.123 3.193 3.229
//                           registers     3.926 3.823 3.793 3.778
// so T = 512, and the ring on the float4 path.  The ring wins by
// occupancy: 48 registers and 16 KB of shared memory per 4-warp block let
// 40 warps stay on an SM, where the register schedule's 80 registers leave
// 24.  A warp covering all 256 features (two float4 per lane, each index
// and weight read once per row) gained nothing measurable with the ring
// (3.131 ms at T = 512) and is not kept.  Shorter spans add fix-up reads
// and searches, longer ones serialise more of each heavy row.  With the
// split the heaviest row no longer sets the time: the unit arm at F = 128
// takes 1.286 ms with it and 1.291 ms with it emptied (14.855 and 4.66 ms
// before the split).
//
// The sums run in fp64 and round to fp32 once: w * x of two fp32 values is
// exact in fp64, so the adds, in a fixed order, are the only rounding, and
// a row of tens of thousands of terms stays far inside the 1e-5 the callers
// are held to.  No atomics and a fixed order, so two launches give
// bit-identical output.  X is indexed as (int64) idx * F, so n * F may
// pass 2^31.  The wrapper allocates the slots, 2 * ceil(m / span) * F
// doubles, and passes the span (kernels/spmm.py).

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

// acc + w * x, in fp64: w * x of two fp32 values is exact there
template <bool kUnit>
struct Add {
  __device__ __forceinline__ double operator()(double acc, float w,
                                               float v) const {
    return kUnit ? acc + v
                 : __fma_rn(static_cast<double>(w), static_cast<double>(v), acc);
  }
};

template <bool kUnit, bool kVec>
__global__ void __launch_bounds__(Blocks<kVec>::kThreadsPerBlock)
spmm_span_pass(const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ indices,
               const float* __restrict__ weights, const float* __restrict__ x,
               double* __restrict__ partials, int64_t n, int64_t m, int64_t f,
               int64_t span, int64_t chunks) {
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
    double acc[kPer] = {};
    csr_gather::gather<kVec, !kUnit>(indices, weights, x, f, col0, lane,
                                     piece[slot].begin, piece[slot].end,
                                     ring, acc, Add<kUnit>());
    double* out = partials + (2 * s + slot) * f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t c = col<kVec>(col0, lane, k);
      if (c < f) out[c] = acc[k];
    }
  }
}

template <bool kUnit, bool kVec>
__global__ void __launch_bounds__(Blocks<kVec>::kThreadsPerBlock)
spmm_row_pass(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ indices,
              const float* __restrict__ weights, const float* __restrict__ x,
              const double* __restrict__ partials, float* __restrict__ y,
              int64_t n, int64_t f, int64_t span, int64_t chunks) {
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
  double acc[kPer] = {};
  if (end - begin > span) {
    for (int64_t s = begin / span; s <= (end - 1) / span; ++s) {
      const double* part = partials + (2 * s + csr_spans::slot_of(begin, span, s)) * f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int64_t c = col<kVec>(col0, lane, k);
        if (c < f) acc[k] += part[c];
      }
    }
  } else {
    csr_gather::gather<kVec, !kUnit>(indices, weights, x, f, col0, lane,
                                     begin, end, ring, acc, Add<kUnit>());
  }
  float* yr = y + row * f;
  if (kVec) {
    const int64_t c = col<true>(col0, lane, 0);
    if (c < f) {
      *reinterpret_cast<float4*>(yr + c) = make_float4(
          __double2float_rn(acc[0]), __double2float_rn(acc[1]),
          __double2float_rn(acc[2]), __double2float_rn(acc[3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t c = col<false>(col0, lane, k);
      if (c < f) yr[c] = __double2float_rn(acc[k]);
    }
  }
}

template <bool kUnit, bool kVec>
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
  auto* part = static_cast<double*>(partials);
  if (span_blocks > 0) {
    spmm_span_pass<kUnit, kVec>
        <<<static_cast<unsigned>(span_blocks), B::kThreadsPerBlock, 0, stream>>>(
            off, idx, w, xv, part, n, m, f, span, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmm_row_pass<kUnit, kVec>
      <<<static_cast<unsigned>(row_blocks), B::kThreadsPerBlock, 0, stream>>>(
          off, idx, w, xv, part, static_cast<float*>(y), n, f, span, chunks);
  return cudaGetLastError();
}

template <bool kUnit>
cudaError_t dispatch(bool vec, const void* offsets, const void* indices,
                     const void* weights, const void* x, void* y,
                     void* partials, int64_t n, int64_t m, int64_t f,
                     int64_t span, cudaStream_t s) {
  return vec ? launch<kUnit, true>(offsets, indices, weights, x, y, partials,
                                   n, m, f, span, s)
             : launch<kUnit, false>(offsets, indices, weights, x, y, partials,
                                    n, m, f, span, s);
}

}  // namespace

// unit: 1 = every weight is 1 (weights unread, may be null), 0 = weighted.
// x and y are fp32 [n, f] row-major; partials holds 2 * ceil(m / span) * f
// doubles of scratch (the heavy rows' slots).  The float4 path runs where
// f % 4 == 0 and x and y are 16 B aligned, the scalar path elsewhere.
// n = 0 or f = 0 launches nothing, so the pointers of empty arrays may be
// null.  Launches both passes on `stream`, without a sync, and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int spmm_csr_sum(const void* offsets, const void* indices,
                            const void* weights, const void* x, void* y,
                            void* partials, int64_t n, int64_t m, int64_t f,
                            int unit, int64_t span, void* stream) {
  if ((unit != 0 && unit != 1) || n < 0 || m < 0 || f < 0 || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || f == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaError_t err =
      unit ? dispatch<true>(vec, offsets, indices, weights, x, y, partials, n,
                            m, f, span, s)
           : dispatch<false>(vec, offsets, indices, weights, x, y, partials, n,
                             m, f, span, s);
  return static_cast<int>(err);
}
