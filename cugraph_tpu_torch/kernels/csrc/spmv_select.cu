// Argmax select over one CSR array triple, for Hopper (sm_90a):
//
//     y[r] = max { indices[e] : e in [offsets[r], offsets[r+1]), TEST(e, r) }, or -1
//
// TEST is one of two equality tests:
//   eqsel_rel  |x[u] + w[e] - x[r]| <= atol + rtol * |x[r]| and x[u] < x[r],
//              u = indices[e], in fp32, rounded as written (the BFS and
//              SSSP predecessor recovery: the largest in-neighbour u whose
//              relaxation reaches x[r]); with unit weights w = 1 and the
//              weight array is not read;
//   eqsel      w[e] == x[r] (the second pass of the random neighbour select:
//              the largest id whose edge priority equals the row's maximum).
// The result is an int32 vertex id, so ids need no f32 bound (the TPU
// kernel carries them as f32, exact below 2^24).  A NaN fails <=, < and
// ==, so an edge whose x[u], x[r] or w is NaN is never selected, and
// -0.0 == +0.0 holds, as in the plain version.
//
// Replaces the argmax-recovery modes of the TPU kernel
// cugraph_tpu/kernels/spmv_onehot.py:398 (_kernel with combine="eqsel",
// :531-540, and "eqsel_rel", :541-555, under reduce="max"), and the
// precision guard of :621-627 with it: that kernel needs bit-exact one-hot
// selections (split3 or highest) to gather x at both endpoints, while this
// kernel loads x directly.  eqsel_rel adds one condition to the TPU test: a
// candidate must be strictly closer, x[u] < x[r].  Under the tolerance
// alone, two endpoints of an edge lighter than the tolerance each pass the
// test for the other, and the recovered parents form cycles (the JAX
// package's SSSP trees fail the Graph500 validator on RMAT-16 with Graph500
// weights).  A shortest-path parent over a positive weight is strictly
// closer, so the condition removes only those sideways matches, and the
// rows the callers drop (unreached ones, whose neighbours are unreached
// too).  The TPU kernel skips a NaN weight as a padding lane; failing the
// test gives the same result.
//
// Bound: bytes.  eqsel_rel reads 8 B per edge (int32 index, fp32 weight;
// 4 B at unit weight) and eqsel 4 B per edge (the weight) plus 4 B per
// selected edge (its index, loaded only on a hit, about one per row); every
// vertex costs 4 B each of offsets, x and y: 0.0773 ms for eqsel_rel on the
// undirected Graph500 RMAT-20 CSC (31.4 M edges) at 3.35 TB/s.  The x[u]
// gather is random but x fits in the 50 MB L2 at RMAT-20.
//
// Design: that of the min/max SpMV spmv_semiring.cu, two passes launched
// here on the caller's stream (csr_spans.cuh):
//   - the span pass: one warp per span of `span` edges takes, for each
//     heavy row (degree > span) with edges in its span, the largest
//     qualifying id over the row's part of the span, with that row's x and
//     tolerance; its lanes stride over the edges and a butterfly of warp
//     shuffles takes the max; lane 0 writes the row's int32 slot of the
//     span (-1 when no edge passes);
//   - the row pass: a group of kGroup = 8 lanes per row, 4 rows per warp.
//     A light row computes x[r] and the tolerance once, its lanes stride
//     over its edges and a butterfly over the group takes the max; the
//     first lane of a heavy row's group takes the max of its slots in span
//     order; a row with no edges writes -1.
// Max over int32 ids is exact and order-free, so there are no atomics, two
// launches give bit-identical output, and the result equals the plain
// version bit for bit.  The wrapper allocates the slots, 2 * ceil(m /
// span) of them, and passes the span (kernels/semiring.py).  n = 0
// launches nothing.
//
// Before the split one warp walked each row: the undirected Graph500
// RMAT-20 CSC's heaviest row (64,633 edges, 2,020 strides of 32) set the
// tail, and most rows, of a few edges, left most of a warp's lanes idle.
//
// Chosen on the card: T = 2048 (kernels/semiring.py SPMV_SELECT_SPAN).
// chip_smoke.py's sweep over that CSC, which carries all 12 of K3's
// launches on the paths (NVIDIA H100 80GB HBM3, 700 W; ms per call at
// T = 256, 512, 1024, 2048; PERF.md; the first of four sweeps):
//   eqsel_rel unit  0.1824 0.1732 0.1560 0.1531   (8 launches: BFS)
//   eqsel_rel       0.2148 0.2066 0.1911 0.1900   (4 launches: SSSP)
//   eqsel           0.1615 0.1142 0.0964 0.0901   (no path yet)
// Weighted by the launches, 2048 came out 1.3-1.4 % faster than 1024 in
// three sweeps and 3.5 % slower in one, whose eqsel_rel unit at 2048
// (0.1647) the same run's timed row (0.1493) does not repeat.  A row of up
// to T edges goes to one group of 8 lanes; on this graph (mean degree
// 48.6) that showed no cost.  Loading every index under eqsel, not only a
// hit's, took 0.1191-0.1213 ms at T = 1024-2048, 26-32 % slower.
//
// Measured at T = 2048 (PERF.md): eqsel_rel unit 0.1493 ms, eqsel_rel
// 0.1938, eqsel 0.0890, against 0.3385-0.3440, 0.5393-0.5458 and
// 0.2831-0.2838 for one warp per row in the same runs; the heaviest row
// no longer sets the time (eqsel_rel 0.1869 ms with it emptied against
// 0.1873).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "csr_spans.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr int kGroup = 8;  // lanes per light row

enum Mode { kEqselRel = 0, kEqselRelUnit = 1, kEqsel = 2 };

// What TEST compares a row's edges with: x[r] and, for eqsel_rel, the
// tolerance (row_test computes both once per row)
template <int M>
struct RowTest {
  float xr, tol;

  // indices[e] if edge e passes, else -1; _rn intrinsics: no contraction
  // into an fma, one rounding per operation
  __device__ __forceinline__ int32_t candidate(const int32_t* __restrict__ indices,
                                               const float* __restrict__ weights,
                                               const float* __restrict__ x,
                                               int64_t e) const {
    if constexpr (M == kEqsel) {
      // the index is loaded only on a hit, about one edge per row
      return __ldg(weights + e) == xr ? __ldg(indices + e) : -1;
    } else {
      const int32_t u = __ldg(indices + e);
      const float w = M == kEqselRelUnit ? 1.0f : __ldg(weights + e);
      const float xu = __ldg(x + u);
      return fabsf(__fsub_rn(__fadd_rn(xu, w), xr)) <= tol && xu < xr ? u : -1;
    }
  }
};

template <int M>
__device__ __forceinline__ RowTest<M> row_test(const float* __restrict__ x,
                                               int64_t row, float atol,
                                               float rtol) {
  const float xr = __ldg(x + row);
  return {xr, M == kEqsel ? 0.0f : __fadd_rn(atol, __fmul_rn(rtol, fabsf(xr)))};
}

// the largest candidate of [begin, end), strided over `stride` lanes from
// `lane`
template <int M>
__device__ __forceinline__ int32_t strided_select(const RowTest<M>& test,
                                                  const int32_t* __restrict__ indices,
                                                  const float* __restrict__ weights,
                                                  const float* __restrict__ x,
                                                  int64_t begin, int64_t end,
                                                  int lane, int stride) {
  int32_t best = -1;
#pragma unroll 4
  for (int64_t e = begin + lane; e < end; e += stride) {
    best = max(best, test.candidate(indices, weights, x, e));
  }
  return best;
}

// a butterfly over aligned groups of `width` lanes: every lane of a group
// ends with the group's max
template <int kWidth>
__device__ __forceinline__ int32_t group_max(int32_t best) {
#pragma unroll
  for (int offset = kWidth / 2; offset > 0; offset /= 2) {
    best = max(best, __shfl_xor_sync(kFull, best, offset));
  }
  return best;
}

template <int M>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_select_span_pass(const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ indices,
                      const float* __restrict__ weights,
                      const float* __restrict__ x, int32_t* __restrict__ slots,
                      int64_t n, int64_t m, int64_t span, float atol,
                      float rtol) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (s >= (m + span - 1) / span) return;  // whole warps exit together
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, n, m, span, s, piece);
  for (int slot = 0; slot < 2; ++slot) {
    if (piece[slot].begin == piece[slot].end) continue;  // warp-uniform
    const RowTest<M> test = row_test<M>(x, piece[slot].row, atol, rtol);
    const int32_t best = group_max<kWarp>(strided_select<M>(
        test, indices, weights, x, piece[slot].begin, piece[slot].end, lane,
        kWarp));
    if (lane == 0) slots[2 * s + slot] = best;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_select_row_pass(const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ weights,
                     const float* __restrict__ x,
                     const int32_t* __restrict__ slots,
                     int32_t* __restrict__ y, int64_t n, int64_t span,
                     float atol, float rtol) {
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
  int32_t best = -1;
  if (end - begin > span) {
    if (sub == 0) {
      for (int64_t s = begin / span; s <= (end - 1) / span; ++s) {
        best = max(best, slots[2 * s + csr_spans::slot_of(begin, span, s)]);
      }
    }
  } else if (end > begin) {
    const RowTest<M> test = row_test<M>(x, row, atol, rtol);
    best = strided_select<M>(test, indices, weights, x, begin, end, sub,
                             kGroup);
  }
  best = group_max<kGroup>(best);
  if (valid && sub == 0) y[row] = best;
}

template <int M>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, void* slots,
                   int64_t n, int64_t m, int64_t span, float atol, float rtol,
                   cudaStream_t stream) {
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
  const auto* xv = static_cast<const float*>(x);
  auto* sl = static_cast<int32_t*>(slots);
  if (span_blocks > 0) {
    spmv_select_span_pass<M><<<static_cast<unsigned>(span_blocks),
                               kThreadsPerBlock, 0, stream>>>(
        off, idx, w, xv, sl, n, m, span, atol, rtol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmv_select_row_pass<M><<<static_cast<unsigned>(row_blocks),
                            kThreadsPerBlock, 0, stream>>>(
      off, idx, w, xv, sl, static_cast<int32_t*>(y), n, span, atol, rtol);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 = eqsel_rel, 1 = eqsel_rel at unit weight (weights unread, may be
// null), 2 = eqsel (atol and rtol unread).  x is fp32, y int32.  slots
// holds 2 * ceil(m / span) int32 of scratch (the heavy rows' slots).  The
// pointers of empty arrays may be null.  Launches both passes on `stream`,
// without a sync, and returns cudaGetLastError() as an int (0 on success).
extern "C" int spmv_select(const void* offsets, const void* indices,
                           const void* weights, const void* x, void* y,
                           void* slots, int64_t n, int64_t m, int mode,
                           float atol, float rtol, int64_t span,
                           void* stream) {
  if (mode < kEqselRel || mode > kEqsel || n < 0 || m < 0 || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kEqselRel:
      return static_cast<int>(launch<kEqselRel>(offsets, indices, weights, x,
                                                y, slots, n, m, span, atol,
                                                rtol, s));
    case kEqselRelUnit:
      return static_cast<int>(launch<kEqselRelUnit>(offsets, indices, weights,
                                                    x, y, slots, n, m, span,
                                                    atol, rtol, s));
    default:
      return static_cast<int>(launch<kEqsel>(offsets, indices, weights, x, y,
                                             slots, n, m, span, atol, rtol,
                                             s));
  }
}
