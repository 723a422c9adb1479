// Heavy rows of a CSR split into spans of edges, shared by the sum kernels
// K1 (spmv_csr.cu) and K4 (spmm_csr.cu), the min/max kernels K2
// (spmv_semiring.cu) and K5 (spmm_semiring.cu), and the argmax select K3
// (spmv_select.cu).
//
// The edge array [0, m) is cut into spans of `span` edges: span s holds
// edges [s * span, min((s + 1) * span, m)).  A row is heavy when its degree
// exceeds `span`.  A span touches at most two heavy rows: the one holding
// its first edge (slot 0), and one that starts inside it (slot 1), which,
// longer than a span, also holds the span's last edge.  A span pass reduces
// each heavy row's piece of each span into the slot (s, 0) or (s, 1); the
// row pass then combines a heavy row's slots in span order.  Both orders
// are fixed, so two launches give bit-identical output without atomics.
// The caller allocates the slots: 2 * ceil(m / span) per output feature.
//
// Correctness does not depend on the order of the rows: a span finds its
// heavy rows by searching the offsets, whatever their degrees.

#pragma once

#include <cstdint>

namespace csr_spans {

struct Piece {
  int64_t begin, end;  // edges [begin, end) of one heavy row; empty if equal
  int64_t row;         // the row searched for the piece (K3 reads its x)
};

// One round of a 33-ary search by a whole warp for the row holding edge e,
// with offsets[lo] <= e < offsets[hi]: lane i probes
// q_i = lo + (hi - lo) (i + 1) / 33, a ballot finds the last probe at or
// below e, and [lo, hi) shrinks to the gap around it (to one row once
// hi - lo <= 33).
__device__ __forceinline__ void search_round(const int32_t* __restrict__ offsets,
                                             int64_t e, int lane, int64_t& lo,
                                             int64_t& hi) {
  const int64_t q = lo + (hi - lo) * (lane + 1) / 33;
  const unsigned below = __ballot_sync(0xffffffffu, __ldg(offsets + q) <= e);
  const int k = __popc(below);  // probes at or below e: lanes 0 .. k - 1
  const int64_t q_lo = __shfl_sync(0xffffffffu, q, k > 0 ? k - 1 : 0);
  const int64_t q_hi = __shfl_sync(0xffffffffu, q, k < 32 ? k : 31);
  if (k > 0) lo = q_lo;
  if (k < 32) hi = q_hi;
}

// The rows holding edges a and b (offsets[r] <= e < offsets[r + 1], so
// rows with no edges are skipped), for 0 <= a, b < offsets[n].  Called by
// a whole warp: two 33-ary searches in one loop, four rounds of loads at
// a million rows instead of twenty for a binary search.
__device__ __forceinline__ void rows_of_edges(const int32_t* __restrict__ offsets,
                                              int64_t n, int64_t a, int64_t b,
                                              int64_t& row_a, int64_t& row_b) {
  const int lane = threadIdx.x % 32;
  int64_t lo_a = 0, hi_a = n, lo_b = 0, hi_b = n;
  while (hi_a - lo_a > 1 || hi_b - lo_b > 1) {  // warp-uniform
    search_round(offsets, a, lane, lo_a, hi_a);
    search_round(offsets, b, lane, lo_b, hi_b);
  }
  row_a = lo_a;
  row_b = lo_b;
}

// The heavy pieces of span s of an edge array of m > 0 edges: piece[0] of
// the row holding the span's first edge, piece[1] of a heavy row that
// starts inside the span, each with its row.  Warp-uniform when s is.
__device__ __forceinline__ void heavy_pieces(const int32_t* __restrict__ offsets,
                                             int64_t n, int64_t m, int64_t span,
                                             int64_t s, Piece (&piece)[2]) {
  const int64_t e0 = s * span;
  const int64_t e1 = e0 + span < m ? e0 + span : m;
  int64_t r0, r1;
  rows_of_edges(offsets, n, e0, e1 - 1, r0, r1);
  const int64_t end0 = __ldg(offsets + r0 + 1);
  const int64_t begin1 = __ldg(offsets + r1);
  const bool heavy0 = end0 - __ldg(offsets + r0) > span;
  const bool heavy1 = r1 != r0 && __ldg(offsets + r1 + 1) - begin1 > span;
  piece[0] = heavy0 ? Piece{e0, end0 < e1 ? end0 : e1, r0} : Piece{0, 0, r0};
  piece[1] = heavy1 ? Piece{begin1, e1, r1} : Piece{0, 0, r1};
}

// The slot that span s gave the heavy row whose edges start at `begin`:
// 1 in the span where the row starts, unless it starts on the span's first
// edge; 0 in every later span.
__device__ __forceinline__ int64_t slot_of(int64_t begin, int64_t span,
                                           int64_t s) {
  return s == begin / span && begin % span != 0 ? 1 : 0;
}

}  // namespace csr_spans
