// Gathers of X rows along a range of CSR edges, shared by the SpMM kernels
// K4 (spmm_csr.cu, sums) and K5 (spmm_semiring.cu, min/max).
//
// A warp owns one chunk of kChunk = 128 features.  It loads 32 of the
// range's (index, weight) pairs at a time, coalesced, broadcasts each with
// a shuffle, and folds each edge's features into its lanes' accumulators,
// in edge order, with step(acc, w, x).  It keeps kDepth = 8 X rows in
// flight:
//   - the float4 path (F % 4 == 0, X and Y 16 B aligned): each lane owns 4
//     consecutive features of the chunk, and a ring of kDepth stages in
//     shared memory (4 KB per warp) is filled with cp.async, 16 B per lane
//     per row.  Each lane copies and reads back only its own 16 B, so the
//     lanes need no barrier.  It runs in 4-warp blocks;
//   - the scalar path: each lane owns features lane + 32 k, so that each
//     load is still coalesced, and loads its features of the next kDepth
//     rows into registers before it folds any of them.  It runs in 8-warp
//     blocks.
// X is indexed as (int64) idx * F, so n * F may pass 2^31.

#pragma once

#include <cstdint>

namespace csr_gather {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kDepth = 8;             // X rows in flight per warp
constexpr int kPer = 4;               // features per lane in a chunk
constexpr int kChunk = kWarp * kPer;  // features per warp

template <bool kVec>
struct Blocks {
  static constexpr int kThreadsPerBlock = kVec ? 128 : 256;
  static constexpr int kWarps = kThreadsPerBlock / kWarp;
  static constexpr int kRingSize = kVec ? kWarps * kDepth * kWarp : 1;
};

// The feature k < kPer that a lane owns in a chunk starting at col0: with
// kVec, one float4 at col0 + 4 lane; else scalars at col0 + lane + 32 k.
template <bool kVec>
__device__ __forceinline__ int64_t col(int64_t col0, int lane, int k) {
  return kVec ? col0 + 4 * lane + k : col0 + lane + kWarp * k;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// acc[k] = step(acc[k], w[e], X[indices[e], col(k)]) over e in [begin,
// end), scalar lanes; w = 1 unless kWeighted (the weights are then unread)
template <bool kWeighted, typename T, typename Step>
__device__ __forceinline__ void gather_rows(
    const int32_t* __restrict__ indices, const float* __restrict__ weights,
    const float* __restrict__ x, int64_t f, int64_t col0, int lane,
    int64_t begin, int64_t end, T (&acc)[kPer], Step step) {
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int64_t mine = e0 + lane;
    const int32_t my_idx = mine < end ? __ldg(indices + mine) : 0;
    const float my_w = !kWeighted || mine >= end ? 1.0f : __ldg(weights + mine);
    const int count = end - e0 < kWarp ? static_cast<int>(end - e0) : kWarp;
    for (int j = 0; j < count; j += kDepth) {  // j + kDepth <= kWarp
      float v[kDepth][kPer];
      float w[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const float* xr = x + static_cast<int64_t>(__shfl_sync(kFull, my_idx, j + d)) * f;
        w[d] = kWeighted ? __shfl_sync(kFull, my_w, j + d) : 1.0f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int64_t c = col<false>(col0, lane, k);
          v[d][k] = j + d < count && c < f ? __ldg(xr + c) : 0.0f;
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (j + d < count) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) acc[k] = step(acc[k], w[d], v[d][k]);
        }
      }
    }
  }
}

// The same fold, float4 lanes: `ring` is this warp's [kDepth][kWarp]
// float4s, filled with cp.async.
template <bool kWeighted, typename T, typename Step>
__device__ __forceinline__ void gather_rows_async(
    const int32_t* __restrict__ indices, const float* __restrict__ weights,
    const float* __restrict__ x, int64_t f, int64_t col0, int lane,
    int64_t begin, int64_t end, float4* ring, T (&acc)[kPer], Step step) {
  const int64_t c = col<true>(col0, lane, 0);
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int64_t mine = e0 + lane;
    const int32_t my_idx = mine < end ? __ldg(indices + mine) : 0;
    const float my_w = !kWeighted || mine >= end ? 1.0f : __ldg(weights + mine);
    const int count = end - e0 < kWarp ? static_cast<int>(end - e0) : kWarp;
    // one commit group per edge, empty past the batch, so that
    // wait_group(kDepth - 1) always means "edge j has landed"
    auto prefetch = [&](int j) {
      if (j < count) {
        const float* xr = x + static_cast<int64_t>(__shfl_sync(kFull, my_idx, j)) * f;
        if (c < f) cp_async16(ring + (j % kDepth) * kWarp + lane, xr + c);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kDepth - 1; ++j) prefetch(j);
    for (int j = 0; j < count; ++j) {
      prefetch(j + kDepth - 1);
      cp_async_wait<kDepth - 1>();
      const float w = kWeighted ? __shfl_sync(kFull, my_w, j) : 1.0f;
      const float4 t = ring[(j % kDepth) * kWarp + lane];
      acc[0] = step(acc[0], w, t.x);
      acc[1] = step(acc[1], w, t.y);
      acc[2] = step(acc[2], w, t.z);
      acc[3] = step(acc[3], w, t.w);
    }
  }
}

// The fold on the block's path; `ring` is the block's shared
// Blocks<kVec>::kRingSize float4s.
template <bool kVec, bool kWeighted, typename T, typename Step>
__device__ __forceinline__ void gather(const int32_t* indices,
                                       const float* weights, const float* x,
                                       int64_t f, int64_t col0, int lane,
                                       int64_t begin, int64_t end,
                                       float4* ring, T (&acc)[kPer],
                                       Step step) {
  if constexpr (kVec) {
    gather_rows_async<kWeighted>(indices, weights, x, f, col0, lane, begin,
                                 end, ring + (threadIdx.x / kWarp) * kDepth * kWarp,
                                 acc, step);
  } else {
    gather_rows<kWeighted>(indices, weights, x, f, col0, lane, begin, end,
                           acc, step);
  }
}

}  // namespace csr_gather
