// Sum SpMM over one CSR array triple, for Hopper (sm_90a):
//
//     Y[r, :] = sum over e in [offsets[r], offsets[r+1]) of w[e] * X[indices[e], :]
//
// X and Y are fp32 [n, F], row-major, any F >= 1.  The unit arm (w = 1)
// reads no weight array: the Brandes and BFS panels run it.  Pull runs over
// the CSC (Y[dst] = sum of w * X[src]), push over the CSR.
//
// Replaces the sum path of the TPU kernel
// cugraph_tpu/kernels/spmm_onehot.py:272 (_kernel with reduce="sum",
// :332-363; called at :500).  That kernel turns the gather and the scatter
// into one-hot MXU products over host-built tile plans, chunks F to fit
// VMEM and offers split-bf16 precisions, because the TPU has no vector
// gather.  The H100 has one, so this kernel reads the CSR directly and
// keeps none of that machinery.
//
// Design: one warp per (row, chunk of 128 features).  The warp loads 32 of
// the row's (index, weight) pairs at a time, coalesced, and broadcasts each
// with a shuffle; for every edge it reads X[idx, chunk] as one 512 B row.
// Where F % 4 == 0 and X and Y are 16 B aligned, each lane owns 4
// consecutive features and moves them as one float4; otherwise each lane
// owns features lane, lane + 32, lane + 64 and lane + 96 of the chunk, so
// that each scalar load is still coalesced.  Each lane sums its features in
// registers, in CSR edge order, and writes Y[r, chunk] once.  No atomics and
// a fixed order, so two launches give bit-identical output; a row with no
// edges writes 0.  X is indexed as (int64) idx * F, so n * F may pass 2^31.
//
// The sums run in fp64 and round to fp32 once.  A row sums up to 64 k terms
// here (the heaviest RMAT-20 row), and a running fp32 sum over that many
// drifts by about sqrt(k) * 2^-24 relative, near the 1e-5 the callers are
// held to; w * x of two fp32 values is exact in fp64, so the adds are the
// only rounding.  The fp64 adds (2 m F flops, ~0.12 ms per launch at the
// H100's 34 TFLOP/s fp64 rate, at F = 128 on the directed RMAT-20 CSC) stay
// below the memory time.
//
// Bound: bytes.  Counting each input once and each output once, a launch
// moves 4 (n + 1) + 4 m [+ 4 m weights] + 8 n F bytes.  The simple design
// reads a 4 F B row of X per edge, m * 512 B at F = 128 (8.2 GB on the
// directed RMAT-20 CSC, 16 GB on the undirected one), against a 331 MB X
// that does not fit the 50 MB L2, so it runs far above its bound.  The
// heaviest row sets a tail: one warp walks all of its edges (39,539 on the
// directed RMAT-20 CSC, 64,633 on the undirected graph) while the other SMs
// finish.  Degree-descending renumbering starts the heavy rows first;
// splitting heavy rows over several warps, and staging X rows through
// shared memory with cp.async or TMA, are the known fixes, not made yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr int kChunk = 128;  // features per warp
constexpr int kPerLane = kChunk / kWarp;

template <bool kUnit, bool kVec>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmm_csr_sum_kernel(const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ indices,
                    const float* __restrict__ weights,
                    const float* __restrict__ x,
                    float* __restrict__ y,
                    int64_t n, int64_t f, int64_t chunks) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= n * chunks) return;  // whole warps exit together
  const int64_t row = warp / chunks;
  const int64_t col0 = (warp % chunks) * kChunk;
  const int64_t begin = offsets[row];
  const int64_t end = offsets[row + 1];
  double acc[kPerLane] = {0.0, 0.0, 0.0, 0.0};
  // the features this lane owns: col0 + lane*4 + k (kVec) or col0 + lane + 32k
  const int64_t base = kVec ? col0 + lane * kPerLane : col0 + lane;
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int64_t mine = e0 + lane;
    const int32_t my_idx = mine < end ? __ldg(indices + mine) : 0;
    float my_w = 1.0f;
    if (!kUnit) my_w = mine < end ? __ldg(weights + mine) : 0.0f;
    const int count = static_cast<int>(end - e0 < kWarp ? end - e0 : kWarp);
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const int64_t src = __shfl_sync(0xffffffffu, my_idx, j);
      const double w = kUnit ? 1.0 : __shfl_sync(0xffffffffu, my_w, j);
      const float* xr = x + src * f;
      if (kVec) {
        if (base < f) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr + base));
          const double vs[kPerLane] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            acc[k] = kUnit ? acc[k] + vs[k] : __fma_rn(w, vs[k], acc[k]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int64_t c = base + k * kWarp;
          if (c < f) {
            const double v = __ldg(xr + c);
            acc[k] = kUnit ? acc[k] + v : __fma_rn(w, v, acc[k]);
          }
        }
      }
    }
  }
  float* yr = y + row * f;
  if (kVec) {
    if (base < f) {
      *reinterpret_cast<float4*>(yr + base) = make_float4(
          __double2float_rn(acc[0]), __double2float_rn(acc[1]),
          __double2float_rn(acc[2]), __double2float_rn(acc[3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t c = base + k * kWarp;
      if (c < f) yr[c] = __double2float_rn(acc[k]);
    }
  }
}

template <bool kUnit, bool kVec>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, int64_t n,
                   int64_t f, cudaStream_t stream) {
  const int64_t chunks = (f + kChunk - 1) / kChunk;
  const int64_t blocks = (n * chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmm_csr_sum_kernel<kUnit, kVec><<<static_cast<unsigned>(blocks),
                                     kThreadsPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), static_cast<const float*>(x),
      static_cast<float*>(y), n, f, chunks);
  return cudaGetLastError();
}

}  // namespace

// unit: 1 = every weight is 1 (weights unread, may be null), 0 = weighted.
// x and y are fp32 [n, f] row-major.  n = 0 or f = 0 launches nothing, so the
// pointers of empty arrays may be null.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int spmm_csr_sum(const void* offsets, const void* indices,
                            const void* weights, const void* x, void* y,
                            int64_t n, int64_t f, int unit, void* stream) {
  if ((unit != 0 && unit != 1) || n < 0 || f < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || f == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaError_t err;
  if (unit) {
    err = vec ? launch<true, true>(offsets, indices, weights, x, y, n, f, s)
              : launch<true, false>(offsets, indices, weights, x, y, n, f, s);
  } else {
    err = vec ? launch<false, true>(offsets, indices, weights, x, y, n, f, s)
              : launch<false, false>(offsets, indices, weights, x, y, n, f, s);
  }
  return static_cast<int>(err);
}
