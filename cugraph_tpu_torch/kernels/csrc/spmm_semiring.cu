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
// Replaces the min/max path of the TPU kernel
// cugraph_tpu/kernels/spmm_onehot.py:365-416 (_kernel with reduce="min"/
// "max"; combines :386-397, clip :398, identity :281).  That kernel moves
// values between lanes and sublanes with identity matmuls, reduces each
// dst-sorted run with a shifted scan (:400-405) and scatters the run heads
// with one-hot MXU selections, because the TPU has no vector gather or
// scatter; this kernel reads the CSR directly and keeps none of that.
//
// Design: that of the sum SpMM spmm_csr.cu.  One warp per (row, chunk of
// 128 features); the warp loads 32 (index, weight) pairs at a time and
// broadcasts each with a shuffle; each lane reduces its features of X[idx,
// chunk] in registers (a float4 where F % 4 == 0 and X and Y are 16 B
// aligned, else four coalesced scalars) and writes Y[r, chunk] once.  Min
// and max are exact and order-free, and each combine rounds once (the _rn
// intrinsics keep nvcc from contracting), so the output equals the plain
// version's bit for bit and two launches agree.
//
// Bound: bytes.  Counting each input once and each output once, a launch
// moves 4 (n + 1) + 4 m [+ 4 m weights] + 8 n F bytes.  As in the sum
// kernel, the simple design reads a 4 F B row of X per edge (16 GB at
// F = 128 on the undirected RMAT-20 CSC) from an X larger than the 50 MB
// L2, and the heaviest row (64,633 edges there) sets a one-warp tail.
// Splitting heavy rows and staging X rows through shared memory are the
// known fixes, not made yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr int kChunk = 128;  // features per warp
constexpr int kPerLane = kChunk / kWarp;
constexpr float kBig = 1e30f;

enum Reduce { kMin = 0, kMax = 1 };
enum Combine { kAdd = 0, kLeft = 1, kMul = 2 };

template <int R>
__device__ __forceinline__ float reduce_op(float a, float b) {
  return R == kMin ? fminf(a, b) : fmaxf(a, b);
}

// COMBINE, then the clip of :398
template <int C>
__device__ __forceinline__ float edge_value(float xv, float w) {
  float v = xv;
  if (C == kAdd) v = __fadd_rn(xv, w);
  if (C == kMul) v = __fmul_rn(xv, w);
  return fminf(fmaxf(v, -kBig), kBig);
}

template <int R, int C, bool kVec>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmm_semiring_kernel(const int32_t* __restrict__ offsets,
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
  const float ident = R == kMin ? kBig : -kBig;
  float acc[kPerLane] = {ident, ident, ident, ident};
  // the features this lane owns: col0 + lane*4 + k (kVec) or col0 + lane + 32k
  const int64_t base = kVec ? col0 + lane * kPerLane : col0 + lane;
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int64_t mine = e0 + lane;
    const int32_t my_idx = mine < end ? __ldg(indices + mine) : 0;
    float my_w = 0.0f;
    if (C != kLeft) my_w = mine < end ? __ldg(weights + mine) : 0.0f;
    const int count = static_cast<int>(end - e0 < kWarp ? end - e0 : kWarp);
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const int64_t src = __shfl_sync(0xffffffffu, my_idx, j);
      const float w = C == kLeft ? 0.0f : __shfl_sync(0xffffffffu, my_w, j);
      const float* xr = x + src * f;
      if (kVec) {
        if (base < f) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr + base));
          acc[0] = reduce_op<R>(acc[0], edge_value<C>(v.x, w));
          acc[1] = reduce_op<R>(acc[1], edge_value<C>(v.y, w));
          acc[2] = reduce_op<R>(acc[2], edge_value<C>(v.z, w));
          acc[3] = reduce_op<R>(acc[3], edge_value<C>(v.w, w));
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int64_t c = base + k * kWarp;
          if (c < f) acc[k] = reduce_op<R>(acc[k], edge_value<C>(__ldg(xr + c), w));
        }
      }
    }
  }
  float* yr = y + row * f;
  if (kVec) {
    if (base < f) {
      *reinterpret_cast<float4*>(yr + base) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t c = base + k * kWarp;
      if (c < f) yr[c] = acc[k];
    }
  }
}

template <int R, int C>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, int64_t n,
                   int64_t f, cudaStream_t stream) {
  const int64_t chunks = (f + kChunk - 1) / kChunk;
  const int64_t blocks = (n * chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec) {
    spmm_semiring_kernel<R, C, true><<<grid, kThreadsPerBlock, 0, stream>>>(
        off, idx, w, xv, yv, n, f, chunks);
  } else {
    spmm_semiring_kernel<R, C, false><<<grid, kThreadsPerBlock, 0, stream>>>(
        off, idx, w, xv, yv, n, f, chunks);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_combine(int combine, const void* offsets,
                           const void* indices, const void* weights,
                           const void* x, void* y, int64_t n, int64_t f,
                           cudaStream_t s) {
  switch (combine) {
    case kAdd: return launch<R, kAdd>(offsets, indices, weights, x, y, n, f, s);
    case kLeft: return launch<R, kLeft>(offsets, indices, weights, x, y, n, f, s);
    case kMul: return launch<R, kMul>(offsets, indices, weights, x, y, n, f, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// reduce: 0 = min, 1 = max.  combine: 0 = add, 1 = left, 2 = mul.  x and y
// are fp32 [n, f] row-major.  weights is unread for "left" and may be null;
// n = 0 or f = 0 launches nothing, so the pointers of empty arrays may be
// null too.  Launches on `stream` and returns cudaGetLastError() as an int
// (0 on success).
extern "C" int spmm_semiring(const void* offsets, const void* indices,
                             const void* weights, const void* x, void* y,
                             int64_t n, int64_t f, int reduce, int combine,
                             void* stream) {
  if ((reduce != kMin && reduce != kMax) || combine < kAdd || combine > kMul ||
      n < 0 || f < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || f == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      reduce == kMin
          ? launch_combine<kMin>(combine, offsets, indices, weights, x, y, n, f, s)
          : launch_combine<kMax>(combine, offsets, indices, weights, x, y, n, f, s);
  return static_cast<int>(err);
}
