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
// Replaces the min/max path of the TPU kernel
// cugraph_tpu/kernels/spmv_onehot.py:565-592 (_kernel with reduce="min"/
// "max"; clip at :576, identity at :415, SEMIRING_BIG at :58).  That kernel
// reduces each dst-sorted lane run with a shifted scan and scatters it with
// one-hot MXU selections, because the TPU has no vector gather or scatter;
// this kernel reads the CSR directly and keeps none of that machinery.
//
// Design: one warp per row, as the sum kernel spmv_csr.cu.  The lanes stride
// over the row's edges, each keeps a partial min/max, and a butterfly of
// warp shuffles combines the 32 partials; lane 0 writes y[r].  Min and max
// are exact and order-free, so there are no atomics and two launches give
// bit-identical output.  n = 0 launches nothing.
//
// Bound: bytes.  Every edge costs 4 B for "left" and "right" (the int32
// index, or the fp32 weight) and 8 B for "add" and "mul", every vertex 4 B
// each of offsets, x and y, against one or two operations per edge.  The x
// gather is random but x fits in the 50 MB L2 at RMAT-20.  As in the sum
// kernel, the heaviest row sets a tail: one warp walks all its edges while
// the other SMs finish, and an undirected vertex's degree is its in- plus
// its out-degree.  Degree-descending renumbering starts the heavy rows
// first; splitting rows by degree segment is the known fix, not made yet.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kRowsPerBlock = kThreadsPerBlock / kWarp;
constexpr float kBig = 1e30f;

enum Reduce { kMin = 0, kMax = 1 };
enum Combine { kAdd = 0, kLeft = 1, kMul = 2, kRight = 3 };

template <typename T, int R>
struct Op;

template <>
struct Op<float, kMin> {
  static __device__ __forceinline__ float identity() { return kBig; }
  static __device__ __forceinline__ float apply(float a, float b) { return fminf(a, b); }
};

template <>
struct Op<float, kMax> {
  static __device__ __forceinline__ float identity() { return -kBig; }
  static __device__ __forceinline__ float apply(float a, float b) { return fmaxf(a, b); }
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

// The edge value; the _rn intrinsics keep nvcc from contracting anything,
// so each operation rounds once, as the plain version's do.
template <typename T, int C>
__device__ __forceinline__ T edge_value(const int32_t* __restrict__ indices,
                                        const float* __restrict__ weights,
                                        const T* __restrict__ x, int64_t e) {
  if constexpr (C == kRight) {
    return __ldg(weights + e);
  } else {
    const T xv = __ldg(x + __ldg(indices + e));
    if constexpr (C == kLeft) {
      return xv;
    } else if constexpr (C == kAdd) {
      return __fadd_rn(xv, __ldg(weights + e));
    } else {
      return __fmul_rn(xv, __ldg(weights + e));
    }
  }
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_semiring_kernel(const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ weights,
                     const T* __restrict__ x,
                     T* __restrict__ y,
                     int64_t n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warps exit together
  const int64_t begin = offsets[row];
  const int64_t end = offsets[row + 1];
  T acc = Op<T, R>::identity();
#pragma unroll 4
  for (int64_t e = begin + lane; e < end; e += kWarp) {
    T v = edge_value<T, C>(indices, weights, x, e);
    if constexpr (std::is_same<T, float>::value) {
      v = fminf(fmaxf(v, -kBig), kBig);  // :576, fp32 only
    }
    acc = Op<T, R>::apply(acc, v);
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc = Op<T, R>::apply(acc, __shfl_xor_sync(0xffffffffu, acc, offset));
  }
  if (lane == 0) y[row] = acc;
}

template <typename T, int R, int C>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, int64_t n,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmv_semiring_kernel<T, R, C><<<static_cast<unsigned>(blocks),
                                  kThreadsPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), static_cast<const T*>(x),
      static_cast<T*>(y), n);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_f32(int combine, const void* offsets, const void* indices,
                       const void* weights, const void* x, void* y, int64_t n,
                       cudaStream_t s) {
  switch (combine) {
    case kAdd: return launch<float, R, kAdd>(offsets, indices, weights, x, y, n, s);
    case kLeft: return launch<float, R, kLeft>(offsets, indices, weights, x, y, n, s);
    case kMul: return launch<float, R, kMul>(offsets, indices, weights, x, y, n, s);
    case kRight: return launch<float, R, kRight>(offsets, indices, weights, x, y, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// reduce: 0 = min, 1 = max.  combine: 0 = add, 1 = left, 2 = mul, 3 = right.
// is_int32: x and y are int32 (combine "left" only), else fp32.  Pointers
// that the mode does not read (weights for "left", x for "right"), and those
// of empty arrays, may be null.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int spmv_semiring(const void* offsets, const void* indices,
                             const void* weights, const void* x, void* y,
                             int64_t n, int reduce, int combine, int is_int32,
                             void* stream) {
  if ((reduce != kMin && reduce != kMax) || combine < kAdd || combine > kRight ||
      (is_int32 && combine != kLeft)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_int32) {
    err = reduce == kMin
        ? launch<int32_t, kMin, kLeft>(offsets, indices, weights, x, y, n, s)
        : launch<int32_t, kMax, kLeft>(offsets, indices, weights, x, y, n, s);
  } else {
    err = reduce == kMin
        ? launch_f32<kMin>(combine, offsets, indices, weights, x, y, n, s)
        : launch_f32<kMax>(combine, offsets, indices, weights, x, y, n, s);
  }
  return static_cast<int>(err);
}
