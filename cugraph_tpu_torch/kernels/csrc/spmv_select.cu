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
// kernel carries them as f32, exact below 2^24).
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
// too).
//
// Design: one warp per row, as spmv_csr.cu.  x[r] and the tolerance are
// computed once per lane, the lanes stride over the row's edges, each keeps
// the largest qualifying id, and a butterfly of warp shuffles takes the
// maximum; lane 0 writes y[r].  Ties go to the largest id by construction,
// the max is order-free, and there are no atomics, so two launches give
// bit-identical output.  n = 0 launches nothing.
//
// Bound: bytes.  Every edge costs 8 B (int32 index, fp32 weight; 4 B at
// unit weight), every vertex 4 B each of offsets, x and y.  The x[u] gather
// is random but x fits in the 50 MB L2 at RMAT-20.  The heaviest row sets a
// tail, as in the other warp-per-row kernels; degree segmentation is the
// known fix, not made yet.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kRowsPerBlock = kThreadsPerBlock / kWarp;

enum Mode { kEqselRel = 0, kEqselRelUnit = 1, kEqsel = 2 };

template <int M>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_select_kernel(const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ weights,
                   const float* __restrict__ x,
                   int32_t* __restrict__ y,
                   int64_t n, float atol, float rtol) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warps exit together
  const int64_t begin = offsets[row];
  const int64_t end = offsets[row + 1];
  const float xr = __ldg(x + row);
  // _rn intrinsics: no contraction into an fma, one rounding per operation
  const float tol = __fadd_rn(atol, __fmul_rn(rtol, fabsf(xr)));
  int32_t best = -1;
#pragma unroll 4
  for (int64_t e = begin + lane; e < end; e += kWarp) {
    const int32_t u = __ldg(indices + e);
    bool hit;
    if constexpr (M == kEqsel) {
      hit = __ldg(weights + e) == xr;
    } else {
      const float w = M == kEqselRelUnit ? 1.0f : __ldg(weights + e);
      const float xu = __ldg(x + u);
      hit = fabsf(__fsub_rn(__fadd_rn(xu, w), xr)) <= tol && xu < xr;
    }
    if (hit) best = max(best, u);
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    best = max(best, __shfl_xor_sync(0xffffffffu, best, offset));
  }
  if (lane == 0) y[row] = best;
}

template <int M>
cudaError_t launch(const void* offsets, const void* indices,
                   const void* weights, const void* x, void* y, int64_t n,
                   float atol, float rtol, cudaStream_t stream) {
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmv_select_kernel<M><<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0,
                          stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), static_cast<const float*>(x),
      static_cast<int32_t*>(y), n, atol, rtol);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 = eqsel_rel, 1 = eqsel_rel at unit weight (weights unread, may be
// null), 2 = eqsel (atol and rtol unread).  x is fp32, y int32.  The
// pointers of empty arrays may be null.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int spmv_select(const void* offsets, const void* indices,
                           const void* weights, const void* x, void* y,
                           int64_t n, int mode, float atol, float rtol,
                           void* stream) {
  if (mode < kEqselRel || mode > kEqsel) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kEqselRel:
      return static_cast<int>(launch<kEqselRel>(offsets, indices, weights, x, y, n, atol, rtol, s));
    case kEqselRelUnit:
      return static_cast<int>(launch<kEqselRelUnit>(offsets, indices, weights, x, y, n, atol, rtol, s));
    case kEqsel:
      return static_cast<int>(launch<kEqsel>(offsets, indices, weights, x, y, n, atol, rtol, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
