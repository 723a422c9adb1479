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
// Design: one warp per destination row.  The warp's lanes stride over the
// row's edges, each keeps an fp32 partial sum, and a fixed-order butterfly
// of warp shuffles adds the 32 partials; lane 0 writes y[r].  There are no
// atomics, so two launches on the same inputs give bit-identical output.  A
// zero-degree row writes 0; n = 0 launches nothing.
//
// Bound: bytes.  Every edge costs 8 B (int32 index and fp32 weight; 4 B for
// "left"), every vertex 4 B each of offsets, x and y, against about two flops
// per edge.  The x gather is random but x fits in the 50 MB L2 at RMAT-20.
// The heaviest row sets the tail: one warp walks all of its edges (the top
// vertex of RMAT-20 has ~69k in-edges, ~2.2k strides of 32), while the
// other SMs finish.  Degree-descending renumbering puts the heavy rows at the
// lowest ids, so their warps start first.  Splitting rows by degree segment
// (thread, warp and block per row, as the reference's
// per_v_transform_reduce_e.cuh:252-688) is the known fix for that tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kRowsPerBlock = kThreadsPerBlock / kWarp;

template <bool kMul>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmv_csr_sum_kernel(const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ indices,
                    const float* __restrict__ weights,
                    const float* __restrict__ x,
                    float* __restrict__ y,
                    int64_t n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warps exit together
  const int64_t begin = offsets[row];
  const int64_t end = offsets[row + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t e = begin + lane; e < end; e += kWarp) {
    float v = __ldg(x + __ldg(indices + e));
    if (kMul) v *= __ldg(weights + e);
    acc += v;
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) y[row] = acc;
}

}  // namespace

// combine: 0 = mul, 1 = left (weights unread, may be null).  The pointers of
// empty arrays may be null too.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int spmv_csr_sum(const void* offsets, const void* indices,
                            const void* weights, const void* x, void* y,
                            int64_t n, int combine, void* stream) {
  if (combine != 0 && combine != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (combine == 0) {
    spmv_csr_sum_kernel<true><<<grid, kThreadsPerBlock, 0, s>>>(off, idx, w, xv, yv, n);
  } else {
    spmv_csr_sum_kernel<false><<<grid, kThreadsPerBlock, 0, s>>>(off, idx, w, xv, yv, n);
  }
  return static_cast<int>(cudaGetLastError());
}
