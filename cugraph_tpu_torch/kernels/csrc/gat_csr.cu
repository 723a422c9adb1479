// Fused GAT attention aggregation (K6) over one CSC and its CSR, for
// Hopper (sm_90a).  Per destination v and head h:
//
//     e(u→v, h) = LeakyReLU(s[u, h] + t[v, h])
//     α(u→v, h) = softmax over v's in-edges (and an implicit self-loop
//                 v→v where asked) of e
//     y[v, h, :] = Σ_u α(u→v, h) · x[u, h, :]
//
// x is fp32 [n, H, D] (the projected features, D % 4 == 0, D <= 128; the
// wrapper kernels/gat.py pads D and splits wider heads), s and t are the
// per-vertex logits [n, H].  Replaces no TPU kernel: the JAX package
// leaves GAT's softmax to XLA as a gather of [m, H, D] edge rows, which is
// 254 GB for one 4 × 128 layer over ogbn-products' ~124 M stored edges.
// This kernel writes no per-edge array: the forward keeps, per (v, h),
// the softmax's max and denominator, and the backward recomputes the
// coefficients from them.
//
// Bound: bytes.  Counting each input once and each output once, the
// forward moves 4 (n + 1) + 4 m + 4 n (2 H D + 4 H) bytes; the gathers
// read a 4 H D B row of x per stored edge (2 KB at H·D = 512), against an
// x far larger than the 50 MB L2, as K4's (spmm_csr.cu) do.
//
// Layout.  A warp owns one (row, chunk): a chunk is hpc = min(8,
// max(1, 128 / D)) whole heads, and each active lane one float4 of it, so
// a lane's four features lie in one head.  Rows of more than `span` edges
// are cut into spans as K4 cuts them (csr_spans.cuh): a span pass folds
// each heavy row's piece of a span into a slot, a row pass folds light
// rows whole and merges a heavy row's slots in span order.
//
// Forward (gat_fwd_*): FlashAttention's online softmax, a batch of 32
// edges at a time.  Lane j computes edge j's logit for each head of the
// chunk; a warp max gives the batch's max, the running max moves to it,
// the lanes' state (max, denominator, accumulator) is rescaled, and the
// batch's coefficients go to shared memory, from where the fold reads
// them while it gathers x rows through a cp.async ring, 8 rows in flight
// (csr_gather.cuh's helpers).  Slots hold (accumulator, max, denominator)
// and merge as the online softmax does.
//
// Backward (gat_bwd_*), two passes, one per order, no atomics:
//   - over the CSC (gat_bwd_dst_*): per in-edge, dot = <dout[v, h],
//     x[u, h]> (a sum over the head's lanes, segmented shuffles), and
//     Δ[v, h] = Σ α dot (= <dout[v, h], y[v, h]>, FlashAttention's D),
//     A1 = Σ α f dot, A2 = Σ α f, with f the LeakyReLU slope at the
//     edge; dt[v, h] = A1 − Δ·A2 = Σ α f (dot − Δ);
//   - over the CSR (gat_bwd_src_*): per out-edge u→v, dx[u] += α dout[v]
//     and ds[u, h] += α f (dot − Δ[v, h]).
// The self-loop is one more term of each sum.  Every float sum runs in a
// fixed order, so two launches give bit-identical output.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "csr_gather.cuh"
#include "csr_spans.cuh"

namespace {

using csr_gather::kDepth;
using csr_gather::kFull;
using csr_gather::kWarp;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxHeads = 8;  // heads per chunk
constexpr int kPad = kWarp + 1;  // coefficient rows, padded off one bank

struct Shape {
  int64_t n, m, heads, width, hpc, chunks, span;
  float slope;
};

// What a lane owns of its warp's chunk.
struct Lane {
  int lane;
  int mine;        // its head within the chunk; nh where it owns none
  int64_t head;    // its head in the row
  int64_t col;     // its first feature in the row of H·D
  int seg_end;     // one past the last lane of its head
  bool active, head_start;
  int64_t h0;      // the chunk's first head
  int nh;          // heads in the chunk
};

__device__ __forceinline__ Lane lane_of(const Shape& sh, int64_t chunk) {
  Lane L;
  L.lane = threadIdx.x % kWarp;
  L.h0 = chunk * sh.hpc;
  const int64_t left = sh.heads - L.h0;
  L.nh = static_cast<int>(left < sh.hpc ? left : sh.hpc);
  const int per_head = static_cast<int>(sh.width / 4);
  L.active = L.lane < L.nh * per_head;
  L.mine = L.active ? L.lane / per_head : L.nh;
  L.head = L.h0 + L.mine;
  L.col = L.h0 * sh.width + 4 * L.lane;
  L.seg_end = L.active ? (L.mine + 1) * per_head : L.lane + 1;
  L.head_start = L.active && L.lane % per_head == 0;
  return L;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.0f ? z : slope * z;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The sum over all lanes, in one fixed tree, the same value in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// The sum over the lanes of each head, complete in the head's first lane:
// lane i adds lane i + o's partial only inside its own head, so each
// partial holds lanes of one head alone.
__device__ __forceinline__ float head_sum(float v, const Lane& L) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_down_sync(kFull, v, o);
    if (L.lane + o < L.seg_end) v += u;
  }
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Calls fold(j, x4) for each edge j < count of a batch, in order, with
// x4 = row[idx_j] at the lane's column, 8 rows in flight through the
// warp's cp.async ring (csr_gather.cuh's schedule: one commit group per
// edge, so that wait_group(kDepth - 1) means "edge j has landed").
template <typename Fold>
__device__ __forceinline__ void gather_batch(const float* __restrict__ rows,
                                             int64_t row_len, int32_t my_idx,
                                             int count, const Lane& L,
                                             float4* ring, Fold fold) {
  auto prefetch = [&](int j) {
    if (j < count) {
      const int64_t r = __shfl_sync(kFull, my_idx, j);
      if (L.active) {
        csr_gather::cp_async16(ring + (j % kDepth) * kWarp + L.lane,
                               rows + r * row_len + L.col);
      }
    }
    csr_gather::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kDepth - 1; ++j) prefetch(j);
  for (int j = 0; j < count; ++j) {
    prefetch(j + kDepth - 1);
    csr_gather::cp_async_wait<kDepth - 1>();
    fold(j, ring[(j % kDepth) * kWarp + L.lane]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdState {
  float m, l;  // running max and denominator of the lane's head
  float4 acc;
};

__device__ __forceinline__ FwdState fwd_start(const Shape& sh, const Lane& L,
                                              int64_t v, bool self_loop,
                                              const float* x, const float* s,
                                              const float* t) {
  FwdState st{-INFINITY, 0.0f, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (self_loop && L.active) {
    st.m = leaky(s[v * sh.heads + L.head] + t[v * sh.heads + L.head],
                 sh.slope);
    st.l = 1.0f;
    st.acc = load4(x + v * sh.heads * sh.width + L.col);
  }
  return st;
}

// Folds edges [begin, end) of row v into the state.
__device__ void fwd_fold(const Shape& sh, const Lane& L, int64_t v,
                         int64_t begin, int64_t end,
                         const int32_t* __restrict__ indices,
                         const float* __restrict__ x,
                         const float* __restrict__ s,
                         const float* __restrict__ t, float (*coef)[kPad],
                         float4* ring, FwdState& st) {
  const int64_t row_len = sh.heads * sh.width;
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int count = end - e0 < kWarp ? static_cast<int>(end - e0) : kWarp;
    const bool mine_edge = L.lane < count;
    const int32_t my_u = mine_edge ? __ldg(indices + e0 + L.lane) : 0;
    float scale = 1.0f;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= L.nh) break;  // warp-uniform
      const int64_t h = L.h0 + hh;
      const float tv = __ldg(t + v * sh.heads + h);
      const float e = mine_edge ? leaky(__ldg(s + my_u * sh.heads + h) + tv,
                                        sh.slope)
                                : -INFINITY;
      const int first = hh * static_cast<int>(sh.width / 4);
      const float m_old = __shfl_sync(kFull, st.m, first);
      const float m_new = fmaxf(m_old, warp_max(e));
      const float p = mine_edge ? expf(e - m_new) : 0.0f;
      coef[hh][L.lane] = p;
      const float batch = warp_sum(p);
      if (hh == L.mine) {
        scale = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        st.l = st.l * scale + batch;
        st.m = m_new;
      }
    }
    st.acc.x *= scale;
    st.acc.y *= scale;
    st.acc.z *= scale;
    st.acc.w *= scale;
    __syncwarp();
    gather_batch(x, row_len, my_u, count, L, ring, [&](int j, float4 r) {
      if (L.active) {
        const float w = coef[L.mine][j];
        st.acc.x = fmaf(w, r.x, st.acc.x);
        st.acc.y = fmaf(w, r.y, st.acc.y);
        st.acc.z = fmaf(w, r.z, st.acc.z);
        st.acc.w = fmaf(w, r.w, st.acc.w);
      }
    });
    __syncwarp();
  }
}

// Merges a slot (max, denominator, accumulator) into the state.
__device__ __forceinline__ void fwd_merge(FwdState& st, float m, float l,
                                          float4 acc) {
  if (l == 0.0f) return;
  const float m_new = fmaxf(st.m, m);
  const float a = st.m == -INFINITY ? 0.0f : expf(st.m - m_new);
  const float b = expf(m - m_new);
  st.acc.x = st.acc.x * a + acc.x * b;
  st.acc.y = st.acc.y * a + acc.y * b;
  st.acc.z = st.acc.z * a + acc.z * b;
  st.acc.w = st.acc.w * a + acc.w * b;
  st.l = st.l * a + l * b;
  st.m = m_new;
}

__global__ void __launch_bounds__(kThreads)
gat_fwd_span_pass(Shape sh, const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ t, float* __restrict__ slot_acc,
                  float* __restrict__ slot_ml) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float coef[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= (sh.m + sh.span - 1) / sh.span * sh.chunks) return;
  const int64_t sp = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, sh.n, sh.m, sh.span, sp, piece);
  const int64_t row_len = sh.heads * sh.width;
  for (int slot = 0; slot < 2; ++slot) {
    if (piece[slot].begin == piece[slot].end) continue;
    FwdState st{-INFINITY, 0.0f, make_float4(0.f, 0.f, 0.f, 0.f)};
    fwd_fold(sh, L, piece[slot].row, piece[slot].begin, piece[slot].end,
             indices, x, s, t, coef[w], ring[w], st);
    const int64_t k = 2 * sp + slot;
    if (L.active) {
      *reinterpret_cast<float4*>(slot_acc + k * row_len + L.col) = st.acc;
    }
    if (L.head_start) {
      slot_ml[k * 2 * sh.heads + L.head] = st.m;
      slot_ml[k * 2 * sh.heads + sh.heads + L.head] = st.l;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gat_fwd_row_pass(Shape sh, const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ indices,
                 const float* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ t,
                 const float* __restrict__ slot_acc,
                 const float* __restrict__ slot_ml, int self_loop,
                 float* __restrict__ y, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float coef[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= sh.n * sh.chunks) return;
  const int64_t v = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  const int64_t begin = __ldg(offsets + v);
  const int64_t end = __ldg(offsets + v + 1);
  const int64_t row_len = sh.heads * sh.width;
  FwdState st = fwd_start(sh, L, v, self_loop != 0, x, s, t);
  if (end - begin > sh.span) {
    for (int64_t sp = begin / sh.span; sp <= (end - 1) / sh.span; ++sp) {
      const int64_t k = 2 * sp + csr_spans::slot_of(begin, sh.span, sp);
      if (L.active) {
        fwd_merge(st, slot_ml[k * 2 * sh.heads + L.head],
                  slot_ml[k * 2 * sh.heads + sh.heads + L.head],
                  load4(slot_acc + k * row_len + L.col));
      }
    }
  } else {
    fwd_fold(sh, L, v, begin, end, indices, x, s, t, coef[w], ring[w], st);
  }
  if (L.active) {
    const bool any = st.l > 0.0f;
    const float4 out = any ? make_float4(st.acc.x / st.l, st.acc.y / st.l,
                                         st.acc.z / st.l, st.acc.w / st.l)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(y + v * row_len + L.col) = out;
    if (L.head_start) {
      m_out[v * sh.heads + L.head] = any ? st.m : 0.0f;
      l_out[v * sh.heads + L.head] = st.l;
    }
  }
}

// ---------------------------------------------------------------------------
// backward over the CSC: Δ and dt
// ---------------------------------------------------------------------------

struct DstSums {
  float delta, a1, a2;  // Σ α dot, Σ α f dot, Σ α f (head-start lanes)
};

__device__ __forceinline__ void dst_self(const Shape& sh, const Lane& L,
                                         int64_t v, const float* x,
                                         const float* s,
                                         const float* t, const float* mx,
                                         const float* den, float4 g,
                                         DstSums& acc) {
  const int64_t vh = v * sh.heads + L.head;
  const float4 xv = L.active ? load4(x + v * sh.heads * sh.width + L.col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  const float dot = head_sum(L.active ? dot4(g, xv) : 0.0f, L);
  if (L.head_start) {
    const float z = s[vh] + t[vh];
    const float alpha = expf(leaky(z, sh.slope) - mx[vh]) / den[vh];
    const float af = alpha * (z > 0.0f ? 1.0f : sh.slope);
    acc.delta += alpha * dot;
    acc.a1 += af * dot;
    acc.a2 += af;
  }
}

__device__ void dst_fold(const Shape& sh, const Lane& L, int64_t v,
                         int64_t begin, int64_t end,
                         const int32_t* __restrict__ indices,
                         const float* __restrict__ x,
                         const float* __restrict__ s,
                         const float* __restrict__ t,
                         const float* __restrict__ mx,
                         const float* __restrict__ den, float4 g,
                         float (*ca)[kPad], float (*cf)[kPad], float4* ring,
                         DstSums& acc) {
  const int64_t row_len = sh.heads * sh.width;
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int count = end - e0 < kWarp ? static_cast<int>(end - e0) : kWarp;
    const bool mine_edge = L.lane < count;
    const int32_t my_u = mine_edge ? __ldg(indices + e0 + L.lane) : 0;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= L.nh) break;
      const int64_t vh = v * sh.heads + L.h0 + hh;
      if (mine_edge) {
        const float z = __ldg(s + my_u * sh.heads + L.h0 + hh) + __ldg(t + vh);
        const float alpha = expf(leaky(z, sh.slope) - __ldg(mx + vh)) /
                            __ldg(den + vh);
        ca[hh][L.lane] = alpha;
        cf[hh][L.lane] = alpha * (z > 0.0f ? 1.0f : sh.slope);
      }
    }
    __syncwarp();
    gather_batch(x, row_len, my_u, count, L, ring, [&](int j, float4 r) {
      const float dot = head_sum(L.active ? dot4(g, r) : 0.0f, L);
      if (L.head_start) {
        const float af = cf[L.mine][j];
        acc.delta += ca[L.mine][j] * dot;
        acc.a1 += af * dot;
        acc.a2 += af;
      }
    });
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_dst_span_pass(Shape sh, const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ indices,
                      const float* __restrict__ x,
                      const float* __restrict__ dout,
                      const float* __restrict__ s,
                      const float* __restrict__ t,
                      const float* __restrict__ mx,
                      const float* __restrict__ den,
                      float* __restrict__ slot) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float ca[kWarps][kMaxHeads][kPad];
  __shared__ float cf[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= (sh.m + sh.span - 1) / sh.span * sh.chunks) return;
  const int64_t sp = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, sh.n, sh.m, sh.span, sp, piece);
  for (int k = 0; k < 2; ++k) {
    if (piece[k].begin == piece[k].end) continue;
    const int64_t v = piece[k].row;
    const float4 g = L.active
                         ? load4(dout + v * sh.heads * sh.width + L.col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    DstSums acc{0.f, 0.f, 0.f};
    dst_fold(sh, L, v, piece[k].begin, piece[k].end, indices, x, s, t, mx,
             den, g, ca[w], cf[w], ring[w], acc);
    if (L.head_start) {
      float* out = slot + (2 * sp + k) * 3 * sh.heads;
      out[L.head] = acc.delta;
      out[sh.heads + L.head] = acc.a1;
      out[2 * sh.heads + L.head] = acc.a2;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_dst_row_pass(Shape sh, const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ x,
                     const float* __restrict__ dout,
                     const float* __restrict__ s,
                     const float* __restrict__ t,
                     const float* __restrict__ mx,
                     const float* __restrict__ den,
                     const float* __restrict__ slot, int self_loop,
                     float* __restrict__ dt, float* __restrict__ delta) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float ca[kWarps][kMaxHeads][kPad];
  __shared__ float cf[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= sh.n * sh.chunks) return;
  const int64_t v = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  const int64_t begin = __ldg(offsets + v);
  const int64_t end = __ldg(offsets + v + 1);
  const float4 g = L.active ? load4(dout + v * sh.heads * sh.width + L.col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  DstSums acc{0.f, 0.f, 0.f};
  if (self_loop) dst_self(sh, L, v, x, s, t, mx, den, g, acc);
  if (end - begin > sh.span) {
    for (int64_t sp = begin / sh.span; sp <= (end - 1) / sh.span; ++sp) {
      const float* in =
          slot + (2 * sp + csr_spans::slot_of(begin, sh.span, sp)) * 3 * sh.heads;
      if (L.head_start) {
        acc.delta += in[L.head];
        acc.a1 += in[sh.heads + L.head];
        acc.a2 += in[2 * sh.heads + L.head];
      }
    }
  } else {
    dst_fold(sh, L, v, begin, end, indices, x, s, t, mx, den, g, ca[w],
             cf[w], ring[w], acc);
  }
  if (L.head_start) {
    dt[v * sh.heads + L.head] = acc.a1 - acc.delta * acc.a2;
    delta[v * sh.heads + L.head] = acc.delta;
  }
}

// ---------------------------------------------------------------------------
// backward over the CSR: dx and ds
// ---------------------------------------------------------------------------

struct SrcSums {
  float4 dx;
  float ds;  // head-start lanes
};

__device__ __forceinline__ void src_self(const Shape& sh, const Lane& L,
                                         int64_t u, const float* dout,
                                         const float* s, const float* t,
                                         const float* mx, const float* den,
                                         const float* delta, float4 xu,
                                         SrcSums& acc) {
  const int64_t uh = u * sh.heads + L.head;
  const float4 g = L.active ? load4(dout + u * sh.heads * sh.width + L.col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  float alpha = 0.0f, slope = 1.0f;
  if (L.active) {
    const float z = s[uh] + t[uh];
    alpha = expf(leaky(z, sh.slope) - mx[uh]) / den[uh];
    slope = z > 0.0f ? 1.0f : sh.slope;
  }
  acc.dx.x = fmaf(alpha, g.x, acc.dx.x);
  acc.dx.y = fmaf(alpha, g.y, acc.dx.y);
  acc.dx.z = fmaf(alpha, g.z, acc.dx.z);
  acc.dx.w = fmaf(alpha, g.w, acc.dx.w);
  const float dot = head_sum(L.active ? dot4(g, xu) : 0.0f, L);
  if (L.head_start) acc.ds += alpha * slope * (dot - delta[uh]);
}

__device__ void src_fold(const Shape& sh, const Lane& L, int64_t u,
                         int64_t begin, int64_t end,
                         const int32_t* __restrict__ indices,
                         const float* __restrict__ dout,
                         const float* __restrict__ s,
                         const float* __restrict__ t,
                         const float* __restrict__ mx,
                         const float* __restrict__ den,
                         const float* __restrict__ delta, float4 xu,
                         float (*ca)[kPad], float (*cf)[kPad],
                         float (*cd)[kPad], float4* ring, SrcSums& acc) {
  const int64_t row_len = sh.heads * sh.width;
  for (int64_t e0 = begin; e0 < end; e0 += kWarp) {
    const int count = end - e0 < kWarp ? static_cast<int>(end - e0) : kWarp;
    const bool mine_edge = L.lane < count;
    const int32_t my_v = mine_edge ? __ldg(indices + e0 + L.lane) : 0;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= L.nh) break;
      if (mine_edge) {
        const int64_t vh = my_v * sh.heads + L.h0 + hh;
        const float z = __ldg(s + u * sh.heads + L.h0 + hh) + __ldg(t + vh);
        const float alpha = expf(leaky(z, sh.slope) - __ldg(mx + vh)) /
                            __ldg(den + vh);
        ca[hh][L.lane] = alpha;
        cf[hh][L.lane] = alpha * (z > 0.0f ? 1.0f : sh.slope);
        cd[hh][L.lane] = __ldg(delta + vh);
      }
    }
    __syncwarp();
    gather_batch(dout, row_len, my_v, count, L, ring, [&](int j, float4 g) {
      const float alpha = L.active ? ca[L.mine][j] : 0.0f;
      acc.dx.x = fmaf(alpha, g.x, acc.dx.x);
      acc.dx.y = fmaf(alpha, g.y, acc.dx.y);
      acc.dx.z = fmaf(alpha, g.z, acc.dx.z);
      acc.dx.w = fmaf(alpha, g.w, acc.dx.w);
      const float dot = head_sum(L.active ? dot4(g, xu) : 0.0f, L);
      if (L.head_start) acc.ds += cf[L.mine][j] * (dot - cd[L.mine][j]);
    });
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_src_span_pass(Shape sh, const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ indices,
                      const float* __restrict__ x,
                      const float* __restrict__ dout,
                      const float* __restrict__ s,
                      const float* __restrict__ t,
                      const float* __restrict__ mx,
                      const float* __restrict__ den,
                      const float* __restrict__ delta,
                      float* __restrict__ slot_dx,
                      float* __restrict__ slot_ds) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float ca[kWarps][kMaxHeads][kPad];
  __shared__ float cf[kWarps][kMaxHeads][kPad];
  __shared__ float cd[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= (sh.m + sh.span - 1) / sh.span * sh.chunks) return;
  const int64_t sp = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, sh.n, sh.m, sh.span, sp, piece);
  const int64_t row_len = sh.heads * sh.width;
  for (int k = 0; k < 2; ++k) {
    if (piece[k].begin == piece[k].end) continue;
    const int64_t u = piece[k].row;
    const float4 xu = L.active ? load4(x + u * row_len + L.col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    SrcSums acc{make_float4(0.f, 0.f, 0.f, 0.f), 0.0f};
    src_fold(sh, L, u, piece[k].begin, piece[k].end, indices, dout, s, t, mx,
             den, delta, xu, ca[w], cf[w], cd[w], ring[w], acc);
    const int64_t q = 2 * sp + k;
    if (L.active) {
      *reinterpret_cast<float4*>(slot_dx + q * row_len + L.col) = acc.dx;
    }
    if (L.head_start) slot_ds[q * sh.heads + L.head] = acc.ds;
  }
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_src_row_pass(Shape sh, const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ x,
                     const float* __restrict__ dout,
                     const float* __restrict__ s,
                     const float* __restrict__ t,
                     const float* __restrict__ mx,
                     const float* __restrict__ den,
                     const float* __restrict__ delta,
                     const float* __restrict__ slot_dx,
                     const float* __restrict__ slot_ds, int self_loop,
                     float* __restrict__ dx, float* __restrict__ ds) {
  __shared__ float4 ring[kWarps][kDepth * kWarp];
  __shared__ float ca[kWarps][kMaxHeads][kPad];
  __shared__ float cf[kWarps][kMaxHeads][kPad];
  __shared__ float cd[kWarps][kMaxHeads][kPad];
  const int w = threadIdx.x / kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (warp >= sh.n * sh.chunks) return;
  const int64_t u = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  const int64_t begin = __ldg(offsets + u);
  const int64_t end = __ldg(offsets + u + 1);
  const int64_t row_len = sh.heads * sh.width;
  const float4 xu = L.active ? load4(x + u * row_len + L.col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  SrcSums acc{make_float4(0.f, 0.f, 0.f, 0.f), 0.0f};
  if (self_loop) src_self(sh, L, u, dout, s, t, mx, den, delta, xu, acc);
  if (end - begin > sh.span) {
    for (int64_t sp = begin / sh.span; sp <= (end - 1) / sh.span; ++sp) {
      const int64_t q = 2 * sp + csr_spans::slot_of(begin, sh.span, sp);
      if (L.active) {
        const float4 p = load4(slot_dx + q * row_len + L.col);
        acc.dx.x += p.x;
        acc.dx.y += p.y;
        acc.dx.z += p.z;
        acc.dx.w += p.w;
      }
      if (L.head_start) acc.ds += slot_ds[q * sh.heads + L.head];
    }
  } else {
    src_fold(sh, L, u, begin, end, indices, dout, s, t, mx, den, delta, xu,
             ca[w], cf[w], cd[w], ring[w], acc);
  }
  if (L.active) *reinterpret_cast<float4*>(dx + u * row_len + L.col) = acc.dx;
  if (L.head_start) ds[u * sh.heads + L.head] = acc.ds;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool shape_ok(const Shape& sh) {
  return sh.n >= 0 && sh.m >= 0 && sh.heads >= 1 && sh.width >= 4 &&
         sh.width <= 128 && sh.width % 4 == 0 && sh.span >= 1 &&
         sh.hpc >= 1 && sh.hpc <= kMaxHeads && sh.hpc * sh.width <= 128 &&
         sh.chunks == (sh.heads + sh.hpc - 1) / sh.hpc;
}

bool grids(const Shape& sh, unsigned& span_blocks, unsigned& row_blocks) {
  const int64_t sb =
      ((sh.m + sh.span - 1) / sh.span * sh.chunks + kWarps - 1) / kWarps;
  const int64_t rb = (sh.n * sh.chunks + kWarps - 1) / kWarps;
  if (sb > INT_MAX || rb > INT_MAX) return false;
  span_blocks = static_cast<unsigned>(sb);
  row_blocks = static_cast<unsigned>(rb);
  return true;
}

Shape make_shape(int64_t n, int64_t m, int64_t heads, int64_t width,
                 int64_t span, float slope) {
  int64_t hpc = width > 0 ? 128 / width : 0;
  hpc = hpc < 1 ? 1 : (hpc > kMaxHeads ? kMaxHeads : hpc);
  return Shape{n, m, heads, width, hpc, (heads + hpc - 1) / hpc, span, slope};
}

}  // namespace

// Forward.  x fp32 [n, heads, width] row-major and 16 B aligned, width a
// multiple of 4 up to 128; s, t, m_out, l_out fp32 [n, heads]; y fp32
// like x; slot_acc holds 2 ceil(m / span) heads·width floats and slot_ml
// 2 ceil(m / span) · 2 heads (the heavy rows' slots).  Rows with no edges
// and no self-loop get y = 0, m = l = 0.  Launches two kernels on
// `stream`, without a sync; returns cudaGetLastError() as an int.
extern "C" int gat_csr_forward(const void* offsets, const void* indices,
                               const void* x, const void* s, const void* t,
                               void* y, void* m_out, void* l_out,
                               void* slot_acc, void* slot_ml, int64_t n,
                               int64_t m, int64_t heads, int64_t width,
                               int self_loop, float slope, int64_t span,
                               void* stream) {
  const Shape sh = make_shape(n, m, heads, width, span, slope);
  unsigned sb, rb;
  if (!shape_ok(sh) || !grids(sh, sb, rb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* xv = static_cast<const float*>(x);
  const auto* sv = static_cast<const float*>(s);
  const auto* tv = static_cast<const float*>(t);
  if (sb > 0) {
    gat_fwd_span_pass<<<sb, kThreads, 0, st>>>(
        sh, off, idx, xv, sv, tv, static_cast<float*>(slot_acc),
        static_cast<float*>(slot_ml));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gat_fwd_row_pass<<<rb, kThreads, 0, st>>>(
      sh, off, idx, xv, sv, tv, static_cast<const float*>(slot_acc),
      static_cast<const float*>(slot_ml), self_loop, static_cast<float*>(y),
      static_cast<float*>(m_out), static_cast<float*>(l_out));
  return static_cast<int>(cudaGetLastError());
}

// Backward.  csc_* and csr_* are the same edges in the two orders; m_in,
// l_in the forward's; dout like x.  Writes delta and dt [n, heads] over
// the CSC first, then dx (like x) and ds [n, heads] over the CSR.  Slots:
// slot_dst 2 ceil(m / span) · 3 heads floats, slot_dx 2 ceil(m / span)
// heads·width, slot_ds 2 ceil(m / span) heads.  Launches four kernels on
// `stream`, without a sync.
extern "C" int gat_csr_backward(
    const void* csc_offsets, const void* csc_indices, const void* csr_offsets,
    const void* csr_indices, const void* x, const void* dout, const void* s,
    const void* t, const void* m_in, const void* l_in, void* delta, void* dt,
    void* dx, void* ds, void* slot_dst, void* slot_dx, void* slot_ds,
    int64_t n, int64_t m, int64_t heads, int64_t width, int self_loop,
    float slope, int64_t span, void* stream) {
  const Shape sh = make_shape(n, m, heads, width, span, slope);
  unsigned sb, rb;
  if (!shape_ok(sh) || !grids(sh, sb, rb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xv = static_cast<const float*>(x);
  const auto* gv = static_cast<const float*>(dout);
  const auto* sv = static_cast<const float*>(s);
  const auto* tv = static_cast<const float*>(t);
  const auto* mv = static_cast<const float*>(m_in);
  const auto* lv = static_cast<const float*>(l_in);
  const auto* csc_off = static_cast<const int32_t*>(csc_offsets);
  const auto* csc_idx = static_cast<const int32_t*>(csc_indices);
  const auto* csr_off = static_cast<const int32_t*>(csr_offsets);
  const auto* csr_idx = static_cast<const int32_t*>(csr_indices);
  cudaError_t err;
  if (sb > 0) {
    gat_bwd_dst_span_pass<<<sb, kThreads, 0, st>>>(
        sh, csc_off, csc_idx, xv, gv, sv, tv, mv, lv,
        static_cast<float*>(slot_dst));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gat_bwd_dst_row_pass<<<rb, kThreads, 0, st>>>(
      sh, csc_off, csc_idx, xv, gv, sv, tv, mv, lv,
      static_cast<const float*>(slot_dst), self_loop, static_cast<float*>(dt),
      static_cast<float*>(delta));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const auto* dv = static_cast<const float*>(delta);
  if (sb > 0) {
    gat_bwd_src_span_pass<<<sb, kThreads, 0, st>>>(
        sh, csr_off, csr_idx, xv, gv, sv, tv, mv, lv, dv,
        static_cast<float*>(slot_dx), static_cast<float*>(slot_ds));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gat_bwd_src_row_pass<<<rb, kThreads, 0, st>>>(
      sh, csr_off, csr_idx, xv, gv, sv, tv, mv, lv, dv,
      static_cast<const float*>(slot_dx), static_cast<const float*>(slot_ds),
      self_loop, static_cast<float*>(dx), static_cast<float*>(ds));
  return static_cast<int>(cudaGetLastError());
}
