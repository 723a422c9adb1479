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
// The forward writes no per-edge array: it keeps, per (v, h), the
// softmax's max and denominator, and the backward recomputes the
// coefficients from them.
//
// Bound: bytes.  Counting each input once and each output once, the
// forward moves 4 (n + 1) + 4 m + 4 n (2 H D + 4 H) bytes; the gathers
// read a 4 H D B row of x per stored edge (2 KB at H·D = 512), against an
// x far larger than the 50 MB L2, as K4's (spmm_csr.cu) do.  The backward
// gathers one such row of dout per edge, and writes and reads back 4 H B
// of g per edge.
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
// Backward (gat_bwd_*), one row gather per edge, no atomics, three steps:
//   - gat_bwd_delta: Δ[v, h] = <dout[v, h], y[v, h]> from the forward's
//     output (FlashAttention's D; it equals Σ α <dout[v, h], x[u, h]> over
//     v's terms), a coalesced pass with no gather.  The wrapper keeps y
//     for it: n·H·D·4 B a layer, 4.9 GB at 4 × 128 over 2.4 M vertices;
//   - over the CSR (gat_bwd_src_*): per out-edge u→v, one gather of
//     dout[v]; dot = <dout[v, h], x[u, h]> (a sum over the head's lanes,
//     segmented shuffles) and g(u→v, h) = α f (dot − Δ[v, h]), with f the
//     LeakyReLU slope at the edge; dx[u] = Σ α dout[v] and ds[u, h] = Σ g,
//     and each g is stored at its CSR position in an [m, H] scratch (2 GB
//     at H = 4 over ~124 M edges);
//   - over the CSC (gat_bwd_dt_*): dt[v, h] = Σ g over v's in-edges in
//     CSC order, each read at its CSR position through `order`, the
//     stable sort of the CSR's indices (CsrMatrix.minor_layout), which
//     lists the CSR's edges in (dst, src) order, the CSC's own (parallel
//     edges carry equal g, so their pairing does not matter).  A warp owns
//     (row, group of up to 4 heads); its lanes stride the row's edges and
//     meet in one shuffle tree; heavy rows are cut into spans as above.
// The self-loop is one more term of each sum (the CSR row pass writes its
// g as dt's start).  Every float sum runs in a fixed order, so two
// launches give bit-identical output.

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

// One rounding order wherever it is inlined (no contraction left to the
// compiler), so that Δ = <dout, y> and a self-loop's <dout, x> agree bit
// for bit where y = x.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, __fmul_rn(a.x, b.x))));
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
// backward, step 1: Δ from the forward's output
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gat_bwd_delta(Shape sh, const float* __restrict__ y,
              const float* __restrict__ dout, float* __restrict__ delta) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (warp >= sh.n * sh.chunks) return;
  const int64_t v = warp / sh.chunks;
  const Lane L = lane_of(sh, warp % sh.chunks);
  const int64_t at = v * sh.heads * sh.width + L.col;
  const float dot =
      head_sum(L.active ? dot4(load4(dout + at), load4(y + at)) : 0.0f, L);
  if (L.head_start) delta[v * sh.heads + L.head] = dot;
}

// ---------------------------------------------------------------------------
// backward, step 2, over the CSR: dx, ds and each edge's g
// ---------------------------------------------------------------------------

struct SrcSums {
  float4 dx;
  float ds;  // head-start lanes
};

// Folds the self-loop u→u into the sums; returns its g (head-start lanes).
__device__ __forceinline__ float src_self(const Shape& sh, const Lane& L,
                                          int64_t u, const float* dout,
                                          const float* s, const float* t,
                                          const float* mx, const float* den,
                                          const float* delta, float4 xu,
                                          SrcSums& acc) {
  const int64_t uh = u * sh.heads + L.head;
  const float4 d = L.active ? load4(dout + u * sh.heads * sh.width + L.col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  float alpha = 0.0f, slope = 1.0f;
  if (L.active) {
    const float z = s[uh] + t[uh];
    alpha = expf(leaky(z, sh.slope) - mx[uh]) / den[uh];
    slope = z > 0.0f ? 1.0f : sh.slope;
  }
  acc.dx.x = fmaf(alpha, d.x, acc.dx.x);
  acc.dx.y = fmaf(alpha, d.y, acc.dx.y);
  acc.dx.z = fmaf(alpha, d.z, acc.dx.z);
  acc.dx.w = fmaf(alpha, d.w, acc.dx.w);
  const float dot = head_sum(L.active ? dot4(d, xu) : 0.0f, L);
  float g = 0.0f;
  if (L.head_start) {
    g = alpha * slope * (dot - delta[uh]);
    acc.ds += g;
  }
  return g;
}

// Folds out-edges [begin, end) of row u into the sums and stores each
// edge's g at its CSR position in edge_g [m, heads].  cd holds a batch's
// Δ[v], then its g, which the lanes store together once the batch is
// folded.
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
                         float (*cd)[kPad], float4* ring,
                         float* __restrict__ edge_g, SrcSums& acc) {
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
    gather_batch(dout, row_len, my_v, count, L, ring, [&](int j, float4 d) {
      const float alpha = L.active ? ca[L.mine][j] : 0.0f;
      acc.dx.x = fmaf(alpha, d.x, acc.dx.x);
      acc.dx.y = fmaf(alpha, d.y, acc.dx.y);
      acc.dx.z = fmaf(alpha, d.z, acc.dx.z);
      acc.dx.w = fmaf(alpha, d.w, acc.dx.w);
      const float dot = head_sum(L.active ? dot4(d, xu) : 0.0f, L);
      if (L.head_start) {
        const float g = cf[L.mine][j] * (dot - cd[L.mine][j]);
        acc.ds += g;
        cd[L.mine][j] = g;
      }
    });
    __syncwarp();
    for (int hh = 0; hh < L.nh; ++hh) {
      if (mine_edge) {
        edge_g[(e0 + L.lane) * sh.heads + L.h0 + hh] = cd[hh][L.lane];
      }
    }
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
                      float* __restrict__ edge_g,
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
             den, delta, xu, ca[w], cf[w], cd[w], ring[w], edge_g, acc);
    const int64_t q = 2 * sp + k;
    if (L.active) {
      *reinterpret_cast<float4*>(slot_dx + q * row_len + L.col) = acc.dx;
    }
    if (L.head_start) slot_ds[q * sh.heads + L.head] = acc.ds;
  }
}

// Writes dx and ds, and the self-loop's g (0 without) as dt's start.
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
                     float* __restrict__ edge_g, float* __restrict__ dx,
                     float* __restrict__ ds, float* __restrict__ dt) {
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
  const float g_self =
      self_loop ? src_self(sh, L, u, dout, s, t, mx, den, delta, xu, acc)
                : 0.0f;
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
             ca[w], cf[w], cd[w], ring[w], edge_g, acc);
  }
  if (L.active) *reinterpret_cast<float4*>(dx + u * row_len + L.col) = acc.dx;
  if (L.head_start) {
    ds[u * sh.heads + L.head] = acc.ds;
    dt[u * sh.heads + L.head] = g_self;
  }
}

// ---------------------------------------------------------------------------
// backward, step 3, over the CSC: dt
// ---------------------------------------------------------------------------

constexpr int kDtHeads = 4;  // heads of a dt warp: one float4 of an edge's g

__host__ __device__ __forceinline__ int64_t dt_groups(const Shape& sh) {
  return (sh.heads + kDtHeads - 1) / kDtHeads;
}

// Adds the g of CSC edges [begin, end), heads h0 .. h0 + nh - 1, read at
// their CSR positions order[k], into the lane's sums: lane i takes edges
// begin + i, begin + i + 32, ... in order.
__device__ __forceinline__ void dt_fold(const Shape& sh, int64_t h0, int nh,
                                        int64_t begin, int64_t end,
                                        const long long* __restrict__ order,
                                        const float* __restrict__ edge_g,
                                        float (&acc)[kDtHeads]) {
  for (int64_t k = begin + threadIdx.x % kWarp; k < end; k += kWarp) {
    const float* g = edge_g + __ldg(order + k) * sh.heads + h0;
    if (sh.heads % 4 == 0) {  // every group is four heads, 16 B aligned
      const float4 q = __ldg(reinterpret_cast<const float4*>(g));
      acc[0] += q.x;
      acc[1] += q.y;
      acc[2] += q.z;
      acc[3] += q.w;
    } else {
#pragma unroll
      for (int i = 0; i < kDtHeads; ++i) {
        if (i < nh) acc[i] += __ldg(g + i);
      }
    }
  }
}

// The sums of dt_fold's lanes, in warp_sum's tree: lane i < nh gets head
// h0 + i's.
__device__ __forceinline__ float dt_total(const float (&acc)[kDtHeads]) {
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < kDtHeads; ++i) {
    const float sum = warp_sum(acc[i]);
    if (threadIdx.x % kWarp == i) mine = sum;
  }
  return mine;
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_dt_span_pass(Shape sh, const int32_t* __restrict__ offsets,
                     const long long* __restrict__ order,
                     const float* __restrict__ edge_g,
                     float* __restrict__ slot) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  const int64_t groups = dt_groups(sh);
  if (warp >= (sh.m + sh.span - 1) / sh.span * groups) return;
  const int64_t sp = warp / groups;
  const int64_t h0 = warp % groups * kDtHeads;
  const int nh = static_cast<int>(sh.heads - h0 < kDtHeads ? sh.heads - h0
                                                           : kDtHeads);
  const int lane = threadIdx.x % kWarp;
  csr_spans::Piece piece[2];
  csr_spans::heavy_pieces(offsets, sh.n, sh.m, sh.span, sp, piece);
  for (int k = 0; k < 2; ++k) {
    if (piece[k].begin == piece[k].end) continue;
    float acc[kDtHeads] = {0.f, 0.f, 0.f, 0.f};
    dt_fold(sh, h0, nh, piece[k].begin, piece[k].end, order, edge_g, acc);
    const float sum = dt_total(acc);
    if (lane < nh) slot[(2 * sp + k) * sh.heads + h0 + lane] = sum;
  }
}

// dt[v] = the self-loop's g, which the CSR row pass wrote, + the in-edges'.
__global__ void __launch_bounds__(kThreads)
gat_bwd_dt_row_pass(Shape sh, const int32_t* __restrict__ offsets,
                    const long long* __restrict__ order,
                    const float* __restrict__ edge_g,
                    const float* __restrict__ slot, float* __restrict__ dt) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  const int64_t groups = dt_groups(sh);
  if (warp >= sh.n * groups) return;
  const int64_t v = warp / groups;
  const int64_t h0 = warp % groups * kDtHeads;
  const int nh = static_cast<int>(sh.heads - h0 < kDtHeads ? sh.heads - h0
                                                           : kDtHeads);
  const int lane = threadIdx.x % kWarp;
  const int64_t begin = __ldg(offsets + v);
  const int64_t end = __ldg(offsets + v + 1);
  float sum = 0.0f;
  if (end - begin > sh.span) {
    if (lane < nh) {
      for (int64_t sp = begin / sh.span; sp <= (end - 1) / sh.span; ++sp) {
        sum += slot[(2 * sp + csr_spans::slot_of(begin, sh.span, sp)) *
                        sh.heads + h0 + lane];
      }
    }
  } else {
    float acc[kDtHeads] = {0.f, 0.f, 0.f, 0.f};
    dt_fold(sh, h0, nh, begin, end, order, edge_g, acc);
    sum = dt_total(acc);
  }
  if (lane < nh) {
    const int64_t at = v * sh.heads + h0 + lane;
    dt[at] = dt[at] + sum;
  }
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

// Blocks of kWarps warps for the span passes (a warp per span and `per`)
// and the row passes (a warp per row and `per`); false past INT_MAX.
bool grids(const Shape& sh, int64_t per, unsigned& span_blocks,
           unsigned& row_blocks) {
  const int64_t sb =
      ((sh.m + sh.span - 1) / sh.span * per + kWarps - 1) / kWarps;
  const int64_t rb = (sh.n * per + kWarps - 1) / kWarps;
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
  if (!shape_ok(sh) || !grids(sh, sh.chunks, sb, rb)) {
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

// Backward.  csc_offsets and csc_order (int64 [m]: the CSR position of
// each CSC edge, CsrMatrix.minor_layout's order) with csr_offsets and
// csr_indices, the same edges in the two orders; y the forward's output,
// m_in and l_in its max and denominator; dout like x.  Writes delta
// [n, heads] (Δ = <dout, y>); over the CSR dx (like x), ds [n, heads],
// the self-loop's g as dt's start, and each edge's g in edge_g (m · heads
// floats, at its CSR position); then dt [n, heads] over the CSC.  Slots:
// slot_dx 2 ceil(m / span) heads·width floats, slot_ds 2 ceil(m / span)
// heads, which the dt passes take over once the CSR row pass has read it.
// Launches five kernels on `stream`, without a sync.
extern "C" int gat_csr_backward(
    const void* csc_offsets, const void* csc_order, const void* csr_offsets,
    const void* csr_indices, const void* x, const void* y, const void* dout,
    const void* s, const void* t, const void* m_in, const void* l_in,
    void* delta, void* dt, void* dx, void* ds, void* edge_g, void* slot_dx,
    void* slot_ds, int64_t n, int64_t m, int64_t heads, int64_t width,
    int self_loop, float slope, int64_t span, void* stream) {
  const Shape sh = make_shape(n, m, heads, width, span, slope);
  unsigned sb, rb, dsb, drb;
  if (!shape_ok(sh) || !grids(sh, sh.chunks, sb, rb) ||
      !grids(sh, dt_groups(sh), dsb, drb)) {
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
  const auto* order = static_cast<const long long*>(csc_order);
  const auto* csr_off = static_cast<const int32_t*>(csr_offsets);
  const auto* csr_idx = static_cast<const int32_t*>(csr_indices);
  auto* dv = static_cast<float*>(delta);
  auto* eg = static_cast<float*>(edge_g);
  auto* sds = static_cast<float*>(slot_ds);
  auto* dtv = static_cast<float*>(dt);
  cudaError_t err;
  gat_bwd_delta<<<rb, kThreads, 0, st>>>(sh, static_cast<const float*>(y), gv,
                                         dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (sb > 0) {
    gat_bwd_src_span_pass<<<sb, kThreads, 0, st>>>(
        sh, csr_off, csr_idx, xv, gv, sv, tv, mv, lv, dv, eg,
        static_cast<float*>(slot_dx), sds);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gat_bwd_src_row_pass<<<rb, kThreads, 0, st>>>(
      sh, csr_off, csr_idx, xv, gv, sv, tv, mv, lv, dv,
      static_cast<const float*>(slot_dx), sds, self_loop, eg,
      static_cast<float*>(dx), static_cast<float*>(ds), dtv);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (dsb > 0) {
    gat_bwd_dt_span_pass<<<dsb, kThreads, 0, st>>>(sh, csc_off, order, eg, sds);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gat_bwd_dt_row_pass<<<drb, kThreads, 0, st>>>(sh, csc_off, order, eg, sds,
                                                dtv);
  return static_cast<int>(cudaGetLastError());
}
