"""Fused GAT attention aggregation (K6) over a graph's CSC and CSR.

``gat_attention(g, x, s, t)`` is, per destination v and head h,

    e(u→v, h) = LeakyReLU(s[u, h] + t[v, h])
    α(u→v, h) = softmax of e over v's in-edges (one more term, the
                self-loop v→v, where ``self_loops``)
    y[v, h, :] = Σ_u α(u→v, h) · x[u, h, :]

with x float32 [n, H, D] (GAT's projected features W·x) and s, t float32
[n, H] (its logits a_src·W x, a_dst·W x); every stored edge is one term, so
parallel edges count once each, and edge weights are not read.  A vertex
with no term gets 0.  It is differentiable in x, s and t.

It replaces no TPU kernel: the JAX package leaves GAT to XLA as a gather
of [m, H, D] edge rows.  On CUDA tensors each call launches the kernel
``csrc/gat_csr.cu`` (two passes forward, five backward) or raises; tensors
on the CPU take the plain versions ``gat_forward_reference`` and
``gat_backward_reference``, which sum in float64 and round once.  The
forward keeps, per (vertex, head), the softmax's max and denominator, and
the backward recomputes the coefficients from them.  The backward gathers
one row per edge: it reads Δ[v, h] = Σ_u α·<dy[v, h], x[u, h]> as
<dy[v, h], y[v, h]> from the forward's output, which the autograd
Function keeps for it (n·H·D·4 B a layer: 4.9 GB at 4 × 128 over 2.4 M
vertices); one pass over the CSR gathers dy[v] for each edge u→v, sums dx
and ds, and stores each edge's term g = α·LeakyReLU'·(<dy[v], x[u]> − Δ[v])
in an [m, H] scratch (2 GB at H = 4 over 124 M edges); dt sums g over
each vertex's in-edges in the CSC's order, read through the CSR's
``minor_layout`` (an int64 [m] order, kept once per structure).  The
plain backward sums Δ over the edges, so the CPU tests hold the kernel to
that identity.  The kernel takes heads of width D % 4 == 0, at most 128:
``gat_attention`` pads D with zero columns to a multiple of 4 and cuts a
wider head into equal sub-heads that share its logits (the softmax is the
same in each, and the gradients of the shared logits add up), on both
devices, so that the CPU tests run the same shapes.  Rows of more than
``GAT_SPAN`` edges are cut into spans (``csrc/csr_spans.cuh``).  One call,
forward or backward, is one counted launch whatever its passes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cugraph_tpu_torch.kernels.semiring import _fn
from cugraph_tpu_torch.kernels.spmv import check_csr_operands, span_slots

# rows of more than GAT_SPAN edges are folded in spans of that many edges,
# K4's span (spmm.SPMM_SPAN)
GAT_SPAN = 512
# the kernel's widest head: a warp's 32 lanes of float4
GAT_MAX_WIDTH = 128
# kernel launches since import: one per forward call and one per backward
GAT_LAUNCHES = {"forward": 0, "backward": 0}


def _leaky(z, slope):
    return torch.where(z > 0, z, slope * z)


def _leaky_grad(z, slope):
    """LeakyReLU's derivative in z's dtype (a ``torch.where`` over two
    Python floats would round the slope to float32)."""
    return torch.where(z > 0, torch.ones_like(z), slope)


def _edges(csc):
    """(destinations, sources) of the CSC's stored edges, int64."""
    return csc.row_ids(), csc.indices.to(torch.int64)


def _coefficients(csc, s, t, self_loops, slope, m=None):
    """float64 per-edge logits and the softmax's max per (vertex, head)
    (``m`` where given), and the same for the self-loops (None without)."""
    rows, cols = _edges(csc)
    z = s[cols] + t[rows]
    z_self = s + t if self_loops else None
    if m is None:
        m = torch.full_like(s, -torch.inf)
        m.scatter_reduce_(0, rows[:, None].expand_as(z), _leaky(z, slope),
                          "amax")
        if self_loops:
            m = torch.maximum(m, _leaky(z_self, slope))
    return rows, cols, z, z_self, m


def gat_forward_reference(csc, x, s, t, self_loops: bool = False,
                          slope: float = 0.2):
    """Plain version of the forward: y [n, H, D] in ``x``'s dtype, summed in
    float64, and the max and denominator [n, H] kept in float64, so that
    the plain backward's coefficients are the forward's and its gradients
    round once; a vertex with no term gets y = 0, max = denominator = 0."""
    x64, s64, t64 = x.double(), s.double(), t.double()
    rows, cols, z, z_self, m = _coefficients(csc, s64, t64, self_loops, slope)
    p = torch.exp(_leaky(z, slope) - m[rows])
    den = torch.zeros_like(s64).index_add_(0, rows, p)
    y = torch.zeros_like(x64).index_add_(0, rows, p[:, :, None] * x64[cols])
    if self_loops:
        p_self = torch.exp(_leaky(z_self, slope) - m)
        den += p_self
        y += p_self[:, :, None] * x64
    has = den > 0
    y = torch.where(has[:, :, None], y / torch.where(has, den, 1.0)[:, :, None],
                    0.0)
    m = torch.where(has, m, 0.0)
    return y.to(x.dtype), m, den


def _backward_terms(csc, x, s, t, m, den, dy, self_loops, slope):
    """The plain backward's float64 terms: the edges' (rows, cols, z, α,
    dot = <dy[v, h], x[u, h]>), the self-loops' (z, α, dot), Nones
    without, and Δ[v, h] = Σ α·dot over v's terms."""
    x64, dy64 = x.double(), dy.double()
    m64, den64 = m.double(), den.double()
    rows, cols, z, z_self, _ = _coefficients(csc, s.double(), t.double(),
                                             self_loops, slope, m64)
    safe = torch.where(den64 > 0, den64, 1.0)
    alpha = torch.exp(_leaky(z, slope) - m64[rows]) / safe[rows]
    dot = (dy64[rows] * x64[cols]).sum(-1)
    delta = torch.zeros_like(m64).index_add_(0, rows, alpha * dot)
    a_self = dot_self = None
    if self_loops:
        a_self = torch.exp(_leaky(z_self, slope) - m64) / safe
        dot_self = (dy64 * x64).sum(-1)
        delta += a_self * dot_self
    return (rows, cols, z, alpha, dot), (z_self, a_self, dot_self), delta


def gat_backward_reference(csc, x, s, t, m, den, dy, self_loops: bool = False,
                           slope: float = 0.2):
    """Plain version of the backward: (dx, ds, dt) in ``x``'s dtype, the
    coefficients recomputed from the forward's max and denominator, summed
    in float64:

        Δ[v, h] = Σ_u α·<dy[v, h], x[u, h]>
        dlogit(u→v, h) = α·(<dy[v, h], x[u, h]> − Δ[v, h])·LeakyReLU'
        dx[u] = Σ_v α·dy[v],  ds[u] = Σ_v dlogit,  dt[v] = Σ_u dlogit.

    Δ is summed over the edges here, where the kernel reads it as
    <dy[v, h], y[v, h]>, so that the two hold each other to the identity."""
    (rows, cols, z, alpha, dot), (z_self, a_self, dot_self), delta = \
        _backward_terms(csc, x, s, t, m, den, dy, self_loops, slope)
    dy64 = dy.double()
    dlogit = alpha * _leaky_grad(z, slope) * (dot - delta[rows])
    dt = torch.zeros_like(delta).index_add_(0, rows, dlogit)
    ds = torch.zeros_like(delta).index_add_(0, cols, dlogit)
    dx = torch.zeros_like(dy64).index_add_(0, cols,
                                           alpha[:, :, None] * dy64[rows])
    if self_loops:
        d_self = a_self * _leaky_grad(z_self, slope) * (dot_self - delta)
        dt += d_self
        ds += d_self
        dx += a_self[:, :, None] * dy64
    return dx.to(x.dtype), ds.to(x.dtype), dt.to(x.dtype)


def _check(adj, x, s, t):
    """The kernel takes float32; the plain version any float dtype (the
    gradient checks run it in float64)."""
    check_csr_operands(adj.offsets, adj.indices, None, x,
                       torch.float32 if x.is_cuda else x.dtype, x_dim=3)
    for name, v in (("s", s), ("t", t)):
        if v.shape != x.shape[:2] or v.dtype != x.dtype \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous {x.dtype} "
                             f"{tuple(x.shape[:2])} on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _kernel_shape(x):
    n, heads, width = x.shape
    if width % 4 or width > GAT_MAX_WIDTH:
        raise ValueError(f"K6 takes heads of a width that is a multiple of "
                         f"4 up to {GAT_MAX_WIDTH}, got {width}")
    if x.data_ptr() % 16:
        raise ValueError("K6 needs x 16 B aligned")
    return n, heads, width


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_forward(csc, x, s, t, self_loops, slope, span=GAT_SPAN):
    n, heads, width = _kernel_shape(x)
    m = csc.num_edges
    slots = span_slots(m, span)
    y = torch.empty_like(x)
    mx = torch.empty_like(s)
    den = torch.empty_like(s)
    slot_acc = torch.empty(slots * heads * width, dtype=torch.float32,
                           device=x.device)
    slot_ml = torch.empty(slots * 2 * heads, dtype=torch.float32,
                          device=x.device)
    fn = _fn("gat_csr", "gat_csr_forward",
             [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 4
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int64,
                ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(csc.offsets.data_ptr(), csc.indices.data_ptr(),
                 x.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(),
                 mx.data_ptr(), den.data_ptr(), slot_acc.data_ptr(),
                 slot_ml.data_ptr(), n, m, heads, width, int(self_loops),
                 float(slope), span, _stream(x))
    if err != 0:
        raise RuntimeError(f"gat_csr_forward launch failed: CUDA error {err}")
    return y, mx, den


def _launch_backward(g, x, y, s, t, mx, den, dy, self_loops, slope,
                     span=GAT_SPAN):
    n, heads, width = _kernel_shape(x)
    if y.shape != x.shape or y.dtype != x.dtype or not y.is_contiguous() \
            or y.data_ptr() % 16:
        raise ValueError(f"K6's backward needs the forward's output, "
                         f"contiguous {x.dtype} {tuple(x.shape)} 16 B "
                         f"aligned, got {y.dtype} {tuple(y.shape)}")
    m = g.csr.num_edges
    slots = span_slots(m, span)
    dx = torch.empty_like(x)
    ds = torch.empty_like(s)
    dt = torch.empty_like(s)
    delta = torch.empty_like(s)

    def scratch(numel):
        return torch.empty(numel, dtype=torch.float32, device=x.device)

    edge_g = scratch(m * heads)
    slot_dx = scratch(slots * heads * width)
    slot_ds = scratch(slots * heads)
    order = g.csr.minor_layout[0]  # the CSR position of each CSC edge
    fn = _fn("gat_csr", "gat_csr_backward",
             [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 4
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int64,
                ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(g.csc.offsets.data_ptr(), order.data_ptr(),
                 g.csr.offsets.data_ptr(), g.csr.indices.data_ptr(),
                 x.data_ptr(), y.data_ptr(), dy.data_ptr(), s.data_ptr(),
                 t.data_ptr(), mx.data_ptr(), den.data_ptr(),
                 delta.data_ptr(), dt.data_ptr(), dx.data_ptr(),
                 ds.data_ptr(), edge_g.data_ptr(), slot_dx.data_ptr(),
                 slot_ds.data_ptr(), n, m, heads, width, int(self_loops),
                 float(slope), span, _stream(x))
    if err != 0:
        raise RuntimeError(f"gat_csr_backward launch failed: CUDA error "
                           f"{err}")
    return dx, ds, dt


def _forward(g, x, s, t, self_loops, slope):
    """(y, max, denominator): one counted K6 launch on a CUDA tensor, the
    plain version on the CPU."""
    _check(g.csc, x, s, t)
    if x.device.type == "cuda":
        out = _launch_forward(g.csc, x, s, t, self_loops, slope)
        GAT_LAUNCHES["forward"] += 1
        return out
    if x.device.type == "cpu":
        return gat_forward_reference(g.csc, x, s, t, self_loops, slope)
    raise ValueError(f"no gat_attention for device {x.device}")


def _backward(g, x, y, s, t, mx, den, dy, self_loops, slope):
    """(dx, ds, dt): one counted K6 backward launch on a CUDA tensor, which
    reads Δ from the forward's output y; the plain version on the CPU,
    which sums Δ over the edges and leaves y unread."""
    _check(g.csr, dy, s, t)
    if x.device.type == "cuda":
        out = _launch_backward(g, x, y, s, t, mx, den, dy, self_loops, slope)
        GAT_LAUNCHES["backward"] += 1
        return out
    return gat_backward_reference(g.csc, x, s, t, mx, den, dy, self_loops,
                                  slope)


class _GatAttention(torch.autograd.Function):
    """y = K6(x, s, t) over ``g``'s CSC; its backward K6's three steps, Δ
    from the saved y, then over the CSR, then over the CSC."""

    @staticmethod
    def forward(ctx, x, s, t, g, self_loops, slope):
        if x.is_cuda and any(ctx.needs_input_grad[:3]):
            # the backward reads the CSR's minor_layout: built here, its
            # sort's scratch (~5 GB at 124 M edges) does not add to the
            # first backward's peak, when every layer's activations are held
            g.csr.minor_layout  # kept at first use
        y, mx, den = _forward(g, x, s, t, self_loops, slope)
        ctx.save_for_backward(x, y, s, t, mx, den)
        ctx.g, ctx.self_loops, ctx.slope = g, self_loops, slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, s, t, mx, den = ctx.saved_tensors
        # autograd may hand over an expanded or strided gradient, which
        # the kernel's operand check refuses
        dx, ds, dt = _backward(ctx.g, x, y, s, t, mx, den, dy.contiguous(),
                               ctx.self_loops, ctx.slope)
        return dx, ds, dt, None, None, None


def gat_attention(g, x, s, t, *, self_loops: bool = False,
                  negative_slope: float = 0.2):
    """K6 over the GraphStructure ``g`` (its CSC forward, its CSR in the
    backward): y [n, H, D] in ``x``'s dtype, differentiable in x [n, H, D]
    and the logits s, t [n, H].  Heads wider than the kernel's, or of a
    width that is not a multiple of 4, are padded and cut here (see the
    module's note)."""
    n, heads, width = x.shape
    parts = -(-width // GAT_MAX_WIDTH)  # sub-heads per head
    sub = -(-width // (4 * parts)) * 4
    if parts == 1 and sub == width:
        return _GatAttention.apply(x.contiguous(), s.contiguous(),
                                   t.contiguous(), g, self_loops,
                                   negative_slope)
    xp = F.pad(x, (0, parts * sub - width)).reshape(n, heads * parts, sub)
    y = _GatAttention.apply(xp.contiguous(),
                            s.repeat_interleave(parts, dim=1).contiguous(),
                            t.repeat_interleave(parts, dim=1).contiguous(),
                            g, self_loops, negative_slope)
    return y.reshape(n, heads, parts * sub)[..., :width]
