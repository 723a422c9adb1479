"""Sum SpMM (K4) and min/max semiring SpMM (K5) over one CSR.

``spmm_csr`` is Y[r, :] = sum over row r's edges of w·X[indices[e], :],
the counterpart of the sum path of the TPU kernel
``cugraph_tpu/kernels/spmm_onehot.py::_kernel`` (reduce="sum").
``spmm_semiring`` is Y[r, :] = min/max over row r's edges of
COMBINE(w, X[indices[e], :]), the counterpart of its min/max path.  X and
Y are float32 [num_rows, F], row-major, any F >= 1.  On CUDA tensors each
launches its hand-written kernel (``csrc/spmm_csr.cu``,
``csrc/spmm_semiring.cu``) or raises; only tensors on the CPU take the
plain versions ``spmm_csr_reference`` and ``spmm_semiring_reference``.
K5 and its plain version are exact, so they agree bit for bit, except
that a NaN result is the canonical NaN in the kernel and the input's NaN
in the plain version; K4 and its plain version both sum in float64 and
round once, in another order.  K4 and K5 split rows of more than
``SPMM_SPAN`` and ``SPMM_SEMIRING_SPAN`` edges into spans
(``csrc/csr_spans.cuh``); a call, two passes on the stream, is one
counted launch.

``make_spmm_pair`` makes K4 differentiable, the counterpart of the
``jax.custom_vjp`` of the same name (``spmm_onehot.py:529-547``): the
forward is K4 over one CSR, the backward K4 over its transpose.
"""

from __future__ import annotations

import ctypes

import torch

from cugraph_tpu_torch.kernels.semiring import (BIG, REDUCES, _fn, _row_ids,
                                                order_signed_zeros)
from cugraph_tpu_torch.kernels.spmv import check_csr_operands, span_slots

# combine codes of spmm_semiring.cu; the JAX kernel has no "right" arm here
SPMM_COMBINES = {"add": 0, "left": 1, "mul": 2}
# the plain versions gather [m, F_chunk] edge rows; F is cut into chunks
# that keep that temporary near 2 GB (a [m, 128] gather is 8-16 GB at
# RMAT-20)
_CHUNK_BYTES = 2 << 30

# K4: rows of more than SPMM_SPAN edges are summed in spans of that many
# edges; chosen on the card among 256-2048 (PERF.md, chip_smoke.py's sweep)
SPMM_SPAN = 512
# K5: the same for min/max, chosen on the card among 256-2048 for (min,
# add) at F = 128 over the undirected RMAT-20 CSC (PERF.md, chip_smoke.py's
# sweep)
SPMM_SEMIRING_SPAN = SPMM_SPAN

# kernel launches since import, by mode: K4 "weighted" or "unit" (no weight
# array), "weighted_vjp" (the backward of make_spmm_pair), K5
# "<reduce>_<combine>"
SPMM_LAUNCHES = {"weighted": 0, "unit": 0, "weighted_vjp": 0}
SPMM_SEMIRING_LAUNCHES = {f"{r}_{c}": 0 for r in REDUCES
                          for c in SPMM_COMBINES}


def _feature_chunks(num_features, num_edges, itemsize):
    """Column ranges [f0, f1) whose [num_edges, f1 - f0] temporary of
    ``itemsize`` bytes stays under ``_CHUNK_BYTES``."""
    step = max(1, _CHUNK_BYTES // max(1, itemsize * num_edges))
    return [(f0, min(f0 + step, num_features))
            for f0 in range(0, num_features, step)]


def spmm_csr_reference(offsets, indices, weights, x):
    """Plain PyTorch version: expand row ids, gather rows of X in float64,
    scale, ``index_add_``; feature chunks bound the temporary.  The sums
    run in float64, so on the card it is the oracle for the kernel."""
    n, f = offsets.shape[0] - 1, x.shape[1]
    m = indices.shape[0]
    rows = _row_ids(offsets, m)
    idx = indices.to(torch.int64)
    x64 = x.to(torch.float64)
    w64 = None if weights is None else weights.to(torch.float64)[:, None]
    y = torch.empty(n, f, dtype=torch.float32, device=x.device)
    for f0, f1 in _feature_chunks(f, m, 8):
        vals = x64[:, f0:f1].index_select(0, idx)
        if w64 is not None:
            vals.mul_(w64)
        acc = torch.zeros(n, f1 - f0, dtype=torch.float64, device=x.device)
        y[:, f0:f1] = acc.index_add_(0, rows, vals)
    return y


def spmm_semiring_reference(offsets, indices, weights, x, reduce="min",
                            combine="add"):
    """Plain PyTorch version: gather rows of X, combine, clip in float32
    (a NaN stays NaN), ``scatter_reduce_`` with amin/amax onto the
    identity, then order signed zeros; feature chunks bound the
    temporary."""
    n, f = offsets.shape[0] - 1, x.shape[1]
    m = indices.shape[0]
    rows = _row_ids(offsets, m)[:, None]
    idx = indices.to(torch.int64)
    ident = BIG if reduce == "min" else -BIG
    y = torch.empty(n, f, dtype=torch.float32, device=x.device)
    for f0, f1 in _feature_chunks(f, m, 4):
        vals = x[:, f0:f1].index_select(0, idx)
        if combine == "add":
            vals.add_(weights[:, None])
        elif combine == "mul":
            vals.mul_(weights[:, None])
        vals.clamp_(-BIG, BIG)
        chunk_rows = rows.expand(m, f1 - f0)
        acc = torch.full((n, f1 - f0), ident, dtype=torch.float32,
                         device=x.device)
        acc.scatter_reduce_(0, chunk_rows, vals, f"a{reduce}")
        y[:, f0:f1] = order_signed_zeros(acc, chunk_rows, vals, reduce)
    return y


def spmm_scratch_numel(num_edges, num_features, span=SPMM_SPAN):
    """Scratch elements of one K4 call (float64) or K5 call (float32): the
    heavy rows' slots, two per span of ``span`` edges and feature,
    2·ceil(num_edges / span)·num_features; read from the shapes, so no
    count comes back from the card."""
    return span_slots(num_edges, span) * num_features


def _launch(fn, name, offsets, indices, weights, x, scratch_dtype, span,
            *modes):
    """One call of a two-pass SpMM entry point, Y and the slots allocated
    here: fn(offsets, indices, weights, x, y, slots, n, m, F, *modes, span,
    stream)."""
    n, f = x.shape
    m = indices.shape[0]
    y = torch.empty(n, f, dtype=torch.float32, device=x.device)
    partials = torch.empty(spmm_scratch_numel(m, f, span),
                           dtype=scratch_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(offsets.data_ptr(), indices.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 x.data_ptr(), y.data_ptr(), partials.data_ptr(), n, m, f,
                 *modes, span, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return y


def _launch_sum(offsets, indices, weights, x, span):
    fn = _fn("spmm_csr", "spmm_csr_sum",
             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
    return _launch(fn, "spmm_csr_sum", offsets, indices, weights, x,
                   torch.float64, span, int(weights is None))


def _spmm_csr(offsets, indices, weights, x, count_key, span=SPMM_SPAN):
    """K4, one counted launch on a CUDA tensor; a ``span`` other than
    SPMM_SPAN serves the span sweep in ``chip_smoke.py`` and the card tests
    on small heavy-row graphs."""
    check_csr_operands(offsets, indices, weights, x, x_dim=2)
    if x.device.type == "cuda":
        y = _launch_sum(offsets, indices, weights, x, span)
        if y.numel():
            SPMM_LAUNCHES[count_key] += 1
        return y
    if x.device.type == "cpu":
        return spmm_csr_reference(offsets, indices, weights, x)
    raise ValueError(f"no spmm_csr for device {x.device}")


def spmm_csr(offsets, indices, weights, x):
    """Y[r, :] = sum over e in row r of w[e]·X[indices[e], :]; float32
    [num_rows, F].  ``weights=None`` means unit weights, and the kernel
    reads no weight array.  A row with no edges gets 0."""
    return _spmm_csr(offsets, indices, weights, x,
                     "unit" if weights is None else "weighted")


class _SpmmPair(torch.autograd.Function):
    """Y = A·X by K4 over ``fwd``; dX = Aᵀ·dY by K4 over ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return spmm_csr(fwd.offsets, fwd.indices, fwd.weights, x)

    @staticmethod
    def backward(ctx, grad_y):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        bwd = ctx.bwd
        # autograd may hand over an expanded or strided gradient, which
        # the kernel's operand check refuses
        grad_x = _spmm_csr(bwd.offsets, bwd.indices, bwd.weights,
                           grad_y.contiguous(), "weighted_vjp")
        return grad_x, None, None


def make_spmm_pair(fwd, bwd):
    """Differentiable sum SpMM: ``f(X)`` is K4 over the CSR ``fwd`` and its
    backward K4 over ``bwd``, which must hold the transpose of ``fwd``'s
    matrix (for Y = A·X, dX = Aᵀ·dY).  ``fwd`` and ``bwd`` are CsrMatrix
    objects (offsets, indices, weights).  No backward launch is made when
    X needs no gradient."""
    return lambda x: _SpmmPair.apply(x.contiguous(), fwd, bwd)


def get_structure_spmm_fn(g):
    """The differentiable pull SpMM of a GraphStructure, Y[v] = sum over
    in-edges (u, v) of w·X[u]: make_spmm_pair over (CSC, CSR).  Both are
    sorted with a stable sort, the CSC by (dst, src) and the CSR by (src,
    dst) (``core/structure.py``), so CSR row u holds exactly the weights of
    the CSC entries (·, u), parallel edges included: the CSR is the
    transpose, with no array or plan to build."""
    return make_spmm_pair(g.csc, g.csr)


def _launch_semiring(offsets, indices, weights, x, reduce, combine,
                     span=SPMM_SEMIRING_SPAN):
    """One counted K5 launch, with float32 scratch of
    spmm_scratch_numel(m, F, span); a ``span`` other than
    SPMM_SEMIRING_SPAN serves the span sweep in ``chip_smoke.py`` and the
    card tests on small heavy-row graphs."""
    fn = _fn("spmm_semiring", "spmm_semiring",
             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
             + [ctypes.c_int] * 2 + [ctypes.c_int64, ctypes.c_void_p])
    y = _launch(fn, "spmm_semiring", offsets, indices, weights, x,
                torch.float32, span, REDUCES[reduce], SPMM_COMBINES[combine])
    if y.numel():
        SPMM_SEMIRING_LAUNCHES[f"{reduce}_{combine}"] += 1
    return y


def spmm_semiring(offsets, indices, weights, x, reduce="min", combine="add"):
    """Y[r, :] = REDUCE over e in row r of COMBINE(w[e], X[indices[e], :]);
    float32 [num_rows, F].

    ``reduce`` is "min" or "max"; ``combine`` is "add" (x + w), "left" (x;
    ``weights`` may be None) or "mul" (x·w).  Each edge value is clipped to
    [-1e30, 1e30], a NaN edge value (from X or w) makes the result NaN,
    -0.0 orders below +0.0, and a row with no edges gets the identity,
    ±1e30."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {sorted(REDUCES)}, "
                         f"got {reduce!r}")
    if combine not in SPMM_COMBINES:
        raise ValueError(f"combine must be one of {sorted(SPMM_COMBINES)}, "
                         f"got {combine!r}")
    if combine != "left" and weights is None:
        raise ValueError(f"combine={combine!r} needs weights")
    w = None if combine == "left" else weights
    check_csr_operands(offsets, indices, w, x, x_dim=2)
    if x.device.type == "cuda":
        return _launch_semiring(offsets, indices, w, x, reduce, combine)
    if x.device.type == "cpu":
        return spmm_semiring_reference(offsets, indices, w, x, reduce,
                                       combine)
    raise ValueError(f"no spmm_semiring for device {x.device}")
