"""Min/max semiring SpMV (K2) and argmax select (K3) over one CSR.

``spmv_semiring`` is y[r] = min/max over row r's edges of COMBINE(x, w),
the counterpart of the min/max path of the TPU kernel
``cugraph_tpu/kernels/spmv_onehot.py::_kernel`` (reduce="min"/"max").
``spmv_select`` is y[r] = the largest id on row r whose edge passes an
equality test, else -1: the counterpart of the same kernel's eqsel and
eqsel_rel modes, with int32 ids where the TPU kernel carries them in f32.
On CUDA tensors each launches its hand-written kernel
(``csrc/spmv_semiring.cu``, ``csrc/spmv_select.cu``) or raises; only tensors
on the CPU take the plain versions ``spmv_semiring_reference`` and
``spmv_select_reference``.  Both kernels and both plain versions are exact,
so they agree bit for bit, except that a NaN result is the canonical NaN
in the kernel and the input's NaN in the plain version.  K2 and K3 split
rows of more than ``SPMV_SEMIRING_SPAN`` and ``SPMV_SELECT_SPAN`` edges
into spans (``csrc/csr_spans.cuh``) and give the other rows a group of 8
lanes each; a call, two passes on the stream, is one counted launch.
"""

from __future__ import annotations

import ctypes

import torch

from cugraph_tpu_torch.kernels import _build
from cugraph_tpu_torch.kernels.spmv import (SPMV_SPAN, check_csr_operands,
                                            span_slots)

# the TPU kernel's finite infinity (spmv_onehot.py:58): edge values are
# clipped to [-BIG, BIG], and a row with no edges gets +BIG (min) or -BIG
BIG = 1e30
INT32_MAX = 2**31 - 1
INT32_MIN = -2**31
# K2: rows of more than SPMV_SEMIRING_SPAN edges are reduced in spans of
# that many edges, the others by 8 lanes each; K1's span, chosen on the
# card among 256-2048 (PERF.md, chip_smoke.py's sweep)
SPMV_SEMIRING_SPAN = SPMV_SPAN
# K3: the same split, with int32 slots; chosen on the card among 256-2048
# (PERF.md, chip_smoke.py's sweep)
SPMV_SELECT_SPAN = 2048

REDUCES = {"min": 0, "max": 1}
COMBINES = {"add": 0, "left": 1, "mul": 2, "right": 3}
SELECT_MODES = ("eqsel_rel", "eqsel")
# the C entry point's mode codes (spmv_select.cu)
_SELECT_CODES = {"eqsel_rel": 0, "eqsel_rel_unit": 1, "eqsel": 2}

# kernel launches since import, by mode: "<reduce>_<combine>" for fp32 and
# "<reduce>_left_i32" for int32 (K2); "eqsel_rel", "eqsel_rel_unit" (no
# weight array) and "eqsel" (K3)
SEMIRING_LAUNCHES = {f"{r}_{c}": 0 for r in REDUCES for c in COMBINES}
SEMIRING_LAUNCHES.update(min_left_i32=0, max_left_i32=0)
SELECT_LAUNCHES = {mode: 0 for mode in _SELECT_CODES}


def _row_ids(offsets, num_edges):
    n = offsets.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=offsets.device),
        (offsets[1:] - offsets[:-1]).to(torch.int64), output_size=num_edges)


def semiring_identity(reduce, dtype):
    if dtype == torch.int32:
        return INT32_MAX if reduce == "min" else INT32_MIN
    return BIG if reduce == "min" else -BIG


def semiring_mode(reduce, combine, dtype):
    """The launch-count key of one K2 mode."""
    return f"{reduce}_{combine}" + ("_i32" if dtype == torch.int32 else "")


def order_signed_zeros(y, rows, vals, reduce):
    """``y`` of ``scatter_reduce_`` amin/amax of ``vals`` by ``rows`` (along
    dim 0) with -0.0 ordered below +0.0: a result that is a zero becomes
    -0.0 for min (+0.0 for max) when any of the row's values is one, as
    IEEE 754 minimum/maximum, the reference's XLA route and the kernels'
    min.NaN/max.NaN order them.  ``scatter_reduce_`` alone keeps whichever
    zero it meets first (on the card, whichever atomic lands last)."""
    neg = reduce == "min"
    hit = (vals == 0) & (torch.signbit(vals) == neg)
    has = torch.zeros_like(y).scatter_reduce_(0, rows, hit.to(y.dtype),
                                              "amax")
    return torch.where((y == 0) & (has > 0), -0.0 if neg else 0.0, y)


def spmv_semiring_reference(offsets, indices, weights, x, reduce="min",
                            combine="left"):
    """Plain PyTorch version: gather the edge values, clip them in fp32
    (a NaN stays NaN), ``scatter_reduce_`` with amin/amax onto the
    identity, then order signed zeros."""
    n = offsets.shape[0] - 1
    idx = indices.to(torch.int64)
    if combine == "right":
        vals = weights
    elif combine == "left":
        vals = x[idx]
    elif combine == "add":
        vals = x[idx] + weights
    else:
        vals = x[idx] * weights
    y = torch.full((n,), semiring_identity(reduce, x.dtype), dtype=x.dtype,
                   device=x.device)
    rows = _row_ids(offsets, idx.shape[0])
    if x.dtype != torch.float32:
        return y.scatter_reduce_(0, rows, vals, f"a{reduce}")
    vals = vals.clamp(-BIG, BIG)
    y.scatter_reduce_(0, rows, vals, f"a{reduce}")
    return order_signed_zeros(y, rows, vals, reduce)


def _check_semiring(offsets, indices, weights, x, reduce, combine,
                    square=True):
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {sorted(REDUCES)}, "
                         f"got {reduce!r}")
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {sorted(COMBINES)}, "
                         f"got {combine!r}")
    if combine != "left" and weights is None:
        raise ValueError(f"combine={combine!r} needs weights")
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 \
            and combine != "left":
        raise TypeError("int32 x takes combine='left' only")
    x_dtype = x.dtype if isinstance(x, torch.Tensor) and x.dtype in (
        torch.int32, torch.float32) else torch.float32
    check_csr_operands(offsets, indices,
                       None if combine == "left" else weights, x, x_dtype,
                       square=square)


def _fn(lib_name, fn_name, argtypes):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _launch_semiring(offsets, indices, weights, x, reduce, combine,
                     span=SPMV_SEMIRING_SPAN):
    """One counted K2 launch, with scratch of span_slots(m, span) elements
    of x's dtype; a ``span`` other than SPMV_SEMIRING_SPAN serves the span
    sweep in ``chip_smoke.py`` and the card tests on small heavy-row
    graphs."""
    fn = _fn("spmv_semiring", "spmv_semiring",
             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_void_p])
    n, m = offsets.shape[0] - 1, indices.shape[0]
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    partials = torch.empty(span_slots(m, span), dtype=x.dtype,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(offsets.data_ptr(), indices.data_ptr(),
                 None if combine == "left" else weights.data_ptr(),
                 None if combine == "right" else x.data_ptr(),
                 y.data_ptr(), partials.data_ptr(), n, m, REDUCES[reduce],
                 COMBINES[combine], int(x.dtype == torch.int32), span,
                 stream)
    if err != 0:
        raise RuntimeError(f"spmv_semiring launch failed: CUDA error {err}")
    if n:
        SEMIRING_LAUNCHES[semiring_mode(reduce, combine, x.dtype)] += 1
    return y


def spmv_semiring(offsets, indices, weights, x, reduce="min", combine="left",
                  *, square=True):
    """y[r] = REDUCE over e in row r of COMBINE(x[indices[e]], w[e]).

    ``reduce`` is "min" or "max"; ``combine`` is "add" (x + w), "left" (x),
    "mul" (x * w) or "right" (w).  x is float32, or int32 with "left";
    ``weights`` may be None for "left".  A row with no edges gets the
    identity: ±1e30 in float32, INT32_MAX/INT32_MIN in int32.  In float32
    each edge value is clipped to [-1e30, 1e30], a NaN edge value (from x
    or w) makes the row's result NaN, and -0.0 orders below +0.0.
    ``square=False``: x has one entry per column, whatever the row count
    (``spmv.check_csr_operands``)."""
    _check_semiring(offsets, indices, weights, x, reduce, combine, square)
    if x.device.type == "cuda":
        return _launch_semiring(offsets, indices, weights, x, reduce, combine)
    if x.device.type == "cpu":
        return spmv_semiring_reference(offsets, indices, weights, x, reduce,
                                       combine)
    raise ValueError(f"no spmv_semiring for device {x.device}")


def _select_mode(mode, weights):
    """The launch-count key of one K3 mode: eqsel_rel without weights runs
    at unit weight and never reads a weight array."""
    return "eqsel_rel_unit" if mode == "eqsel_rel" and weights is None \
        else mode


def spmv_select_reference(offsets, indices, weights, x, mode="eqsel_rel",
                          atol=0.0, rtol=0.0):
    """Plain PyTorch version: the equality test per edge in float32, then
    ``scatter_reduce_`` with amax of the qualifying ids onto -1."""
    n = offsets.shape[0] - 1
    idx = indices.to(torch.int64)
    rows = _row_ids(offsets, idx.shape[0])
    xr = x[rows]
    if mode == "eqsel":
        hit = weights == xr
    else:
        w = 1.0 if weights is None else weights
        tol = _f32(atol, x) + _f32(rtol, x) * xr.abs()
        xu = x[idx]
        hit = ((xu + w - xr).abs() <= tol) & (xu < xr)
    vals = torch.where(hit, indices, torch.full_like(indices, -1))
    y = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    return y.scatter_reduce_(0, rows, vals, "amax", include_self=True)


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _check_select(offsets, indices, weights, x, mode):
    if mode not in SELECT_MODES:
        raise ValueError(f"mode must be one of {sorted(SELECT_MODES)}, "
                         f"got {mode!r}")
    if mode == "eqsel" and weights is None:
        raise ValueError("mode='eqsel' needs weights")
    check_csr_operands(offsets, indices, weights, x)


def _launch_select(offsets, indices, weights, x, mode, atol, rtol,
                   span=SPMV_SELECT_SPAN):
    """One counted K3 launch, with int32 scratch of span_slots(m, span)
    elements; a ``span`` other than SPMV_SELECT_SPAN serves the span sweep
    in ``chip_smoke.py`` and the card tests on small heavy-row graphs."""
    fn = _fn("spmv_select", "spmv_select",
             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
             + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int64, ctypes.c_void_p])
    key = _select_mode(mode, weights)
    n, m = offsets.shape[0] - 1, indices.shape[0]
    y = torch.empty(n, dtype=torch.int32, device=x.device)
    slots = torch.empty(span_slots(m, span), dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(offsets.data_ptr(), indices.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 x.data_ptr(), y.data_ptr(), slots.data_ptr(), n, m,
                 _SELECT_CODES[key], atol, rtol, span, stream)
    if err != 0:
        raise RuntimeError(f"spmv_select launch failed: CUDA error {err}")
    if n:
        SELECT_LAUNCHES[key] += 1
    return y


def spmv_select(offsets, indices, weights, x, mode="eqsel_rel", atol=0.0,
                rtol=0.0):
    """y[r] = the largest indices[e] on row r whose edge passes the test,
    else -1; int32 [num_rows].

    "eqsel_rel": |x[u] + w[e] - x[r]| <= atol + rtol·|x[r]| and
    x[u] < x[r], u = indices[e], in float32 (predecessor recovery; the
    second condition is the port's, see ``csrc/spmv_select.cu``);
    ``weights=None`` means w = 1.  "eqsel": w[e] == x[r]; atol and rtol
    are unread.  A NaN fails every comparison, so an edge whose x[u], x[r]
    or w is NaN is never selected; -0.0 equals +0.0."""
    _check_select(offsets, indices, weights, x, mode)
    if x.device.type == "cuda":
        return _launch_select(offsets, indices, weights, x, mode, atol, rtol)
    if x.device.type == "cpu":
        return spmv_select_reference(offsets, indices, weights, x, mode,
                                     atol, rtol)
    raise ValueError(f"no spmv_select for device {x.device}")
