"""Sum SpMV over one CSR: y[r] = sum over row r's edges of COMBINE(x, w).

``spmv_csr`` is the counterpart of the sum path of the TPU kernel
``cugraph_tpu/kernels/spmv_onehot.py::_kernel`` (reduce="sum", combine
"mul" or "left").  On CUDA tensors it launches the hand-written kernel in
``csrc/spmv_csr.cu`` or raises; only tensors on the CPU take the plain
version ``spmv_csr_reference``.  The kernel splits rows of more than
``SPMV_SPAN`` edges into spans (``csrc/csr_spans.cuh``) and gives the
other rows a group of 4 lanes each; one call is one counted launch.
"""

from __future__ import annotations

import ctypes

import torch

from cugraph_tpu_torch.core.structure import check_edge_count
from cugraph_tpu_torch.kernels import _build

COMBINES = {"mul": 0, "left": 1}
# rows of more than SPMV_SPAN edges are summed in spans of that many edges;
# chosen on the card among 256-4096 (PERF.md, chip_smoke.py's sweep)
SPMV_SPAN = 1024

# kernel launches since import, in total and by combine mode
LAUNCHES = 0
LAUNCHES_BY_COMBINE = {"mul": 0, "left": 0}


def spmv_csr_reference(offsets, indices, weights, x, combine="mul"):
    """Plain PyTorch version: expand row ids, gather, ``index_add_``.  The
    sums run in float64, so on the card it is the oracle for the kernel."""
    n = offsets.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device),
        (offsets[1:] - offsets[:-1]).to(torch.int64),
        output_size=indices.shape[0])
    vals = x.to(torch.float64)[indices.to(torch.int64)]
    if combine == "mul":
        vals = vals * weights.to(torch.float64)
    y = torch.zeros(n, dtype=torch.float64, device=x.device)
    return y.index_add_(0, rows, vals).to(torch.float32)


def check_csr_operands(offsets, indices, weights, x, x_dtype=torch.float32,
                       x_dim=1, *, square=True):
    """The checks every CSR kernel wrapper makes before it passes pointers:
    tensor types and dtypes, 1-D (x ``x_dim``-D, one row per vertex),
    contiguous, one device, and lengths that agree.  ``weights`` may be
    None.  ``square=False`` is the rows-versus-columns form: the CSR holds
    some of the rows of a larger one (a chunk of ``kernels/spill.py``), x
    one entry per column, and the row count is not x's length; the
    kernels read x only through ``indices``."""
    named = [("x", x, x_dtype, x_dim), ("offsets", offsets, torch.int32, 1),
             ("indices", indices, torch.int32, 1)]
    if weights is not None:
        named.append(("weights", weights, torch.float32, 1))
    for name, t, dtype, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if offsets.shape[0] < 1:
        raise ValueError("offsets needs at least one entry")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError("weights and indices differ in length")
    if square and x.shape[0] != offsets.shape[0] - 1:
        raise ValueError(f"x has {x.shape[0]} entries for "
                         f"{offsets.shape[0] - 1} rows")
    check_edge_count(indices.shape[0])


def _check(offsets, indices, weights, x, combine, square=True):
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {sorted(COMBINES)}, "
                         f"got {combine!r}")
    if combine == "mul" and weights is None:
        raise ValueError("combine='mul' needs weights")
    check_csr_operands(offsets, indices, weights, x, square=square)


def span_slots(num_edges, span):
    """Heavy-row slots of one CSR (``csrc/csr_spans.cuh``): two per span of
    ``span`` edges, 2·ceil(num_edges / span); 0 without edges."""
    return 2 * (-(-num_edges // span))


def _kernel_fn():
    fn = _build.load("spmv_csr").spmv_csr_sum
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    return fn


def _launch(offsets, indices, weights, x, combine, span=SPMV_SPAN):
    """One counted launch; a ``span`` other than SPMV_SPAN serves the span
    sweep in ``chip_smoke.py`` and the card tests on small heavy-row
    graphs."""
    global LAUNCHES
    fn = _kernel_fn()
    n, m = offsets.shape[0] - 1, indices.shape[0]
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    partials = torch.empty(span_slots(m, span), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(offsets.data_ptr(), indices.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 x.data_ptr(), y.data_ptr(), partials.data_ptr(), n, m,
                 COMBINES[combine], span, stream)
    if err != 0:
        raise RuntimeError(f"spmv_csr_sum launch failed: CUDA error {err}")
    if n:
        LAUNCHES += 1
        LAUNCHES_BY_COMBINE[combine] += 1
    return y


def spmv_csr(offsets, indices, weights, x, combine="mul", *, square=True):
    """y[r] = sum over e in row r of w[e]·x[indices[e]] ("mul") or
    x[indices[e]] ("left"); float32 [num_rows].  ``weights`` may be None
    for "left".  ``square=False``: x has one entry per column, whatever
    the row count (``check_csr_operands``)."""
    _check(offsets, indices, weights, x, combine, square)
    if x.device.type == "cuda":
        return _launch(offsets, indices, weights, x, combine)
    if x.device.type == "cpu":
        return spmv_csr_reference(offsets, indices, weights, x, combine)
    raise ValueError(f"no spmv_csr for device {x.device}")
