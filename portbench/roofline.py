"""Peaks of one NVIDIA H100 SXM and the least time of the benchmark's work.

Frozen copies: the byte and FLOP counts of one K1 or K4 launch are those of
``chip_smoke.bound_ms`` and ``chip_smoke.spmm_bound_ms``; the GEMM counts
follow from the shapes.  Each least time is the larger of the FLOPs at the
float32 rate (outside the tensor cores, TF32 off) and the bytes at the HBM
rate, with every input read once and every output written once.  Published
dense peaks at the 700 W limit (NVIDIA's data sheet).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def _least_s(flops: float, bytes_moved: float) -> float:
    return max(flops / PEAK_FP32_PER_S, bytes_moved / PEAK_BYTES_PER_S)


def spmv_least_s(n: int, m: int, combine: str = "mul") -> float:
    """One K1 launch over a CSR of ``n`` rows and ``m`` stored edges: the
    indices, the weights under "mul", offsets, x and y."""
    bytes_moved = (8 if combine == "mul" else 4) * m + 12 * n
    flops = (2 if combine == "mul" else 1) * m
    return _least_s(flops, bytes_moved)


def spmm_least_s(n: int, m: int, f: int, weighted: bool = True) -> float:
    """One K4 launch: offsets, indices, the weights if read, X [n, f] and
    Y [n, f], each once; 2 m f operations."""
    bytes_moved = 4 * (n + 1) + (8 if weighted else 4) * m + 8 * n * f
    return _least_s(2 * m * f, bytes_moved)


def gemm_least_s(rows: int, inner: int, cols: int) -> float:
    """[rows, inner] · [inner, cols] in float32."""
    return _least_s(2 * rows * inner * cols,
                    4 * (rows * inner + inner * cols + rows * cols))


def sage_layer_dims(in_dim: int, hidden_dim: int, out_dim: int,
                    num_layers: int) -> list[tuple[int, int]]:
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    return list(zip(dims, dims[1:]))


def sage_aggregations(in_dim, hidden_dim, out_dim, num_layers):
    """(forward widths, VJP widths) of a full-batch GraphSAGE step: every
    layer aggregates its input; every layer but the first, whose input needs
    no gradient, aggregates its input's gradient."""
    dims = sage_layer_dims(in_dim, hidden_dim, out_dim, num_layers)
    return [a for a, _ in dims], [a for a, _ in dims[1:]]


def sage_step_least_s(n: int, m: int, in_dim: int, hidden_dim: int,
                      out_dim: int, num_layers: int) -> float:
    """Least time of one full-batch GraphSAGE (mean) training step: per
    layer the aggregation and its two GEMMs forward; backward the two weight
    GEMMs, and for every layer but the first the two input GEMMs and the
    aggregation's VJP; the Adam update reads parameter, gradient and both
    moments and writes three.  Elementwise work that a kernel could fuse
    (bias, ReLU, the mean's division, the loss) is not counted."""
    total = 0.0
    params = 0
    fwd, vjp = sage_aggregations(in_dim, hidden_dim, out_dim, num_layers)
    for f in fwd + vjp:
        total += spmm_least_s(n, m, f)
    for i, (a, b) in enumerate(sage_layer_dims(in_dim, hidden_dim, out_dim,
                                               num_layers)):
        total += 2 * gemm_least_s(n, a, b)          # forward
        total += 2 * gemm_least_s(a, n, b)          # weight gradients
        if i > 0:
            total += 2 * gemm_least_s(n, b, a)      # input gradients
        params += 2 * a * b + b
    return total + 28 * params / PEAK_BYTES_PER_S
