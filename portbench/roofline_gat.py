"""The least time of K6 (GAT's fused attention, ``kernels/gat.py``) and of
one full-batch GAT training step on one NVIDIA H100 SXM.

Counted as ``roofline.py`` counts: every input read once, every output
written once, the larger of the FLOPs at the float32 rate and the bytes at
the HBM rate (``roofline._least_s``).  A layer of ``heads`` heads of
``width`` features over a CSC of ``n`` rows and ``m`` stored edges, plus a
self-loop per vertex where ``self_loops``; the widths are the published
ones (the program pads 47 to 48, which is its own cost).
"""

from __future__ import annotations

from portbench.roofline import PEAK_BYTES_PER_S, _least_s, gemm_least_s


def k6_forward_bytes(n: int, m: int, heads: int, width: int) -> int:
    """Offsets and indices of the CSC, x [n, H·D] and the logits s, t
    [n, H] read; y [n, H·D] and the softmax's max and denominator [n, H]
    written."""
    return 4 * (n + 1) + 4 * m + 8 * n * heads * width + 16 * n * heads


def k6_backward_bytes(n: int, m: int, heads: int, width: int) -> int:
    """Offsets and indices of the CSC and the CSR, x and dy [n, H·D], s, t,
    the max and the denominator [n, H] read; dx [n, H·D], ds and dt [n, H]
    written."""
    return (8 * (n + 1) + 8 * m + 12 * n * heads * width
            + 24 * n * heads)


def k6_least_s(n: int, m: int, heads: int, width: int,
               self_loops: bool = True) -> tuple[float, float]:
    """(forward, backward) least seconds of one launch: 2 H D FLOPs a term
    forward (the weighted sum), 4 H D backward (the dot and dx)."""
    terms = m + (n if self_loops else 0)
    hd = heads * width
    return (_least_s(2 * terms * hd, k6_forward_bytes(n, m, heads, width)),
            _least_s(4 * terms * hd, k6_backward_bytes(n, m, heads, width)))


def gat_layers(config: dict):
    """(fan in, heads, head width, output width) of each layer."""
    out, d = [], config["in_dim"]
    for i in range(config["num_layers"]):
        last = i + 1 == config["num_layers"]
        heads = config["out_heads"] if last else config["num_heads"]
        width = config["out_dim"] if last else config["hidden_dim"]
        concat = config["concat_out"] or not last
        out.append((d, heads, width, heads * width if concat else width))
        d = out[-1][3]
    return out


def gat_k6_least_s(n: int, m: int, config: dict) -> float:
    """K6's least time in one step: a forward and a backward a layer."""
    return sum(sum(k6_least_s(n, m, heads, width, config["add_self_loops"]))
               for _, heads, width, _ in gat_layers(config))


def gat_step_least_s(n: int, m: int, config: dict) -> float:
    """Least time of one full-batch GAT step: K6 forward and backward a
    layer; the projection x W and the skip x W_skip forward, their weight
    gradients, and for every layer but the first (whose input needs no
    gradient) their input gradients; Adam reads parameter, gradient and
    both moments and writes three.  Elementwise work that a kernel could
    fuse (the logits, bias, ELU, the head mean, the loss) is not
    counted."""
    total = gat_k6_least_s(n, m, config)
    params = 0
    for i, (a, heads, width, out) in enumerate(gat_layers(config)):
        for cols in (heads * width, out):
            total += gemm_least_s(n, a, cols) + gemm_least_s(a, n, cols)
            if i > 0:
                total += gemm_least_s(n, cols, a)
            params += a * cols
        params += 2 * heads * width + 2 * out
    return total + 28 * params / PEAK_BYTES_PER_S
