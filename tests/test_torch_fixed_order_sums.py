"""The fixed-order float sums against the scatter sums they replaced.

On the card a float ``scatter_reduce_(..., "sum")``, ``index_add`` or
the backward of a gather (``index_put_(accumulate=True)``) adds with
atomics, so two runs can differ in the last bits; the port now sums each
segment in edge order (``torch.segment_reduce``).  On the CPU the old
scatters add sequentially in edge order too, so every new sum here must
equal the old one bit for bit: the per-row sums of
``segment_reduce_by_major``, ``parallel.prims.block_segment_reduce``
(sorted and unsorted slots), ``GraphStructure.in_weight_sums``,
``nn.linkpred.roc_auc``'s tie ranks, and the gradients of the gathers and
of a whole GATv2 layer.  A GAT layer's float sums are its attention's,
K6's, whose plain version sums in float64 and rounds once: it must equal,
bit for bit, float64 autograd through plain indexing and scatter sums,
rounded once.
"""

import numpy as np
import pytest
import torch

from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.nn import layers
from cugraph_tpu_torch.nn.linkpred import roc_auc
from cugraph_tpu_torch.parallel.prims import block_segment_reduce
from cugraph_tpu_torch.prims import vertex_edge
from cugraph_tpu_torch.prims.vertex_edge import (gather_major, gather_minor,
                                                 segment_reduce_by_major)

torch.set_num_threads(1)


def _skewed(n=300, m=6000, seed=0):
    """A weighted COO whose hub rows gather many edges."""
    rng = np.random.default_rng(seed)
    src = (rng.pareto(1.0, m) * 5).astype(np.int64) % n
    dst = (rng.pareto(1.0, m) * 5).astype(np.int64) % n
    w = rng.uniform(0.1, 3.0, m).astype(np.float32)
    return build_structure(src, dst, w, n, "cpu")


def _bits(t):
    return t.detach().contiguous().view(torch.int8 if t.element_size() == 1
                                        else {2: torch.int16,
                                              4: torch.int32,
                                              8: torch.int64}[
                                            t.element_size()])


def _same(a, b):
    assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _old_segment(adj, values, op):
    """The scatter it replaced (``prims/vertex_edge.py`` before)."""
    rows = adj.row_ids()
    out = torch.full((adj.num_vertices, *values.shape[1:]),
                     0.0 if op == "sum" else 1.0, dtype=values.dtype)
    index = rows.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, index, values, op, include_self=True)


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
@pytest.mark.parametrize("op", ["sum", "prod"])
def test_segment_reduce_by_major_keeps_the_scatter_bits(shape, op):
    g = _skewed()
    vals = torch.from_numpy(np.random.default_rng(1).uniform(
        0.9, 1.1, (g.csc.num_edges,) + shape).astype(np.float32))
    for adj in (g.csc, g.csr):
        _same(segment_reduce_by_major(adj, vals, op),
              _old_segment(adj, vals, op))


def test_integer_sums_and_minmax_still_scatter():
    g = _skewed()
    ints = torch.arange(g.csc.num_edges, dtype=torch.int64) % 7
    _same(segment_reduce_by_major(g.csc, ints, "sum"),
          torch.zeros(g.num_vertices, dtype=torch.int64).index_add_(
              0, g.csc.row_ids(), ints))
    vals = torch.randn(g.csc.num_edges, generator=torch.Generator()
                       .manual_seed(2))
    want = torch.full((g.num_vertices,), float("-inf")).scatter_reduce_(
        0, g.csc.row_ids(), vals, "amax")
    _same(segment_reduce_by_major(g.csc, vals, "max"), want)


@pytest.mark.parametrize("sort", [True, False])
def test_block_segment_reduce_keeps_the_index_add_bits(sort):
    """A sorted dst_loc sums by runs; an unsorted one is put in order by a
    stable sort, which keeps each segment's arrival order, so both equal
    the sequential ``index_add``."""
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 50, 4000)
    if sort:
        dst = np.sort(dst)
    vals = torch.from_numpy(rng.standard_normal((4000, 3)).astype(
        np.float32))
    idx = torch.from_numpy(dst)
    want = torch.zeros(60, 3).index_add(0, idx, vals)
    _same(block_segment_reduce(vals, idx, 60, "sum"), want)


def test_in_weight_sums_keep_the_float64_bits():
    g = _skewed()
    want = torch.zeros(g.num_vertices, dtype=torch.float64).index_add_(
        0, g.csc.row_ids(), g.csc.weights.double()).float()
    _same(g.in_weight_sums, want)


def test_roc_auc_keeps_its_tie_ranks():
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.integers(0, 20, 500).astype(np.float32))
    neg = torch.from_numpy(rng.integers(0, 20, 700).astype(np.float32))
    scores = torch.cat([pos, neg])
    labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    n = len(scores)
    ranks = torch.arange(1, n + 1, dtype=torch.float32)
    new_run = torch.ones(n, dtype=torch.bool)
    new_run[1:] = s_sorted[1:] != s_sorted[:-1]
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    run_sum = torch.zeros_like(ranks).index_add_(0, run_id, ranks)
    run_cnt = torch.zeros_like(ranks).index_add_(0, run_id,
                                                 torch.ones_like(ranks))
    mid = run_sum[run_id] / torch.clamp(run_cnt[run_id], min=1.0)
    want = (torch.sum(mid * labels[order]) - 500 * 501 / 2.0) / (500 * 700)
    _same(roc_auc(pos, neg), want)


@pytest.mark.parametrize("which", ["minor", "major"])
def test_gather_gradients_equal_the_scatter_backward(which):
    """The fixed-order backward of a gather (one ``segment_reduce`` in the
    index's stable order) gives autograd's own gradient bit for bit."""
    g = _skewed()
    adj = g.csc
    x = torch.randn(g.num_vertices, 5, generator=torch.Generator()
                    .manual_seed(5), requires_grad=True)
    up = torch.randn(adj.num_edges, 5, generator=torch.Generator()
                     .manual_seed(6))
    fn = gather_minor if which == "minor" else gather_major
    index = (adj.indices.to(torch.int64) if which == "minor"
             else adj.row_ids())
    (grad,) = torch.autograd.grad((fn(adj, x) * up).sum(), x)
    (want,) = torch.autograd.grad((x[index] * up).sum(), x)
    _same(fn(adj, x), x[index])
    _same(grad, want)


def _plain_attention(g, x, s, t, *, self_loops=False, negative_slope=0.2):
    """K6's attention in float64 autograd over plain indexing and scatter
    sums, rounded once."""
    rows, cols = g.csc.row_ids(), g.csc.indices.to(torch.int64)
    x64, s64, t64 = x.double(), s.double(), t.double()
    e = torch.nn.functional.leaky_relu(s64[cols] + t64[rows], negative_slope)
    mx = torch.full_like(s64, -torch.inf).scatter_reduce(
        0, rows[:, None].expand_as(e), e.detach(), "amax")
    p = torch.exp(e - mx[rows])
    den = torch.zeros_like(s64).index_add(0, rows, p)
    y = torch.zeros_like(x64).index_add(
        0, rows, (p / den[rows])[:, :, None] * x64[cols])
    return y.to(x.dtype)


@pytest.mark.parametrize("layer", ["gat_conv", "gatv2_conv"])
def test_attention_layers_keep_their_bits(layer, monkeypatch):
    """GATv2, forward and every gradient, equals the layer run with plain
    indexing and the old scatter sums; GAT's attention (K6's plain version
    through its autograd.Function, as ``gat_conv`` calls it), its output
    and its gradients in x, s and t, equals float64 autograd through plain
    indexing and scatter sums, rounded once (t's where its exact value is
    not 0)."""
    g = _skewed()
    heads, width, fin = 3, 4, 6
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(True)

    if layer == "gat_conv":
        leaves = [t(g.num_vertices, heads, width), t(g.num_vertices, heads),
                  t(g.num_vertices, heads)]

        def attention():
            out = layers.gat_attention(g, *leaves)
            return [out] + list(torch.autograd.grad(out.square().sum(),
                                                    leaves))

        got = attention()
        monkeypatch.setattr(layers, "gat_attention", _plain_attention)
        want = attention()
        for a, b in zip(got[:3], want[:3]):
            _same(a, b)
        # dt[v] = Σ α·LeakyReLU'·(<dy, x> − Δ) is exactly 0 where every
        # in-edge of v sits on one side of the kink (Σ α·(<dy, x> − Δ) = 0):
        # there both routes read float64 rounding noise; elsewhere bit for
        # bit
        rows, cols = g.csc.row_ids(), g.csc.indices.to(torch.int64)
        positive = (leaves[1][cols] + leaves[2][rows] > 0).double()
        zero = torch.zeros_like(got[3], dtype=torch.float64)
        edges = zero.index_add(0, rows, torch.ones_like(positive))
        positives = zero.index_add(0, rows, positive)
        kinked = (positives > 0) & (positives < edges)
        _same(got[3][kinked], want[3][kinked])
        assert float(got[3][~kinked].abs().max()) <= 1e-12
        assert float(want[3][~kinked].abs().max()) <= 1e-12
        return
    params = {"w_src": t(fin, heads * width),
              "w_dst": t(fin, heads * width), "a": t(heads, width),
              "b": t(heads * width)}
    x = t(g.num_vertices, fin)
    leaves = [x] + [params[k] for k in sorted(params)]

    def run():
        out = getattr(layers, layer)(params, g, x)
        return [out] + list(torch.autograd.grad(out.square().sum(), leaves))

    got = run()
    monkeypatch.setattr(layers, "gather_minor",
                        lambda adj, v: v[adj.indices.to(torch.int64)])
    monkeypatch.setattr(layers, "gather_major",
                        lambda adj, v: v[adj.row_ids()])

    def old(adj, values, op="sum"):
        if op != "sum":
            return vertex_edge.segment_reduce_by_major(adj, values, op)
        return _old_segment(adj, values, "sum")

    monkeypatch.setattr(layers, "segment_reduce_by_major", old)
    for a, b in zip(got, run()):
        _same(a, b)
