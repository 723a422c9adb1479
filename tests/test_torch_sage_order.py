"""The order of aggregation and projection in the port's ``sage_conv``.

``sage_conv`` aggregates its input and projects the mean where W_nbr keeps
or widens the width, and projects first, aggregating at the narrower
output width, where W_nbr narrows (``nn/layers.py``).  The projected order
is the same function rounded in another order: its output and gradients
are held within the port's ``TOL`` (rtol/atol 1e-5, as in
``tests/test_torch_nn.py``) of the aggregate-first formula computed in
float64.  The other order is today's formula, bit for bit.
``SAGE_AGGREGATION_ORDER`` counts each call once.  The tests marked
``cuda`` hold K4 and its VJP at the width a layer narrowing to
ogbn-products' 47 classes aggregates at (48, padded) against the plain
version on a graph whose rows pass ``SPMM_SPAN``, and such a layer on the
card against the CPU; they skip without a card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cugraph_tpu_torch import nn as tnn
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.kernels import spmm
from cugraph_tpu_torch.kernels.spmm import spmm_csr_reference
from cugraph_tpu_torch.nn import layers
from cugraph_tpu_torch.testing.heavy_rows import heavy_row_edges

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-5


def _graph(device="cpu"):
    """A weighted directed graph with vertices of no in-edges, self-loops
    and parallel edges, and its vertex count."""
    rng = np.random.default_rng(5)
    n, m = 50, 260
    src = rng.integers(0, n, m)
    dst = rng.integers(10, n, m)  # vertices 0-9 have no in-edges
    src[:20] = dst[:20]  # self-loops
    src[20:40], dst[20:40] = src[40:60], dst[40:60]  # parallel edges
    w = rng.uniform(0.2, 1.5, m).astype(np.float32)
    return build_structure(src, dst, w, n, device), n


def _layer(in_dim, out_dim, n, seed=0):
    """A SAGEConv on the CPU with a nonzero bias, an input that needs a
    gradient and a gradient for the output."""
    gen = torch.Generator().manual_seed(seed)
    conv = tnn.SAGEConv(in_dim, out_dim, generator=gen, device="cpu")
    with torch.no_grad():
        conv.b.uniform_(-1, 1, generator=gen)
    x = torch.randn(n, in_dim, generator=gen).requires_grad_()
    gy = torch.randn(n, out_dim, generator=gen)
    return conv, x, gy


def _grads(conv, x, out, gy):
    names = ("x", "w_self", "w_nbr", "b")
    leaves = (x, conv.w_self.weight, conv.w_nbr.weight, conv.b)
    return dict(zip(names, torch.autograd.grad(out, leaves, gy)))


def _aggregate_first_float64(g, n, conv, x):
    """h = x·W_selfᵀ + (mean over in-edges of x)·W_nbrᵀ + b in float64,
    the mean through a dense weighted adjacency."""
    adj = g.csc
    rows = torch.repeat_interleave(torch.arange(n), adj.offsets.diff())
    a = torch.zeros(n, n, dtype=torch.float64).index_put_(
        (rows, adj.indices.long()), adj.weights.double(), accumulate=True)
    deg = torch.clamp(g.in_weight_sums.double(), min=1e-12)[:, None]
    ws, wn, b = (t.double() for t in (conv.w_self.weight,
                                      conv.w_nbr.weight, conv.b))
    x64 = x.double()
    return x64 @ ws.T + ((a @ x64) / deg) @ wn.T + b


def test_narrowing_layer_matches_aggregate_first_in_float64():
    g, n = _graph()
    conv, x, gy = _layer(16, 5, n)
    before = dict(layers.SAGE_AGGREGATION_ORDER)
    out = conv(g, x)
    assert layers.SAGE_AGGREGATION_ORDER["project_first"] == \
        before["project_first"] + 1
    assert layers.SAGE_AGGREGATION_ORDER["aggregate_first"] == \
        before["aggregate_first"]
    got = _grads(conv, x, out, gy)

    conv64 = conv.double()
    x64 = x.detach().double().requires_grad_()
    want_out = _aggregate_first_float64(g, n, conv64, x64)
    want = _grads(conv64, x64, want_out, gy.double())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(),
                               want_out.detach().numpy(), **TOL)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("in_dim,out_dim", [(5, 16), (8, 8)],
                         ids=["widening", "tie"])
def test_other_layers_keep_the_aggregate_first_bits(in_dim, out_dim):
    """Widening and equal widths run today's formula: the same output and
    gradients, bit for bit."""
    g, n = _graph()
    conv, x, gy = _layer(in_dim, out_dim, n, seed=1)
    before = dict(layers.SAGE_AGGREGATION_ORDER)
    out = conv(g, x)
    assert layers.SAGE_AGGREGATION_ORDER["aggregate_first"] == \
        before["aggregate_first"] + 1
    assert layers.SAGE_AGGREGATION_ORDER["project_first"] == \
        before["project_first"]
    got = _grads(conv, x, out, gy)
    h_nbr = layers.aggregate_neighbors(g, x, mode="mean")
    want_out = (F.linear(x, conv.w_self.weight)
                + F.linear(h_nbr, conv.w_nbr.weight) + conv.b)
    want = _grads(conv, x, want_out, gy)
    assert torch.equal(out, want_out)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_graphsage_counts_one_projected_aggregation_of_three(monkeypatch):
    """GraphSAGE at ogbn-products' widths, 100 → 256 → 256 → 47: only the
    last layer narrows, and K4 aggregates it at 48 features (47 padded to
    the float4 path's multiple of 4)."""
    widths = []
    real = spmm._spmm_csr

    def record(offsets, indices, weights, x, count_key):
        widths.append(x.shape[1])
        return real(offsets, indices, weights, x, count_key)

    monkeypatch.setattr(spmm, "_spmm_csr", record)
    g, n = _graph()
    model = tnn.GraphSAGE(100, 256, 47, num_layers=3, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn(n, 100, generator=torch.Generator().manual_seed(1))
    before = dict(layers.SAGE_AGGREGATION_ORDER)
    assert model(g, x).shape == (n, 47)
    assert {k: v - before[k] for k, v in
            layers.SAGE_AGGREGATION_ORDER.items()} == \
        {"aggregate_first": 2, "project_first": 1}
    assert widths == [100, 256, 48]


@pytest.mark.cuda
def test_k4_and_its_vjp_at_the_padded_narrow_width_on_the_card():
    """K4 and its VJP at 48 features (the float4 path), the width a layer
    narrowing to ogbn-products' 47 classes aggregates at, its last column
    zero forward and backward as the padded projection and the slice give
    it, over a graph whose rows pass SPMM_SPAN (the span pass runs),
    against the plain version: two launches bit-identical, one counted
    launch per call, the padding column zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, src, dst, w = heavy_row_edges(spmm.SPMM_SPAN, seed=1)
    g = build_structure(src, dst, w, n, "cuda")
    assert int(g.csc.offsets.diff().max()) > spmm.SPMM_SPAN
    assert int(g.csr.offsets.diff().max()) > spmm.SPMM_SPAN
    pair = spmm.get_structure_spmm_fn(g)
    x = F.pad(torch.rand(n, 47, device="cuda") * 10, (0, 1)).requires_grad_()
    gy = F.pad(torch.rand(n, 47, device="cuda"), (0, 1))
    before = dict(spmm.SPMM_LAUNCHES)
    y1, y2 = pair(x), pair(x)
    (gx1,) = torch.autograd.grad(y1, x, gy)
    (gx2,) = torch.autograd.grad(y2, x, gy)
    torch.cuda.synchronize()
    assert spmm.SPMM_LAUNCHES["weighted"] == before["weighted"] + 2
    assert spmm.SPMM_LAUNCHES["weighted_vjp"] == before["weighted_vjp"] + 2
    for a, b in ((y1, y2), (gx1, gx2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert not a[:, 47].any()
    torch.testing.assert_close(
        y1, spmm_csr_reference(g.csc.offsets, g.csc.indices, g.csc.weights,
                               x.detach()), rtol=RTOL, atol=0)
    torch.testing.assert_close(
        gx1, spmm_csr_reference(g.csr.offsets, g.csr.indices, g.csr.weights,
                                gy), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_narrowing_layer_on_the_card_matches_cpu():
    """A 64 → 47 layer (projected, padded to 48, sliced) on the heavy-row
    graph, on the card against the CPU: output within rtol 1e-5 and the
    gradients within 1e-4 of their largest magnitude, as the GraphSAGE
    step on the card is held (tests/test_torch_nn.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    n, src, dst, w = heavy_row_edges(spmm.SPMM_SPAN, seed=2)
    conv, x, gy = _layer(64, 47, n, seed=3)
    got = {}
    for dev in ("cpu", "cuda"):
        g = build_structure(src, dst, w, n, dev)
        c = conv.to(dev)
        xd = x.detach().to(dev).requires_grad_()
        out = c(g, xd)
        got[dev] = {k: v.cpu() for k, v in
                    _grads(c, xd, out, gy.to(dev)).items()}
        got[dev]["out"] = out.detach().cpu()
    torch.testing.assert_close(got["cuda"].pop("out"), got["cpu"].pop("out"),
                               rtol=1e-5, atol=1e-5)
    for k, want in got["cpu"].items():
        torch.testing.assert_close(got["cuda"][k], want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
