"""GAT's fused attention K6 (``kernels/gat.py``) and the published
ogbn-products GAT (``nn.GAT`` with skips, four averaged output heads and
self-loops) against the plain GAT of ``tests/plain_gat.py``, on seeded
random weights.

On the CPU, K6 is its plain version (float64 sums, rounded once to
float32) behind the same ``autograd.Function`` and the same padding of
head widths; the plain GAT sums in float64 over explicit self-loops.  The
tolerances: outputs and gradients within 1e-5 of the largest magnitude of
what is compared (float32 inputs, rounded once, against float64), and a
float64 ``gradcheck``.  The tests marked ``cuda`` compare the kernel with
the plain version on the card and repeat it bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cugraph_tpu_torch import nn as tnn
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.kernels import gat
from cugraph_tpu_torch.nn import layers
from cugraph_tpu_torch.prims import vertex_edge
from cugraph_tpu_torch.testing.heavy_rows import heavy_row_edges
from cugraph_tpu_torch.utils.profiling import reset_spans, span_totals

import plain_gat

torch.set_num_threads(1)
REL = 1e-5


def _graph(n=70, hub_edges=600, seed=3):
    """(src, dst, n): a hub (vertex 0) with more in-edges than one span of
    K6, parallel edges, two stored self-loops, and vertices n - 10 .. n - 1
    with no in-edges."""
    rng = np.random.default_rng(seed)
    m = 400
    src = rng.integers(0, n, m)
    dst = rng.integers(1, n - 10, m)
    src[:30], dst[:30] = src[30:60], dst[30:60]
    src[60:62] = dst[60:62]
    src = np.concatenate([src, rng.integers(0, n, hub_edges)])
    dst = np.concatenate([dst, np.zeros(hub_edges, np.int64)])
    return src, dst, n


def _structure(src, dst, n):
    return build_structure(src, dst, None, n, "cpu")


def _plain_edges(src, dst, n, self_loops):
    s, d = torch.as_tensor(src), torch.as_tensor(dst)
    return plain_gat.with_self_loops(s, d, n) if self_loops else (s, d)


def _close(got, want, rel=REL):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


def _randn(*shape, seed, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed),
                       dtype=dtype)


@pytest.mark.parametrize("self_loops", [False, True], ids=["no_loops",
                                                            "self_loops"])
@pytest.mark.parametrize("heads,width", [(h, d) for h in (1, 3, 4)
                                         for d in (5, 47, 128)] + [(2, 200)])
def test_k6_matches_the_plain_attention(heads, width, self_loops):
    """Output and the gradients of <y, G> in x, s and t; D = 200 is cut
    into two sub-heads of 100, the odd widths padded to a multiple of 4."""
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    x = _randn(n, heads, width, seed=1).requires_grad_(True)
    s = _randn(n, heads, seed=2).requires_grad_(True)
    t = _randn(n, heads, seed=3).requires_grad_(True)
    cot = _randn(n, heads, width, seed=4)
    y = gat.gat_attention(g, x, s, t, self_loops=self_loops)
    got = torch.autograd.grad((y * cot).sum(), (x, s, t))
    leaves = [v.detach().double().requires_grad_(True) for v in (x, s, t)]
    ps, pd = _plain_edges(src, dst, n, self_loops)
    want_y = plain_gat.attention(*leaves, ps, pd)
    want = torch.autograd.grad((want_y * cot.double()).sum(), leaves)
    assert y.dtype == torch.float32 and y.shape == (n, heads, width)
    _close(y, want_y)
    if not self_loops:  # vertices with no in-edges get 0
        assert float(y.detach()[n - 10:].abs().max()) == 0.0
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("self_loops", [False, True], ids=["no_loops",
                                                            "self_loops"])
@pytest.mark.parametrize("heads,width", [(1, 3), (2, 4), (1, 131)])
def test_k6_gradcheck(heads, width, self_loops):
    src = np.array([0, 1, 2, 3, 4, 5, 1, 1, 6, 2, 7])
    dst = np.array([1, 2, 3, 0, 0, 0, 0, 2, 2, 5, 5])
    n = 9  # vertices 4, 6, 7 and 8 have no in-edges
    g = _structure(src, dst, n)
    args = tuple(_randn(*shape, seed=i, dtype=torch.float64)
                 .requires_grad_(True)
                 for i, shape in enumerate([(n, heads, width), (n, heads),
                                            (n, heads)]))
    assert torch.autograd.gradcheck(
        lambda x, s, t: gat.gat_attention(g, x, s, t, self_loops=self_loops),
        args)


def test_k6_plain_version_keeps_the_softmax_statistics():
    """The forward's max and denominator are the softmax's, 0 on a vertex
    with no term; the backward recomputes the coefficients from them."""
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    x, s, t = _randn(n, 2, 8, seed=5), _randn(n, 2, seed=6), _randn(n, 2,
                                                                  seed=7)
    y, mx, den = gat.gat_forward_reference(g.csc, x, s, t)
    ps, pd = _plain_edges(src, dst, n, False)
    want_m, want_den = plain_gat._softmax_stats(s, t, ps, pd, n, 0.2)
    has = want_den > 0
    _close(mx[has], want_m[has])
    _close(den, want_den)
    assert float(mx[~has].abs().max()) == 0.0
    assert float(y[~has].abs().max()) == 0.0


def _conv_params(f_in, heads, width, concat, seed):
    """Weights of a GATConv drawn N(0, 1 / fan-in), so that the logits stay
    in the range that trained weights give."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 / np.sqrt(shape[0])).astype(np.float32))

    return {"w": t(f_in, heads * width), "a_src": t(heads, width),
            "a_dst": t(heads, width),
            "b": t(heads * width if concat else width)}


@pytest.mark.parametrize("concat", [True, False], ids=["concat", "mean"])
@pytest.mark.parametrize("self_loops", [False, True], ids=["no_loops",
                                                            "self_loops"])
@pytest.mark.parametrize("heads,width", [(3, 5), (4, 47)])
def test_gat_conv_matches_the_plain_layer(heads, width, self_loops, concat):
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    p = {k: v.requires_grad_(True) for k, v in
         _conv_params(6, heads, width, concat, seed=11).items()}
    x = _randn(n, 6, seed=12).requires_grad_(True)
    out = layers.gat_conv(p, g, x, add_self_loops=self_loops, concat=concat)
    cot = _randn(*out.shape, seed=13)
    leaves = [x] + [p[k] for k in sorted(p)]
    got = torch.autograd.grad((out * cot).sum(), leaves)
    p64 = {k: v.detach().double().requires_grad_(True) for k, v in p.items()}
    x64 = x.detach().double().requires_grad_(True)
    ps, pd = _plain_edges(src, dst, n, self_loops)
    want_out = plain_gat.gat_layer(p64, x64, ps, pd, concat=concat)
    want = torch.autograd.grad((want_out * cot.double()).sum(),
                               [x64] + [p64[k] for k in sorted(p64)])
    _close(out, want_out)
    for a, b in zip(got, want):
        _close(a, b)


F_IN, HIDDEN, CLASSES = 10, 8, 7


def _published(seed=0):
    """PyG's ogbn-products GAT at a small size: 3 layers, 4 heads, the
    last 4 averaged, skips and self-loops."""
    return tnn.GAT(F_IN, HIDDEN, CLASSES, 3, num_heads=4, skip=True,
                   out_heads=4, concat_out=False, add_self_loops=True,
                   device="cpu", generator=torch.Generator().manual_seed(seed))


def _plain_params(model):
    """The model's weights in the plain GAT's layout, float64 leaves."""
    out = []
    for conv, skip in zip(model.layers, model.skips):
        out.append({k: v.detach().double().clone().requires_grad_(True)
                    for k, v in (("w", conv.w.weight.T), ("a_src", conv.a_src),
                                 ("a_dst", conv.a_dst), ("b", conv.b),
                                 ("skip_w", skip.weight.T),
                                 ("skip_b", skip.bias))})
    return out


def _port_leaves(model):
    return [{"w": conv.w.weight, "a_src": conv.a_src, "a_dst": conv.a_dst,
             "b": conv.b, "skip_w": skip.weight, "skip_b": skip.bias}
            for conv, skip in zip(model.layers, model.skips)]


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, F_IN)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, n))
    mask = torch.from_numpy(rng.random(n) < 0.5)
    return x, labels, mask


def test_published_gat_shapes():
    model = _published()
    widths = [(c.w.weight.shape[1], c.w.weight.shape[0], c.b.shape[0])
              for c in model.layers]
    assert widths == [(F_IN, 4 * HIDDEN, 4 * HIDDEN),
                      (4 * HIDDEN, 4 * HIDDEN, 4 * HIDDEN),
                      (4 * HIDDEN, 4 * CLASSES, CLASSES)]
    assert [tuple(s.weight.shape) for s in model.skips] == [
        (4 * HIDDEN, F_IN), (4 * HIDDEN, 4 * HIDDEN), (CLASSES, 4 * HIDDEN)]
    assert all(float(s.bias.detach().abs().max()) == 0.0 for s in model.skips)
    plain = tnn.GAT(F_IN, HIDDEN, CLASSES, 3, device="cpu")
    assert plain.skips is None and plain.layers[-1].b.shape[0] == CLASSES
    with pytest.raises(ValueError, match="no JAX leaf"):
        tnn.state_dict_from_jax(model, tnn.jax_params_from_state_dict(model))


def test_published_gat_matches_the_plain_model():
    """Logits, loss and each leaf's gradient of one step, then the weights
    after one Adam step (lr 1e-3, the published rate)."""
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    x, labels, mask = _inputs(n)
    model = _published()
    params = _plain_params(model)
    logits = model(g, x)
    loss = tnn.masked_cross_entropy(logits, labels, mask)
    loss.backward()
    ps, pd = _plain_edges(src, dst, n, True)

    def plain_loss(p):
        return plain_gat.masked_cross_entropy(
            plain_gat.gat_model(p, x.double(), ps, pd, concat_out=False),
            labels, mask)

    want_logits = plain_gat.gat_model(params, x.double(), ps, pd,
                                      concat_out=False)
    _close(logits, want_logits)
    np.testing.assert_allclose(loss.item(), plain_loss(params).item(),
                               rtol=REL)
    leaves = _port_leaves(model)
    for i, layer in enumerate(params):
        grads = torch.autograd.grad(plain_loss(params), list(layer.values()))
        for k, want in zip(layer, grads):
            got = leaves[i][k].grad
            _close(got.T if k.endswith("w") else got, want)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = tnn.make_train_step(model, opt)
    step(g, x, labels, mask)
    plain_gat.adam_steps(params, plain_loss, 1, lr=1e-3)
    for i, layer in enumerate(params):
        for k, want in layer.items():
            got = leaves[i][k]
            np.testing.assert_allclose(
                (got.T if k.endswith("w") else got).detach().double().numpy(),
                want.detach().numpy(), rtol=0, atol=1e-6)


def test_a_step_runs_k6_once_a_layer_each_way(monkeypatch):
    """One forward and one backward K6 call per layer a step, the span
    ``cugraph.nn.gat_conv`` closed once per layer, and no per-edge gather
    of the projected features."""
    calls = []
    for name in ("_forward", "_backward"):
        real = getattr(gat, name)

        def record(*args, _name=name, _real=real):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(gat, name, record)

    def refuse(*args, **kw):
        raise AssertionError("GAT gathered a per-edge tensor")

    monkeypatch.setattr(layers, "gather_minor", refuse)
    monkeypatch.setattr(vertex_edge, "gather_minor", refuse)
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    model = _published()
    step = tnn.make_train_step(model, torch.optim.Adam(model.parameters()))
    reset_spans()
    step(g, *_inputs(n))
    assert calls.count("_forward") == 3 and calls.count("_backward") == 3
    assert span_totals()["cugraph.nn.gat_conv"][1] == 3


def test_k6_refuses_what_the_kernel_cannot_take():
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    x = _randn(n, 2, 8, seed=1)
    with pytest.raises(ValueError, match="must be contiguous"):
        gat._forward(g, x, _randn(n, 3, seed=2), _randn(n, 2, seed=3), False,
                     0.2)
    with pytest.raises(ValueError, match="multiple of 4"):
        gat._kernel_shape(_randn(n, 2, 6, seed=1))
    with pytest.raises(ValueError, match="up to 128"):
        gat._kernel_shape(_randn(n, 1, 132, seed=1))


def test_minor_layout_maps_csc_positions_to_csr_edges():
    """K6's backward sums each edge's term over the CSC through the CSR's
    ``minor_layout`` order: its k-th entry names a CSR edge with the
    (src, dst) of the CSC's k-th edge, here on the heavy-row fixture and
    on a list with parallel edges and self-loops."""
    graphs = [heavy_row_edges(span, seed=span)[:3] for span in (4, 16)]
    graphs.append((_graph()[2], *_graph()[:2]))
    for n, src, dst in graphs:
        g = _structure(src, dst, n)
        order = g.csr.minor_layout[0]
        assert order.dtype == torch.int64 and order.shape == (g.num_edges,)
        csr_src = g.csr.row_ids()[order]
        csr_dst = g.csr.indices[order]
        assert torch.equal(csr_src, g.csc.indices.to(torch.int64))
        assert torch.equal(csr_dst.to(torch.int64), g.csc.row_ids())


@pytest.mark.parametrize("width", [8, 47])
@pytest.mark.parametrize("self_loops", [False, True], ids=["no_loops",
                                                            "self_loops"])
def test_delta_from_the_output_equals_the_edge_sum(self_loops, width):
    """The identity K6's backward relies on, in float64: <dy, y> with y
    from ``gat_forward_reference`` equals Σ α·<dy, x> as the plain
    backward sums it, 0 on a vertex with no term; 47 is padded to 48 with
    zero columns, as ``gat_attention`` pads it."""
    src, dst, n = _graph()
    g = _structure(src, dst, n)
    pad = -width % 4
    x, dy = (F.pad(_randn(n, 4, width, seed=i, dtype=torch.float64),
                   (0, pad)) for i in (1, 4))
    s, t = (_randn(n, 4, seed=i, dtype=torch.float64) for i in (2, 3))
    y, mx, den = gat.gat_forward_reference(g.csc, x, s, t, self_loops)
    *_, want = gat._backward_terms(g.csc, x, s, t, mx, den, dy, self_loops,
                                   0.2)
    got = (dy * y).sum(-1)
    _close(got, want, rel=1e-12)
    if not self_loops:  # vertices n - 10 .. n - 1 have no in-edges
        assert float(got[n - 10:].abs().max()) == 0.0
        assert float(want[n - 10:].abs().max()) == 0.0


def _card_case(heads, width, self_loops, span, seed=0, edges=None):
    """K6 and its plain version on the card, the heavy rows split at
    ``span``, over ``edges`` (src, dst, n) or ``_graph``'s hub graph;
    returns the kernel's outputs of two launches and the plain ones."""
    src, dst, n = edges or _graph(n=300, hub_edges=2000, seed=seed)
    g = build_structure(src, dst, None, n, "cuda")
    x = _randn(n, heads, width, seed=1).cuda()
    s, t = _randn(n, heads, seed=2).cuda(), _randn(n, heads, seed=3).cuda()
    dy = _randn(n, heads, width, seed=4).cuda()
    runs = []
    for _ in range(2):
        y, mx, den = gat._launch_forward(g.csc, x, s, t, self_loops, 0.2,
                                         span)
        runs.append((y, mx, den) + gat._launch_backward(
            g, x, y, s, t, mx, den, dy, self_loops, 0.2, span))
    torch.cuda.synchronize()
    want_y, want_m, want_den = gat.gat_forward_reference(g.csc, x, s, t,
                                                         self_loops)
    want = (want_y, want_m, want_den) + gat.gat_backward_reference(
        g.csc, x, s, t, want_m, want_den, dy, self_loops)
    return runs, want


def _check_card_case(runs, want):
    """Within 1e-5 of the largest magnitude of the plain version, and bit
    for bit from one launch to the next."""
    for got, ref in zip(runs[0], want):
        _close(got.cpu(), ref.cpu())
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("heads,width,span", [(4, 128, 512), (4, 48, 64),
                                              (3, 20, 16), (1, 4, 7)])
def test_k6_on_the_card_matches_its_plain_version(heads, width, span,
                                                  self_loops):
    """Forward (y, max, denominator) and backward (dx, ds, dt) within
    1e-5 of the largest magnitude, and bit for bit from one launch to the
    next."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_card_case(*_card_case(heads, width, self_loops, span))


def _edge_case_graph(kind):
    """(src, dst, n, self_loops, vertex): ``parallel``, a row of 40 copies
    of one edge and two more rows of parallel edges beside random ones;
    ``isolated``, vertex 0 with no edge at all and no self-loop;
    ``self_only``, vertex 0 with out-edges but no in-edge, so that its
    only term is its self-loop."""
    rng = np.random.default_rng(7)
    n = 60
    src, dst = rng.integers(1, n, 300), rng.integers(1, n, 300)
    if kind == "parallel":
        src = np.concatenate([src, np.full(40, 3), np.repeat([5, 6], 9)])
        dst = np.concatenate([dst, np.full(40, 2), np.repeat([7, 7], 9)])
        return src, dst, n, True, 2
    if kind == "self_only":
        src = np.concatenate([src, np.zeros(12, np.int64)])
        dst = np.concatenate([dst, rng.integers(1, n, 12)])
    return src, dst, n, kind == "self_only", 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["parallel", "isolated", "self_only"])
@pytest.mark.parametrize("heads,width,span", [(4, 128, 16), (3, 20, 7)])
def test_k6_on_the_card_at_the_edge_cases(heads, width, span, kind):
    """Parallel edges (each CSC edge paired with one of its equal CSR
    copies), a vertex with no term (dx = ds = dt = 0 there) and one whose
    only term is its self-loop (dt = 0 there): the backward within 1e-5
    of the plain version and bit for bit from one launch to the next."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, n, self_loops, v = _edge_case_graph(kind)
    runs, want = _card_case(heads, width, self_loops, span,
                            edges=(src, dst, n))
    _check_card_case(runs, want)
    _, _, _, dx, ds, dt = runs[0]
    if kind == "isolated":
        assert float(dx[v].abs().max()) == 0.0
        assert float(ds[v].abs().max()) == 0.0
    if kind != "parallel":
        assert float(dt[v].abs().max()) == 0.0


@pytest.mark.cuda
def test_a_step_on_the_card_counts_k6_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, n = _graph()
    g = build_structure(src, dst, None, n, "cuda")
    model = tnn.GAT(F_IN, HIDDEN, CLASSES, 3, num_heads=4, skip=True,
                    out_heads=4, concat_out=False, add_self_loops=True,
                    device="cuda",
                    generator=torch.Generator().manual_seed(0))
    step = tnn.make_train_step(model, torch.optim.Adam(model.parameters()))
    before = dict(gat.GAT_LAUNCHES)
    step(g, *(v.cuda() for v in _inputs(n)))
    assert {k: gat.GAT_LAUNCHES[k] - before[k] for k in before} == {
        "forward": 3, "backward": 3}
