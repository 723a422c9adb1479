"""GNN layers and models of the PyTorch port (``cugraph_tpu_torch.nn``)
against ``cugraph_tpu.nn``, with one set of weights carried across by
``state_dict_from_jax``.

XLA route (jitted, no Pallas): outputs, losses and parameter gradients
within rtol/atol 1e-5.  Both sides compute in float32 and sum in other
orders (the port's K4 plain version sums in float64 and rounds once), over
a few tens of terms: the differences seen are ~1e-7 relative.

Pallas interpret route (``CUGRAPH_TPU_PALLAS_INTERPRET=1``, eager
``jax.value_and_grad``): the JAX package's SAGE and GCN aggregate with the
one-hot SpMM at precision "default", whose products take bf16 operands
(``spmm_onehot.py:451-453``): each aggregated feature is rounded to 2^-9
relative (~2e-3) before it is summed, forward and backward.  Outputs and
gradients are held within 1e-2 of their largest magnitude and the loss
within rtol 1e-3.

Training: 10 Adam steps (lr 1e-2) against ``optax.adam(1e-2)``.  Losses
within rtol 1e-5; weights within atol 1e-4, because Adam's update
m̂/(√v̂ + ε) is near ±1 wherever the gradient is small, so a 1e-7
difference in a gradient can move an update by far more than that (1e-4 is
1 % of one step).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import networkx as nx
import optax
import pytest
import torch

from cugraph_tpu import nn as jnn
from cugraph_tpu.core.structure import build_structure_host

from cugraph_tpu_torch import nn as tnn
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.kernels import spmm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2
F_IN, HIDDEN, CLASSES = 6, 8, 4


def _graph(kind):
    """(src, dst, weights or None, n)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return (np.concatenate([e[:, 0], e[:, 1]]),
                np.concatenate([e[:, 1], e[:, 0]]), None, 34)
    rng = np.random.default_rng(5)
    n, m = 50, 260
    src = rng.integers(0, n, m)
    dst = rng.integers(10, n, m)  # vertices 0-9 have no in-edges
    src[:20] = dst[:20]  # self-loops
    src[20:40], dst[20:40] = src[40:60], dst[40:60]  # parallel edges
    return src, dst, rng.uniform(0.2, 1.5, m).astype(np.float32), n


GRAPHS = ["directed_weighted", "karate"]


def _both(kind):
    """The JAX structure (padded, with a sink row) and the port's."""
    src, dst, w, n = _graph(kind)
    return (build_structure_host(src, dst, w, n),
            build_structure(src, dst, w, n, "cpu"), n)


def _padded(a, rows):
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def _inputs(n, pad_v, f=F_IN, seed=0):
    """x [n, f] and its padded JAX copy, labels and a half mask (padded
    with label 0 and mask false)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, CLASSES, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    jax_in = tuple(jnp.asarray(_padded(a, pad_v)) for a in (x, labels, mask))
    port_in = tuple(torch.from_numpy(a) for a in (x, labels, mask))
    return jax_in, port_in


def _assert_tree_close(got, want, **tol):
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _grads(module):
    """The parameters' gradients, laid out as the JAX package's pytree."""
    holder = copy.deepcopy(module)
    holder.load_state_dict({k: p.grad for k, p in module.named_parameters()})
    return tnn.jax_params_from_state_dict(holder)


def _port(cls, params, *args, **kw):
    module = cls(*args, device="cpu", **kw)
    module.load_state_dict(tnn.state_dict_from_jax(
        module, jax.tree_util.tree_map(np.asarray, params)))
    return module


# -- aggregation -------------------------------------------------------------

@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_aggregate_matches_jax(kind, mode):
    gj, gt, n = _both(kind)
    x = np.random.default_rng(1).normal(size=(n, 7)).astype(np.float32)
    want = jax.jit(lambda g, x: jnn.aggregate_neighbors(g, x, mode=mode))(
        gj, jnp.asarray(_padded(x, gj.pad_v)))
    got = tnn.aggregate_neighbors(gt, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **TOL)
    if kind == "directed_weighted":  # no in-edges: 0 in every mode
        assert not got[:10].any()


def test_aggregate_max_convention_and_bad_mode():
    _, gt, n = _both("directed_weighted")
    x = torch.full((n, 2), torch.finfo(torch.float32).min)
    x[:, 1] = -3.0
    got = tnn.aggregate_neighbors(gt, x, mode="max")
    has_in = gt.in_degrees() > 0
    assert not got[:, 0].any()  # at or below finfo.min gives 0
    assert torch.equal(got[:, 1], torch.where(has_in, -3.0, 0.0))
    with pytest.raises(ValueError, match="unknown aggregation"):
        tnn.aggregate_neighbors(gt, x, mode="min")


def test_weighted_in_degree_is_cached_and_matches_jax():
    gj, gt, n = _both("directed_weighted")
    deg = gt.in_weight_sums
    assert deg is gt.in_weight_sums and deg.dtype == torch.float32
    np.testing.assert_allclose(deg.numpy(),
                               np.asarray(gj.in_weight_sums())[:n], rtol=1e-6)


# -- layers, XLA route --------------------------------------------------------

LAYERS = {
    "sage": (jnn.sage_init, jnn.sage_conv, tnn.SAGEConv, (F_IN, 5)),
    "gcn": (jnn.gcn_init, jnn.gcn_conv, tnn.GCNConv, (F_IN, 5)),
    "gat_1head": (jnn.gat_init, jnn.gat_conv, tnn.GATConv, (F_IN, 5, 1)),
    "gat_3heads": (jnn.gat_init, jnn.gat_conv, tnn.GATConv, (F_IN, 4, 3)),
    "gatv2_2heads": (jnn.gatv2_init, jnn.gatv2_conv, tnn.GATv2Conv,
                     (F_IN, 4, 2)),
    "gin": (jnn.gin_init, jnn.gin_conv, tnn.GINConv, (F_IN, 9, 5)),
}


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name, kind):
    """Output, and the gradients of <out, G> with respect to every
    parameter and to x."""
    init, conv, cls, dims = LAYERS[name]
    gj, gt, n = _both(kind)
    params = init(jax.random.key(3), *dims)
    if name == "gin":
        params = dict(params, eps=jnp.float32(0.25))
    layer = _port(cls, params, *dims)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, F_IN)).astype(np.float32)
    out_dim = layer(gt, torch.from_numpy(x)).shape[1]
    cot = rng.normal(size=(n, out_dim)).astype(np.float32)

    def inner(p, g, xx):
        return jnp.sum(conv(p, g, xx)[:n] * cot)

    out_j = jax.jit(conv)(params, gj, jnp.asarray(_padded(x, gj.pad_v)))
    (gp_j, gx_j) = jax.jit(jax.grad(inner, argnums=(0, 2)))(
        params, gj, jnp.asarray(_padded(x, gj.pad_v)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = layer(gt, xt)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(),
                               np.asarray(out_j)[:n], **TOL)
    _assert_tree_close(_grads(layer), gp_j, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j)[:n], **TOL)


@pytest.mark.parametrize("kind", GRAPHS)
def test_appnp_propagate_matches_jax(kind):
    gj, gt, n = _both(kind)
    z = np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32)
    want = jax.jit(lambda g, z: jnn.appnp_propagate(g, z, alpha=0.2, k=6))(
        gj, jnp.asarray(_padded(z, gj.pad_v)))
    got = tnn.appnp_propagate(gt, torch.from_numpy(z), alpha=0.2, k=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **TOL)


# -- models, XLA route --------------------------------------------------------

MODELS = {
    "graphsage": (jnn.graphsage_init, jnn.graphsage_apply, tnn.GraphSAGE),
    "gcn": (jnn.gcn_model_init, jnn.gcn_apply, tnn.GCN),
    "gat": (jnn.gat_model_init, jnn.gat_apply, tnn.GAT),
    "gatv2": (jnn.gatv2_model_init, jnn.gatv2_apply, tnn.GATv2),
    "gin": (jnn.gin_model_init, jnn.gin_apply, tnn.GIN),
    "appnp": (jnn.appnp_init, jnn.appnp_apply, tnn.APPNP),
}


def _value_and_grad(apply):
    def loss_fn(p, g, x, labels, mask):
        return jnn.masked_cross_entropy(apply(p, g, x), labels, mask)

    return jax.value_and_grad(loss_fn)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name, kind):
    init, apply, cls = MODELS[name]
    gj, gt, n = _both(kind)
    params = init(jax.random.key(7), F_IN, HIDDEN, CLASSES)
    model = _port(cls, params, F_IN, HIDDEN, CLASSES)
    jax_in, port_in = _inputs(n, gj.pad_v)
    loss_j, grads_j = jax.jit(_value_and_grad(apply))(params, gj, *jax_in)
    logits_j = jax.jit(apply)(params, gj, jax_in[0])
    logits_t = model(gt, port_in[0])
    loss_t = tnn.masked_cross_entropy(logits_t, *port_in[1:])
    loss_t.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j)[:n], **TOL)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    _assert_tree_close(_grads(model), grads_j, **TOL)
    np.testing.assert_allclose(
        float(tnn.accuracy(logits_t, *port_in[1:])),
        float(jnn.accuracy(logits_j, *jax_in[1:])), rtol=0, atol=0)


# -- the Pallas interpret route (one-hot SpMM with its custom VJP) ------------

@pytest.mark.parametrize("name", ["graphsage", "gcn"])
def test_model_matches_jax_pallas_interpret(name, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    init, apply, cls = MODELS[name]
    gj, gt, n = _both("directed_weighted")
    params = init(jax.random.key(7), F_IN, HIDDEN, CLASSES)
    model = _port(cls, params, F_IN, HIDDEN, CLASSES)
    jax_in, port_in = _inputs(n, gj.pad_v, seed=1)
    # eager, so the JAX package takes its Pallas route
    loss_j, grads_j = _value_and_grad(apply)(params, gj, *jax_in)
    logits_j = np.asarray(apply(params, gj, jax_in[0]))[:n]
    logits_t = model(gt, port_in[0])
    loss_t = tnn.masked_cross_entropy(logits_t, *port_in[1:])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-3)
    got = logits_t.detach().numpy()
    np.testing.assert_allclose(got, logits_j, rtol=0,
                               atol=BF16_REL * np.abs(logits_j).max())
    for a, b in zip(jax.tree_util.tree_leaves(_grads(model)),
                    jax.tree_util.tree_leaves(grads_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=BF16_REL * np.abs(b).max())


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["graphsage", "gcn"])
def test_training_matches_optax(name):
    init, apply, cls = MODELS[name]
    gj, gt, n = _both("directed_weighted")
    params = init(jax.random.key(1), F_IN, 16, CLASSES)
    model = _port(cls, params, F_IN, 16, CLASSES)
    jax_in, port_in = _inputs(n, gj.pad_v, seed=2)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    step_j = jax.jit(jnn.make_train_step(apply, opt))
    step_t = tnn.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                         lr=1e-2))
    losses_j, losses_t = [], []
    for _ in range(10):
        params, state, loss = step_j(params, state, gj, *jax_in)
        losses_j.append(float(loss))
        losses_t.append(float(step_t(gt, *port_in)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    _assert_tree_close(tnn.jax_params_from_state_dict(model), params,
                       rtol=0, atol=1e-4)


def test_graphsage_training_learns_communities():
    """tests/test_nn.py's two-cluster case, in the port."""
    rng = np.random.default_rng(3)
    n_half, edges = 16, []
    for c in range(2):
        for _ in range(120):
            u, v = rng.integers(0, n_half, 2)
            if u != v:
                edges.append((c * n_half + u, c * n_half + v))
    src, dst = np.array(edges).T
    n = 2 * n_half
    g = build_structure(src, dst, None, n, "cpu")
    labels = torch.zeros(n, dtype=torch.int64)
    labels[n_half:] = 1
    mask = torch.ones(n, dtype=torch.bool)
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    model = tnn.GraphSAGE(8, 16, 2, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    step = tnn.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                       lr=1e-2))
    losses = [float(step(g, x, labels, mask)) for _ in range(60)]
    assert losses[-1] < losses[0] * 0.5
    with torch.no_grad():
        assert float(tnn.accuracy(model(g, x), labels, mask)) > 0.9


def test_masked_cross_entropy_ignores_masked_rows():
    logits = torch.tensor([[10.0, 0.0], [0.0, 10.0], [100.0, -100.0]])
    labels = torch.tensor([0, 1, 1])
    mask = torch.tensor([True, True, False])
    assert float(tnn.masked_cross_entropy(logits, labels, mask)) < 1e-3
    assert float(tnn.masked_cross_entropy(logits, labels,
                                          torch.zeros(3, dtype=bool))) == 0.0


@pytest.mark.parametrize("name,forward,backward", [
    ("graphsage", 2, 1), ("gcn", 2, 2), ("gin", 2, 1)])
def test_k4_calls_per_step(name, forward, backward, monkeypatch):
    """A training step runs K4 once per sum/mean aggregation forward, and
    once more over the CSR for each one whose input needs a gradient:
    GraphSAGE's and GIN's first layer aggregate the features, which do
    not; GCN's aggregate W·x, which does."""
    keys = []
    real = spmm._spmm_csr

    def record(offsets, indices, weights, x, count_key):
        keys.append(count_key)
        return real(offsets, indices, weights, x, count_key)

    monkeypatch.setattr(spmm, "_spmm_csr", record)
    _, gt, n = _both("directed_weighted")
    _, port_in = _inputs(n, n)
    model = MODELS[name][2](F_IN, HIDDEN, CLASSES, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    step = tnn.make_train_step(model, torch.optim.Adam(model.parameters()))
    step(gt, *port_in)
    assert keys.count("weighted") == forward
    assert keys.count("weighted_vjp") == backward
    assert len(keys) == forward + backward


# -- weights carried across ---------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_convert_round_trip(name):
    init, _, cls = MODELS[name]
    params = jax.tree_util.tree_map(
        np.asarray, init(jax.random.key(0), F_IN, HIDDEN, CLASSES))
    model = _port(cls, params, F_IN, HIDDEN, CLASSES)
    back = tnn.jax_params_from_state_dict(model)
    _assert_tree_close(back, params, rtol=0, atol=0)
    other = cls(F_IN, HIDDEN, CLASSES, device="cpu",
                generator=torch.Generator().manual_seed(5))
    again = tnn.state_dict_from_jax(other, back)
    for key, value in model.state_dict().items():
        assert torch.equal(again[key], value)


def test_convert_rejects_mismatches():
    params = jax.tree_util.tree_map(
        np.asarray, jnn.graphsage_init(jax.random.key(0), F_IN, 8, 3))
    with pytest.raises(ValueError, match="shape"):
        tnn.state_dict_from_jax(tnn.GraphSAGE(F_IN, 9, 3, device="cpu"),
                                params)
    del params[1]["b"]
    with pytest.raises(KeyError):
        tnn.state_dict_from_jax(tnn.GraphSAGE(F_IN, 8, 3, device="cpu"),
                                params)


def test_initial_weights_follow_the_generator():
    def make(seed):
        return tnn.GATv2(F_IN, 4, 3, num_heads=2, device="cpu",
                         generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.w_src.weight"],
                           c["layers.0.w_src.weight"])
    limit = np.sqrt(6.0 / (F_IN + 8))
    assert float(a["layers.0.w_src.weight"].abs().max()) <= limit


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        assert next(tnn.GCN(4, 8, 2).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.GraphSAGE(4, 8, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.SAGEConv(4, 8)


@pytest.mark.cuda
def test_graphsage_step_on_the_card_matches_cpu():
    """One GraphSAGE step on the card (K4 forward, K4 over the CSR
    backward, float32 GEMMs with no TF32) against the same step on the CPU
    (the plain versions): loss within rtol 1e-5, gradients within rtol
    1e-4 of their largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    src, dst, w, n = _graph("directed_weighted")
    _, port_in = _inputs(n, n)
    out = {}
    for dev in ("cpu", "cuda"):
        g = build_structure(src, dst, w, n, dev)
        model = tnn.GraphSAGE(F_IN, 64, CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(0))
        before = dict(spmm.SPMM_LAUNCHES)
        step = tnn.make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-2))
        loss = step(g, *(t.to(dev) for t in port_in))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert spmm.SPMM_LAUNCHES["weighted"] == before["weighted"] + 2
            assert spmm.SPMM_LAUNCHES["weighted_vjp"] == \
                before["weighted_vjp"] + 1
        out[dev] = float(loss), {k: p.grad.cpu() for k, p in
                                 model.named_parameters()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
