"""``cugraph_tpu_torch.nn``'s functional surface (``*_init``, ``*_conv``,
``*_apply`` and the apply-function train steps) against ``cugraph_tpu.nn``
on the same weights, carried across as dicts of tensors in the JAX
layout.

Tolerances: outputs within rtol/atol 1e-5 (float32 on both sides, sums
in other orders over a few tens of terms, as in ``test_torch_nn.py``);
10 functional Adam steps against ``optax.adam`` with the module path's
bounds: losses rtol 1e-5, weights atol 1e-4 (Adam's update is near ±1
where a gradient is small, so a 1e-7 gradient difference moves a weight
by far more).  A module's forward and its functional apply share one
implementation, so they agree bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cugraph_tpu import nn as jnn
from cugraph_tpu.core.structure import build_structure_host

from cugraph_tpu_torch import nn as tnn
from cugraph_tpu_torch.core.structure import build_structure

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, HIDDEN, CLASSES = 6, 8, 4


def _graph():
    """A directed weighted graph with self-loops, parallel edges and
    vertices with no in-edges: the JAX structure and the port's."""
    rng = np.random.default_rng(5)
    n, m = 50, 260
    src = rng.integers(0, n, m)
    dst = rng.integers(10, n, m)
    src[:20] = dst[:20]
    src[20:40], dst[20:40] = src[40:60], dst[40:60]
    w = rng.uniform(0.2, 1.5, m).astype(np.float32)
    return (build_structure_host(src, dst, w, n),
            build_structure(src, dst, w, n, "cpu"), n)


def _x(n, pad_v, f=F_IN, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    xj = np.zeros((pad_v, f), np.float32)
    xj[:n] = x
    return jnp.asarray(xj), torch.from_numpy(x)


def _to_torch(params):
    """A JAX pytree as the port's: the same structure, torch tensors."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  params)


def _tree_close(got, want, **tol):
    got = jax.tree_util.tree_map(lambda t: t.detach().numpy(), got)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


LAYERS = {
    "sage": (jnn.sage_init, jnn.sage_conv, tnn.sage_init, tnn.sage_conv,
             (F_IN, HIDDEN)),
    "gcn": (jnn.gcn_init, jnn.gcn_conv, tnn.gcn_init, tnn.gcn_conv,
            (F_IN, HIDDEN)),
    "gat": (jnn.gat_init, jnn.gat_conv, tnn.gat_init, tnn.gat_conv,
            (F_IN, HIDDEN, 3)),
    "gatv2": (jnn.gatv2_init, jnn.gatv2_conv, tnn.gatv2_init,
              tnn.gatv2_conv, (F_IN, HIDDEN, 3)),
    "gin": (jnn.gin_init, jnn.gin_conv, tnn.gin_init, tnn.gin_conv,
            (F_IN, HIDDEN, CLASSES)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_matches_jax(name):
    j_init, j_conv, t_init, t_conv, dims = LAYERS[name]
    gj, gt, n = _graph()
    xj, xt = _x(n, gj.pad_v)
    pj = j_init(jax.random.key(3), *dims)
    want = np.asarray(jax.jit(j_conv)(pj, gj, xj))[:n]
    got = t_conv(_to_torch(pj), gt, xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's init draws the JAX pytree's layout and shapes
    mine = t_init(torch.Generator().manual_seed(0), *dims, device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, pj))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(pj)):
        assert tuple(a.shape) == tuple(b.shape) and a.is_contiguous()


MODELS = {
    "graphsage": (jnn.graphsage_init, jnn.graphsage_apply,
                  tnn.graphsage_init, tnn.graphsage_apply, tnn.GraphSAGE),
    "gcn": (jnn.gcn_model_init, jnn.gcn_apply, tnn.gcn_model_init,
            tnn.gcn_apply, tnn.GCN),
    "gat": (jnn.gat_model_init, jnn.gat_apply, tnn.gat_model_init,
            tnn.gat_apply, tnn.GAT),
    "gatv2": (jnn.gatv2_model_init, jnn.gatv2_apply, tnn.gatv2_model_init,
              tnn.gatv2_apply, tnn.GATv2),
    "gin": (jnn.gin_model_init, jnn.gin_apply, tnn.gin_model_init,
            tnn.gin_apply, tnn.GIN),
    "appnp": (jnn.appnp_init, jnn.appnp_apply, tnn.appnp_init,
              tnn.appnp_apply, tnn.APPNP),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_matches_jax_and_the_module(name):
    j_init, j_apply, t_init, t_apply, cls = MODELS[name]
    gj, gt, n = _graph()
    xj, xt = _x(n, gj.pad_v)
    pj = j_init(jax.random.key(4), F_IN, HIDDEN, CLASSES)
    want = np.asarray(jax.jit(j_apply)(pj, gj, xj))[:n]
    pt = _to_torch(pj)
    got = t_apply(pt, gt, xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the module on the same weights runs the same code: bit for bit
    module = cls(F_IN, HIDDEN, CLASSES, device="cpu")
    module.load_state_dict(tnn.state_dict_from_jax(
        module, jax.tree_util.tree_map(np.asarray, pj)))
    with torch.no_grad():
        assert torch.equal(module(gt, xt), got)
    # init: a generator in place of the key, the model's own weights
    gen = torch.Generator().manual_seed(1)
    mine = t_init(gen, F_IN, HIDDEN, CLASSES, device="cpu")
    twin = cls(F_IN, HIDDEN, CLASSES, device="cpu",
               generator=torch.Generator().manual_seed(1))
    _tree_close(mine, tnn.jax_params_from_state_dict(twin), rtol=0, atol=0)
    with torch.no_grad():
        assert torch.equal(t_apply(mine, gt, xt), twin(gt, xt))


def test_decoders_match_jax():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(30, F_IN)).astype(np.float32)
    s = rng.integers(0, 30, 40).astype(np.int32)
    d = rng.integers(0, 30, 40).astype(np.int32)
    rel = (np.arange(40) % 3).astype(np.int32)
    zt, st, dt, rt = map(torch.from_numpy, (z, s, d, rel))
    pm = jnn.mlp_decoder_init(jax.random.key(5), F_IN, 16)
    np.testing.assert_allclose(
        tnn.mlp_decoder(_to_torch(pm), zt, st, dt).numpy(),
        np.asarray(jnn.mlp_decoder(pm, z, s, d)), **TOL)
    pd_ = jnn.distmult_decoder_init(jax.random.key(6), F_IN, 3)
    for r, rj in ((None, None), (rt, rel)):
        np.testing.assert_allclose(
            tnn.distmult_decoder(_to_torch(pd_), zt, st, dt, r).numpy(),
            np.asarray(jnn.distmult_decoder(pd_, z, s, d, rj)), **TOL)
    for t_init, j_params, args in ((tnn.mlp_decoder_init, pm, (F_IN, 16)),
                                   (tnn.distmult_decoder_init, pd_,
                                    (F_IN, 3))):
        mine = t_init(torch.Generator().manual_seed(0), *args, device="cpu")
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in j_params.items()}


@pytest.mark.parametrize("name", ["graphsage", "gcn"])
def test_functional_training_matches_optax(name):
    j_init, j_apply, _, t_apply, _ = MODELS[name]
    gj, gt, n = _graph()
    xj, xt = _x(n, gj.pad_v)
    rng = np.random.default_rng(7)
    labels = rng.integers(0, CLASSES, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    pad = gj.pad_v
    lj = jnp.zeros(pad, jnp.int32).at[:n].set(labels)
    mj = jnp.zeros(pad, bool).at[:n].set(mask)
    lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)
    pj = j_init(jax.random.key(8), F_IN, HIDDEN, CLASSES)
    pt = _to_torch(pj)
    before = [v.clone() for v in jax.tree_util.tree_leaves(pt)]
    opt = optax.adam(1e-2)
    sj = opt.init(pj)
    step_j = jax.jit(jnn.make_train_step(j_apply, opt))
    step_t = tnn.make_train_step(t_apply,
                                 lambda ps: torch.optim.Adam(ps, lr=1e-2))
    st, losses_j, losses_t = None, [], []
    qt = pt
    for _ in range(10):
        pj, sj, loss = step_j(pj, sj, gj, xj, lj, mj)
        losses_j.append(float(loss))
        qt, st, loss = step_t(qt, st, gt, xt, lt, mt)
        losses_t.append(float(loss))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    _tree_close(qt, pj, rtol=0, atol=1e-4)
    # the caller's first params are copied, not trained in place
    for a, b in zip(jax.tree_util.tree_leaves(pt), before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="previous step"):
        step_t(pt, st, gt, xt, lt, mt)


@pytest.mark.parametrize("decoder", ["dot", "mlp"])
def test_functional_linkpred_matches_optax(decoder):
    gj, gt, n = _graph()
    xj, xt = _x(n, gj.pad_v)
    rng = np.random.default_rng(9)
    pairs = [rng.integers(0, n, 30).astype(np.int32) for _ in range(4)]
    params = {"encoder": jnn.graphsage_init(jax.random.key(10), F_IN,
                                            HIDDEN, HIDDEN)}
    dec_j, dec_t = jnn.dot_decoder, tnn.dot_decoder
    if decoder == "mlp":
        params["decoder"] = jnn.mlp_decoder_init(jax.random.key(11), HIDDEN,
                                                 16)
        dec_j, dec_t = jnn.mlp_decoder, tnn.mlp_decoder
    opt = optax.adam(1e-2)
    sj = opt.init(params)
    step_j = jax.jit(jnn.make_linkpred_train_step(jnn.graphsage_apply, dec_j,
                                                  opt))
    step_t = tnn.make_linkpred_train_step(
        tnn.graphsage_apply, dec_t, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    pt, st, losses_j, losses_t = _to_torch(params), None, [], []
    for _ in range(5):
        params, sj, loss = step_j(params, sj, gj, xj,
                                  *map(jnp.asarray, pairs))
        losses_j.append(float(loss))
        pt, st, loss = step_t(pt, st, gt, xt, *map(torch.from_numpy, pairs))
        losses_t.append(float(loss))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    _tree_close(pt, params, rtol=0, atol=1e-4)
