"""The multi-device port's GNN layers and training against
``cugraph_tpu.parallel.nn``.

Each world (2×2, 2×1, 1×2 gloo processes) runs ``torch_port_mg.nn_body``
once, on ``tests/test_parallel.py``'s weighted random graph (n = 60,
m = 400, seed 20) and on the skewed graph (ranks with empty blocks), with
the JAX package's initial weights carried across as NumPy.

Bounds: the forward passes within rtol 2e-4, atol 2e-4 of the JAX MG
layers (``tests/test_parallel.py:643-760``'s bounds: float32 sums in
other orders through two layers); five ``make_mg_train_step`` steps
against the JAX step with ``optax.adam(1e-2)``: losses within rtol 1e-5,
weights within atol 1e-4 (Adam's update is near ±lr where a gradient is
small, so a 1e-7 gradient difference moves a weight by far more); the
input gradient through GAT's collectives within rtol 2e-4, atol 2e-4 of
``jax.grad`` through the shard_map.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugraph_tpu import parallel as jp
from cugraph_tpu.nn import (gat_init, gatv2_init, gcn_model_init, gin_init,
                            graphsage_init)
from cugraph_tpu.parallel import nn as jnn
from cugraph_tpu.parallel.mesh import shard_dist_graph

from torch_port_mg import (WORLDS, nn_body, random_coo, run_worlds,
                           skew_coo)

torch.set_num_threads(1)
FWD = dict(rtol=2e-4, atol=2e-4)
F, H, C = 6, 12, 3
STEPS = 5
GRAPHS = {"weighted": random_coo(n=60, m=400, seed=20), "skew": skew_coo()}
N_MAX = max(n for *_, n in GRAPHS.values())
LAYERS = ["sage", "gcn", "gat", "gatv2", "gin", "appnp", "mean", "sum",
          "sage_conv", "gcn_conv"]


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_MAX, F)).astype(np.float32)
    labels = rng.integers(0, C, N_MAX).astype(np.int32)
    mask = rng.random(N_MAX) < 0.6
    params = {
        "sage": graphsage_init(jax.random.key(0), F, H, C),
        "gcn": gcn_model_init(jax.random.key(1), F, H, C),
        "gat": gat_init(jax.random.key(2), F, 5, num_heads=3),
        "gatv2": gatv2_init(jax.random.key(3), F, 5, num_heads=3),
        "gin": gin_init(jax.random.key(4), F, 10, 4),
    }
    return x, labels, mask, jax.tree.map(np.asarray, params)


X, LABELS, MASK, PARAMS = _inputs()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("nn"), nn_body,
                      {shape: (GRAPHS, X, LABELS, MASK, PARAMS, STEPS) for shape in WORLDS})


@pytest.fixture(params=WORLDS, ids=[f"{a}x{b}" for a, b in WORLDS])
def world(request, worlds):
    return (*request.param, worlds[request.param])


@functools.lru_cache(maxsize=None)
def _setup(name, pmaj, pmin):
    """The JAX mesh, the sharded graph, and x, labels, mask sharded."""
    mesh = jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])
    src, dst, w, n = GRAPHS[name]
    g = shard_dist_graph(jp.build_dist_graph(src, dst, w, n, pmaj, pmin,
                                             store_push=False), mesh)

    def pad(a):
        out = np.zeros((g.pad_v,) + a.shape[1:], a.dtype)
        out[:n] = a[:n]
        return out

    x, labels, mask = jnn.shard_vertex_data(
        mesh, jnp.asarray(pad(X)), jnp.asarray(pad(LABELS)),
        jnp.asarray(pad(MASK)))
    return mesh, g, x, labels, mask


def _forward(layer, name, pmaj, pmin):
    mesh, g, x, _, _ = _setup(name, pmaj, pmin)
    p = jnn.replicate(mesh, PARAMS.get(layer, {}))
    return np.asarray({
        "sage": lambda: jnn.mg_graphsage_apply(p, g, mesh, x),
        "gcn": lambda: jnn.mg_gcn_apply(p, g, mesh, x),
        "gat": lambda: jnn.mg_gat_conv(p, g, mesh, x),
        "gatv2": lambda: jnn.mg_gatv2_conv(p, g, mesh, x),
        "gin": lambda: jnn.mg_gin_conv(p, g, mesh, x),
        "appnp": lambda: jnn.mg_appnp_propagate(g, mesh, x, alpha=0.15, k=4),
        "mean": lambda: jnn.mg_aggregate_mean(g, mesh, x),
        "sum": lambda: jnn.mg_aggregate_sum(g, mesh, x),
        "sage_conv": lambda: jnn.mg_sage_conv(
            jnn.replicate(mesh, PARAMS["sage"][0]), g, mesh, x),
        "gcn_conv": lambda: jnn.mg_gcn_conv(
            jnn.replicate(mesh, PARAMS["gcn"][0]), g, mesh, x),
    }[layer]())


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("layer", LAYERS)
def test_forward_matches_jax(world, layer, name):
    pmaj, pmin, got = world
    np.testing.assert_allclose(got[f"{name}/{layer}"],
                               _forward(layer, name, pmaj, pmin), **FWD)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_masked_cross_entropy_matches_jax(world, name):
    """The ranks' shares of ``mg_masked_cross_entropy`` add up to the JAX
    package's value on the global arrays (rtol 1e-5)."""
    pmaj, pmin, got = world
    mesh, g, x, labels, mask = _setup(name, pmaj, pmin)
    logits = jnn.mg_graphsage_apply(jnn.replicate(mesh, PARAMS["sage"]), g,
                                    mesh, x)
    want = float(jnn.mg_masked_cross_entropy(logits, labels, mask))
    np.testing.assert_allclose(float(got[f"{name}/ce"]), want, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_train_steps_match_optax(world, name):
    pmaj, pmin, got = world
    mesh, g, x, labels, mask = _setup(name, pmaj, pmin)
    params = jnn.replicate(mesh, PARAMS["sage"])
    opt = optax.adam(1e-2)
    opt_state = jnn.replicate(mesh, opt.init(params))
    step = jnn.make_mg_train_step(g, mesh, opt)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, x, labels, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(got[f"{name}/losses"], losses, rtol=1e-5)
    assert got[f"{name}/losses"][-1] < got[f"{name}/losses"][0]
    for k, layer in enumerate(params):
        for key, want in layer.items():
            np.testing.assert_allclose(got[f"{name}/weights/{k}/{key}"],
                                       np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_attention_gradient_matches_jax(world, name):
    pmaj, pmin, got = world
    mesh, g, x, _, _ = _setup(name, pmaj, pmin)
    p = jnn.replicate(mesh, PARAMS["gat"])
    want = jax.grad(lambda xx: jnp.sum(
        jnn.mg_gat_conv(p, g, mesh, xx) ** 2))(x)
    np.testing.assert_allclose(got[f"{name}/gat_grad"], np.asarray(want),
                               **FWD)
