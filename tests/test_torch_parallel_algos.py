"""The multi-device port's vertex programs against ``cugraph_tpu.parallel``.

Each world (2×2, 2×1 and 1×2 gloo processes; the rectangular ones catch a
"major"/"minor" mix-up a square mesh hides) runs every algorithm once in
a module-scoped fixture (``torch_port_mg.algos_body``); each case below
compares one gathered result with the JAX package's on a mesh of the same
shape over ``jax.devices()[:P]`` (conftest gives 8 CPU devices).

Bounds: the power methods within rtol 1e-5, atol 1e-7 of the JAX MG
result, with iteration counts within 1 (float32 sums in another order
move the stopping test's value in its last bits); BFS, WCC and the SSSP
distances and predecessors bit for bit (K2 and the predecessor test are
exact; the weights are in [0.5, 2.0]); degrees within rtol 1e-6; the
shard primitives against the JAX package's inside a shard_map (below).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cugraph_tpu import parallel as jp

from torch_port_mg import (GRAPHS, WORLDS, algos_body, prims_inputs,
                           run_worlds, symmetric)

torch.set_num_threads(1)
POWER = dict(rtol=1e-5, atol=1e-7)
NAMES = sorted(GRAPHS)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("algos"), algos_body,
                      {shape: (GRAPHS,) for shape in WORLDS})


@pytest.fixture(params=WORLDS, ids=[f"{a}x{b}" for a, b in WORLDS])
def world(request, worlds):
    return (*request.param, worlds[request.param])


@functools.lru_cache(maxsize=None)
def _mesh(pmaj, pmin):
    return jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])


@functools.lru_cache(maxsize=None)
def _graph(name, pmaj, pmin, sym=False, zero=False):
    src, dst, w, n = GRAPHS[name]
    if sym:
        src, dst = symmetric(src, dst, n)
        w = None
    if zero:
        w = w.copy()
        w[::3] = 0.0
    return jp.build_dist_graph(src, dst, w, n, pmaj, pmin,
                               store_push=not sym)


def _np(values):
    return [np.asarray(v) for v in values]


def _jax(name, method, pmaj, pmin):
    mesh = _mesh(pmaj, pmin)
    src = GRAPHS[name][0]
    if method == "eigenvector":
        return _np(jp.mg_eigenvector_centrality(
            _graph(name, pmaj, pmin, sym=True), mesh, tol=1e-6,
            max_iter=500))
    g = _graph(name, pmaj, pmin)
    return _np({
        "pagerank": lambda: jp.mg_pagerank(g, mesh, tol=1e-6, max_iter=200),
        "katz": lambda: jp.mg_katz_centrality(g, mesh, alpha=0.01, tol=1e-5,
                                              max_iter=500),
        "hits": lambda: jp.mg_hits(g, mesh, tol=1e-4, max_iter=300),
        "degrees": lambda: jp.mg_degrees(g, mesh),
        "bfs": lambda: jp.mg_bfs(g, mesh, int(src[0])),
        "sssp": lambda: jp.mg_sssp(g, mesh, int(src[0])),
        "wcc": lambda: (jp.mg_wcc(g, mesh),),
    }[method]())


def _got(got, key, count):
    return [got[f"{key}/{k}"] for k in range(count)]


def _hold_power(got, want):
    """Vectors within POWER, then (err, iterations): iterations within 1."""
    vectors = len(want) - 2
    for a, b in zip(got[:vectors], want[:vectors]):
        np.testing.assert_allclose(a, b, **POWER)
    assert abs(int(got[-1]) - int(want[-1])) <= 1, (got[-1], want[-1])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("method", ["pagerank", "katz", "hits",
                                    "eigenvector"])
def test_power_method(world, name, method):
    pmaj, pmin, got = world
    want = _jax(name, method, pmaj, pmin)
    _hold_power(_got(got, f"{name}/{method}", len(want)), want)


@pytest.mark.parametrize("name", NAMES)
def test_degrees(world, name):
    pmaj, pmin, got = world
    for a, b in zip(_got(got, f"{name}/degrees", 2),
                    _jax(name, "degrees", pmaj, pmin)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("method", ["bfs", "sssp", "wcc"])
def test_traversal_bit_for_bit(world, name, method):
    pmaj, pmin, got = world
    want = _jax(name, method, pmaj, pmin)
    for a, b in zip(_got(got, f"{name}/{method}", len(want)), want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_options(world):
    """personalization, nstart, alpha, unnormalised HITS and Katz, a
    multi-root BFS with a depth limit and -1 padding, an SSSP cutoff."""
    pmaj, pmin, got = world
    mesh = _mesh(pmaj, pmin)
    g = _graph("weighted", pmaj, pmin)
    src, dst, _, n = GRAPHS["weighted"]
    pers = np.zeros(n, np.float32)
    pers[[3, 7, 11]] = [1.0, 2.0, 3.0]
    want = _np(jp.mg_pagerank(g, mesh, alpha=0.7, tol=1e-6,
                              personalization=pers,
                              nstart=np.linspace(1.0, 2.0, n)))
    _hold_power(_got(got, "options/pagerank", 3), want)
    want = _np(jp.mg_hits(g, mesh, tol=1e-4, normalized=False,
                          nstart=np.linspace(1.0, 2.0, n)))
    _hold_power(_got(got, "options/hits", 4), want)
    want = _np(jp.mg_katz_centrality(g, mesh, alpha=0.01, normalized=False))
    _hold_power(_got(got, "options/katz", 3), want)
    for key, want in (
            ("bfs", jp.mg_bfs(g, mesh, [int(src[0]), int(dst[5]), -1],
                              depth_limit=2)),
            ("sssp", jp.mg_sssp(g, mesh, int(src[0]), cutoff=2.5))):
        for a, b in zip(_got(got, f"options/{key}", 2), _np(want)):
            np.testing.assert_array_equal(a, b)


def test_sssp_zero_weights_match_jax(world):
    """With zero-weight edges the exact-equality predecessor rule of the
    JAX package can point along a zero-weight cycle (ROADMAP §3); the
    port keeps that rule, so it agrees bit for bit there too."""
    pmaj, pmin, got = world
    src = GRAPHS["weighted"][0]
    want = _np(jp.mg_sssp(_graph("weighted", pmaj, pmin, zero=True),
                          _mesh(pmaj, pmin), int(src[0])))
    for a, b in zip(_got(got, "zero/sssp", 2), want):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_prims(name, pmaj, pmin):
    """The JAX package's prims inside one shard_map over the stacked pull
    blocks, on ``torch_port_mg.prims_inputs``; outputs in owner order."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cugraph_tpu.parallel import prims as jpr

    mesh, g = _mesh(pmaj, pmin), _graph(name, pmaj, pmin)
    chunk = g.chunk
    es, vs = P("major", "minor"), P(("major", "minor"))

    def body(sl, dl, w, valid, x, x2, part, part2, s):
        sl, dl, w, valid = sl[0, 0], dl[0, 0], w[0, 0], valid[0, 0]
        return (jpr.pull_spmv(sl, dl, w, x, pmaj=pmaj, chunk=chunk),
                jpr.pull_spmv_systolic(sl, dl, w, x, pmaj=pmaj, pmin=pmin,
                                       chunk=chunk),
                jpr.pull_transform_reduce(
                    sl, dl, valid, x, lambda xs, e: xs * w[e], pmaj=pmaj,
                    chunk=chunk, op="max", identity=-5.0),
                jpr.pull_spmm(sl, dl, w, x2, pmaj=pmaj, chunk=chunk),
                jpr.gather_minor_block(x), jpr.gather_major_block(x),
                jpr.scatter_reduce_major_sum(part),
                jpr.scatter_reduce_major(part, chunk, "min"),
                jpr.scatter_reduce_major(part, chunk, "max"),
                jpr.scatter_reduce_minor_sum(part2),
                jpr.global_vertex_ids(chunk), jpr.psum_all(s[0]))

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(es,) * 4 + (vs,) * 5,
                              out_specs=(vs,) * 11 + (P(),)))
    inputs = prims_inputs(g.pad_v, pmaj, pmin)
    ranks = np.arange(1, pmaj * pmin + 1, dtype=np.float32)
    put = [jax.device_put(a, NamedSharding(mesh, vs)) for a in inputs
           + (ranks,)]
    return _np(f(g.pull.src_loc, g.pull.dst_loc, g.pull.weight,
                 g.pull.valid, *put))


@pytest.mark.parametrize("name", NAMES)
def test_primitives_match_jax(world, name):
    """Every shard primitive against the JAX package's inside a shard_map
    on the same inputs: the pulls (K1, K4 and the systolic ring through
    their plain versions here) within rtol 1e-5, atol 1e-6 (float32 sums
    in other orders), the gathers, min/max scatters, ids and the scalar
    exactly, the sum scatters within rtol 1e-6; and ``pull_spmv``
    against float64 NumPy over the COO."""
    pmaj, pmin, got = world
    mine = _got(got, f"{name}/spmv", 12)
    want = _jax_prims(name, pmaj, pmin)
    for k, (a, b) in enumerate(zip(mine, want)):
        assert np.shape(a) == np.shape(b), k
        if k in (0, 1, 3):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        elif k in (6, 9):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(a, b)
    src, dst, w, n = GRAPHS[name]
    w = np.ones(len(src)) if w is None else w.astype(np.float64)
    x = prims_inputs(len(mine[0]), pmaj, pmin)[0].astype(np.float64)
    ref = np.zeros(len(x))
    np.add.at(ref, dst, w * x[src])
    np.testing.assert_allclose(mine[0], ref, rtol=1e-5, atol=1e-6)
