"""The port's MG plc layer (``MGGraph`` and the MG branches of the plc
wrappers) against ``cugraph_tpu.plc`` on a JAX mesh of the same shape.

Each world (2×2, 2×1 and 1×2 gloo processes) runs
``torch_port_plc_mg.plc_body`` once in a module-scoped fixture; the 2×2
world runs every call of ``CALLS``, the rectangular ones a cut
(``RECT``).  Each case builds the same two ``MGGraph``s through the JAX
package on ``jax.devices()[:P]`` and makes the same call.

Bounds, those of the ``test_torch_parallel_*`` files for the function
each branch calls: the power methods within rtol 1e-5, atol 1e-7
("power"); betweenness within rtol 1e-5 ("bc", "edge_bc", the edge
frames after a lexsort); the edge lists of the k-core, k-truss, induced
subgraph and decompressed or replicated COO after a lexsort ("edges": the
port's blocks order a dst slot's edges by source); Louvain's and
Leiden's labels bit for bit with the modularity within 1e-7
("community"); everything else bit for bit with its dtype ("exact").
The random wrappers ("random") run the draws of the port's own
generators, so each is held bit for bit against the port's direct
``parallel`` call on the wrapper's seed (that call is held against the
JAX package's draws in ``test_torch_parallel_sampling.py``) and against
the JAX frame's columns and dtypes.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cugraph_tpu import plc as jplc
from cugraph_tpu.parallel.mesh import make_mesh_2d

from torch_port_mg import WORLDS, run_worlds
from torch_port_plc_mg import CALLS, DIRECT, SG_ONLY, build_graphs, flatten

torch.set_num_threads(1)
POWER = dict(rtol=1e-5, atol=1e-7)
BC = dict(rtol=1e-5, atol=1e-7)
NAMES = sorted(CALLS)
RECT = sorted(["pagerank", "bfs_multisource", "sssp", "core_number",
               "weakly_connected_components", "jaccard_coefficients",
               "all_pairs_jaccard_coefficients", "triangle_count",
               "degrees", "edge_id_lookup_table", "louvain",
               "decompress_to_edgelist", "egonet",
               "homogeneous_uniform_neighbor_sample",
               "heterogeneous_biased_temporal_neighbor_sample"])
WORLD_CALLS = {(2, 2): NAMES, (2, 1): RECT, (1, 2): RECT}
PAIRS = [(shape, name) for shape, names in WORLD_CALLS.items()
         for name in names]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from torch_port_plc_mg import plc_body

    return run_worlds(tmp_path_factory.mktemp("plc_mg"), plc_body,
                      {shape: (names,) for shape, names in
                       WORLD_CALLS.items()})


@functools.lru_cache(maxsize=None)
def _jax_graphs(pmaj, pmin):
    h = jplc.ResourceHandle(mesh=make_mesh_2d(pmaj, pmin,
                                              jax.devices()[:pmaj * pmin]))
    return (h, *build_graphs(jplc, h))


def _jax(name, pmaj, pmin):
    return flatten(CALLS[name][0](jplc, *_jax_graphs(pmaj, pmin)))


def _got(res, name):
    head = f"call/{name}/"
    return {k[len(head):]: v for k, v in res.items() if k.startswith(head)}


def _lexsorted(d, keys):
    """The per-edge arrays of ``d`` sorted by ``keys``; the others (an
    offsets array) as they are."""
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {k: v[order] if len(v) == len(order) else v
            for k, v in d.items()}


def _segments(d):
    """(src, dst, w, offsets) lists, each segment's edges lexsorted."""
    off = d["3"].astype(np.int64)
    seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
    order = np.lexsort((d["2"], d["1"], d["0"], seg))
    return {**{k: d[k][order] for k in ("0", "1", "2")}, "3": off}


def _hold_exact(got, want):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k, a in got.items():
        b = want[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _hold(name, how, got, want):
    if how == "exact" and name in ("egonet", "ego_graph"):
        got, want = _segments(got), _segments(want)
    if how == "exact":
        _hold_exact(got, want)
    elif how in ("power", "bc"):
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["0"], want["0"])
        for k in sorted(got)[1:]:
            np.testing.assert_allclose(got[k], want[k],
                                       **(POWER if how == "power" else BC))
    elif how == "edge_bc":
        got, want = (_lexsorted(d, ["0", "1"]) for d in (got, want))
        _hold_exact({k: got[k] for k in ("0", "1")},
                    {k: want[k] for k in ("0", "1")})
        np.testing.assert_allclose(got["2"], want["2"], **BC)
    elif how == "edges":
        keys = [k for k in ("0", "1", "2") if k in got]
        _hold_exact(_lexsorted(got, keys), _lexsorted(want, keys))
    elif how == "community":
        _hold_exact({k: got[k] for k in ("0", "1")},
                    {k: want[k] for k in ("0", "1")})
        assert abs(float(got["2"]) - float(want["2"])) <= 1e-7
    else:
        assert how == "random"
        assert got.keys() == want.keys(), (sorted(got), sorted(want))
        for k, a in got.items():
            assert a.dtype == want[k].dtype, (k, a.dtype, want[k].dtype)


@pytest.mark.parametrize("shape,name", PAIRS,
                         ids=[f"{a}x{b}-{n}" for (a, b), n in PAIRS])
def test_mg_branch_matches_jax(worlds, shape, name):
    res = worlds[shape]
    _hold(name, CALLS[name][1], _got(res, name), _jax(name, *shape))
    if name in DIRECT:
        assert bool(res[f"direct/{name}"]), "differs from the direct call"


@pytest.mark.parametrize("shape", WORLDS, ids=[f"{a}x{b}" for a, b in
                                               WORLDS])
def test_sg_only_wrappers_raise(worlds, shape):
    for name in SG_ONLY:
        assert bool(worlds[shape][f"raises/{name}"]), name


@pytest.mark.parametrize("shape", WORLDS, ids=[f"{a}x{b}" for a, b in
                                               WORLDS])
def test_builds_match_the_direct_ones(worlds, shape):
    """The host build equals ``build_dist_graph`` on the same COO, and
    the sharded build (chunk lists and a plain array) equals
    ``build_dist_graph_from_chunks`` tensor for tensor, with the same
    number map and build statistics; the sharded graph's id table and
    lookup answer in external ids."""
    from torch_port_plc_mg import coo

    res = worlds[shape]
    assert bool(res["build/host"]) and bool(res["build/sharded"])
    src, dst, *_ = coo()
    np.testing.assert_array_equal(
        res["sharded/lookup"], [[src[0] * 1000 + 7, dst[0] * 1000 + 7],
                                [src[3] * 1000 + 7, dst[3] * 1000 + 7],
                                [src[99] * 1000 + 7, dst[99] * 1000 + 7],
                                [-1, -1]])
    ext = np.concatenate([src, dst]) * 1000 + 7
    np.testing.assert_array_equal(res["sharded/has_vertex"],
                                  np.isin([7, 8, 1007, 10**9], ext))
    np.testing.assert_array_equal(res["sharded/edge_ids"], np.arange(9))


@pytest.mark.parametrize("shape,name", [
    (s, n) for s, names in WORLD_CALLS.items() for n in names
    if "temporal" in n], ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(
        v, tuple) else v)
def test_temporal_per_seed_times(worlds, shape, name):
    """An all-equal per-seed start-time array gives the scalar's rows;
    the JAX MG branch raises on one (it calls ``float`` on it)."""
    assert bool(worlds[shape][f"temporal_array/{name}"])
    h, g, gu = _jax_graphs(*shape)
    from torch_port_plc_mg import SEEDS, TIME, _fanout

    with pytest.raises(TypeError):
        getattr(jplc, name)(h, g, "edge_time", SEEDS,
                            np.full(len(SEEDS), TIME), None, _fanout(name),
                            num_edge_types=3 if name.startswith(
                                "heterogeneous") else None, random_state=3)


@pytest.mark.parametrize("symmetrize", [False, True])
def test_edge_id_table_matches_jax(symmetrize):
    """The sorted (src·pad_v + dst) → edge id table, mirrored edges
    inheriting their input edge's id under ``symmetrize``."""
    from cugraph_tpu_torch.plc.graphs import MGGraph
    from torch_port_plc_mg import coo

    src, dst, *_ = coo()
    ids = np.arange(len(src), dtype=np.int64)[::-1].copy()
    args = (src.astype(np.int64), dst.astype(np.int64), ids, 48)
    got = MGGraph._build_edge_id_table(*args, symmetrize=symmetrize)
    want = jplc.MGGraph._build_edge_id_table(*args, symmetrize=symmetrize)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sparse_id_space_check():
    """The host build rejects an id space more than 4× its distinct
    endpoint ids above 2^24; a dense space of average degree below 0.25,
    which the JAX package's edge-count rule rejects, passes."""
    from cugraph_tpu_torch.plc.graphs import _dense_id_space, check_id_space

    check_id_space(20_000_000, 20_000_000)     # 4 M edges would do here
    check_id_space(1 << 24, 1)                  # at the floor
    with pytest.raises(ValueError, match="sparse"):
        check_id_space((1 << 24) + 1, 10)
    with pytest.raises(ValueError, match="sparse"):
        check_id_space(1 << 33, 1 << 30)
    with pytest.raises(ValueError, match="sparse"):
        _dense_id_space(np.array([0, 1 << 25]), np.array([1, 2]))
    assert _dense_id_space(np.array([0, 5]), np.array([1, 2])) == 6
    # the JAX rule on the dense 20 M-vertex, 4 M-edge graph
    assert 20_000_000 > max(4 * (4_000_000 + 1), 1 << 24)
