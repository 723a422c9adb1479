"""The multi-device port's sharded construction, renumbering and shuffle
against ``cugraph_tpu.parallel``.

Each world (2×2, 2×1, 1×2 gloo processes) runs
``torch_port_mg.construct_body`` once: ``tests/test_construct_sharded.py``'s
cases, each rank passing its own ``np.array_split`` chunk, and
``tests/test_shuffle.py``'s, each rank its contiguous slice of the global
keys; the JAX package runs the same cases on a mesh of the same shape.

Bounds: every rank's block holds the JAX block's valid lanes, as
(dst_loc, src_loc, weight) triples sorted (lane order within a dst slot
is no invariant of the JAX builds), and its offsets count them per slot;
degrees within rtol 1e-6; internal ids equal; the sharded build's
largest live exchange within ``tests/test_construct_sharded.py``'s O(E/P)
bound; the ingest's PageRank within rtol 1e-5, atol 1e-7; the shuffle's
arrivals equal to the JAX result's valid slots in order, the keyed sums
within rtol 1e-5 and min/max exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cugraph_tpu import parallel as jp
from cugraph_tpu.parallel.partition import Partition2D as JaxPartition2D
from cugraph_tpu.parallel.shuffle import (shuffle_reduce_by_key,
                                          shuffle_to_owners)

from torch_port_mg import GRAPHS, WORLDS, construct_body, run_worlds

torch.set_num_threads(1)
MAX_P = max(a * b for a, b in WORLDS)


def _coo(n, m, seed, unique=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, n, m).astype(np.int64)
    if unique:
        k = np.unique(src * n + dst)
        src, dst = k // n, k % n
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return src, dst, w


FLAGS = {
    "plain": dict(),
    "symmetrize": dict(symmetrize=True),
    "dedupe": dict(drop_self_loops=True, drop_multi_edges=True),
    "sym_dedupe": dict(symmetrize=True, drop_multi_edges=True),
}


def _build_cases(p):
    """Each case's full arrays; the chunks are ``np.array_split`` by p."""
    cases = {}
    src, dst, w = _coo(300, 2400, 3)
    for name, flags in FLAGS.items():
        cases[name] = ({"src": src, "dst": dst, "w": w}, 300, flags)
    src, dst, w = _coo(120, 700, 5)
    cases["props"] = ({"src": src, "dst": dst, "w": w,
                       "etype": (src * 7 + dst) % 3,
                       "etime": (src + 2.0 * dst).astype(np.float32)},
                      120, {})
    src, dst, w = _coo(1000, 16000, 7, unique=False)
    cases["memory"] = ({"src": src, "dst": dst, "w": w}, 1000, {})
    src, dst, w, n = GRAPHS["skew"]
    cases["skew"] = ({"src": src, "dst": dst, "w": w}, n, {})
    return cases


def _renumber_case():
    rng = np.random.default_rng(11)
    pool = np.concatenate([rng.integers(-(1 << 40), 1 << 40, 300),
                           rng.integers(0, 50, 100)])
    return rng.choice(pool, 2000), rng.choice(pool, 2000)


def _ingest_case():
    rng = np.random.default_rng(23)
    ext_ids = rng.choice(np.arange(10**6), 400, replace=False)
    src, dst = rng.choice(ext_ids, 3000), rng.choice(ext_ids, 3000)
    keep = src != dst
    k = np.unique(src[keep] * (10**6) + dst[keep])
    src, dst = k // (10**6), k % (10**6)
    return src, dst, rng.uniform(0.5, 2.0, len(src)).astype(np.float32)


def _shuffle_cases(p):
    rng = np.random.default_rng(0)
    keys = np.full(p * 200, -1, np.int32)
    keys[:300] = rng.integers(0, 100, 300)
    route = (keys, np.where(keys >= 0, keys * 2.0, 0.0).astype(np.float32),
             100, None)
    hot = np.full(p * 100, -1, np.int32)
    hot[:200] = 3
    rng = np.random.default_rng(1)
    rk = np.full(p * 256, -1, np.int32)
    rk[:500] = rng.integers(0, 50, 500)
    vals = np.zeros(p * 256, np.float32)
    vals[:500] = rng.random(500).astype(np.float32)
    return {"route": route, "hot": (hot, np.ones(p * 100, np.float32), 100,
                                    None),
            "sum": (rk, vals, 50, "sum"), "min": (rk, vals, 50, "min"),
            "max": (rk, vals, 50, "max")}


def _split(arrays, p):
    return {k: [np.asarray(c) for c in np.array_split(v, p)]
            for k, v in arrays.items()}


def _world_args(p):
    cases = {name: (_split(arrays, p), n, flags)
             for name, (arrays, n, flags) in _build_cases(p).items()}
    rs, rd = _renumber_case()
    return (cases, _split({"src": rs, "dst": rd}, p),
            _split(dict(zip(("src", "dst", "w"), _ingest_case())), p),
            _shuffle_cases(p))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("construct"), construct_body,
                      {(a, b): _world_args(a * b) for a, b in WORLDS})


@pytest.fixture(params=WORLDS, ids=[f"{a}x{b}" for a, b in WORLDS])
def world(request, worlds):
    return (*request.param, worlds[request.param])


@functools.lru_cache(maxsize=None)
def _mesh(pmaj, pmin):
    return jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])


@functools.lru_cache(maxsize=None)
def _jax_build(name, pmaj, pmin):
    p = pmaj * pmin
    arrays, n, flags = _build_cases(p)[name]
    ch = _split(arrays, p)
    return jp.build_dist_graph_sharded(
        _mesh(pmaj, pmin), ch["src"], ch["dst"], ch["w"], num_vertices=n,
        store_push=True, edge_type_chunks=ch.get("etype"),
        edge_time_chunks=ch.get("etime"), **flags)


def _triples(offsets, indices, *cols):
    """(dst slot, src_loc, cols...) of a CSR, sorted."""
    rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    t = np.stack([rows, indices.astype(np.int64)]
                 + [c.astype(np.float64) for c in cols])
    return t[:, np.lexsort(t[::-1])]


def hold_blocks(got, prefix, jax_blocks, pmaj, pmin, fields=("weights",)):
    """Every rank's CSR against the JAX block's valid lanes."""
    jf = {"weights": "weight", "etype": "etype", "etime": "etime",
          "eid": "eid"}
    for i in range(pmaj):
        for j in range(pmin):
            r = i * pmin + j
            off = got[f"{prefix}/{r}/offsets"]
            v = np.asarray(jax_blocks.valid)[i, j]
            dl = np.asarray(jax_blocks.dst_loc)[i, j][v]
            np.testing.assert_array_equal(
                np.diff(off), np.bincount(dl, minlength=len(off) - 1))
            mine = _triples(off, got[f"{prefix}/{r}/indices"],
                            *[got[f"{prefix}/{r}/{f}"] for f in fields])
            rows = np.stack([dl, np.asarray(jax_blocks.src_loc)[i, j][v]]
                            + [np.asarray(getattr(jax_blocks, jf[f]))[i, j][v]
                               .astype(np.float64) for f in fields])
            np.testing.assert_array_equal(mine, rows[:, np.lexsort(rows[::-1])])


@pytest.mark.parametrize("name", sorted(_build_cases(MAX_P)))
def test_sharded_build_matches_jax(world, name):
    pmaj, pmin, got = world
    g, stats = _jax_build(name, pmaj, pmin)
    fields = ("weights", "etype", "etime") if name == "props" else \
        ("weights",)
    hold_blocks(got, f"{name}/pull", g.pull, pmaj, pmin, fields)
    hold_blocks(got, f"{name}/push", g.push, pmaj, pmin, fields)
    num_edges, chunk, _ = got[f"{name}/meta"]
    assert (num_edges, chunk) == (g.num_edges, g.chunk)
    np.testing.assert_allclose(got[f"{name}/out_degree"],
                               np.asarray(g.out_degree), rtol=1e-6)
    np.testing.assert_allclose(got[f"{name}/in_degree"],
                               np.asarray(g.in_degree), rtol=1e-6)


def test_sharded_build_memory_bound(world):
    """The largest live exchange stays O(E/P):
    ``tests/test_construct_sharded.py``'s bound with this world's P."""
    pmaj, pmin, got = world
    p = pmaj * pmin
    e_total = len(_build_cases(p)["memory"][0]["src"])
    per_field = 2 * e_total // p + p * 128 + 256
    num_edges, _, peak = got["memory/meta"]
    assert num_edges == e_total
    assert peak <= 2 * 3 * per_field, (peak, e_total)


def test_host_build_matches_jax(world):
    """``build_dist_graph`` from the replicated COO of the skewed graph
    (empty blocks) against the JAX host build."""
    pmaj, pmin, got = world
    src, dst, w, n = GRAPHS["skew"]
    g = jp.build_dist_graph(src, dst, w, n, pmaj, pmin)
    hold_blocks(got, "host_skew/pull", g.pull, pmaj, pmin)


def test_renumber_matches_jax(world):
    pmaj, pmin, got = world
    p = pmaj * pmin
    rs, rd = _renumber_case()
    si, di, nmap = jp.renumber_edgelist_sharded(
        _mesh(pmaj, pmin), np.array_split(rs, p), np.array_split(rd, p))
    np.testing.assert_array_equal(got["renumber/src"], np.concatenate(si))
    np.testing.assert_array_equal(got["renumber/dst"], np.concatenate(di))
    assert int(got["renumber/n"]) == nmap.num_vertices == len(
        np.unique(np.concatenate([rs, rd])))
    np.testing.assert_array_equal(got["renumber/to_external"],
                                  np.concatenate([
                                      np.concatenate([a, b]) for a, b in
                                      zip(np.array_split(rs, p),
                                          np.array_split(rd, p))]))
    np.testing.assert_array_equal(got["renumber/to_internal"],
                                  np.concatenate(si))
    np.testing.assert_array_equal(got["renumber/contains"], [True, False])
    assert got["renumber/raises/to_internal"]
    assert got["renumber/raises/to_external"]


def test_ingest_pagerank_matches_jax(world):
    pmaj, pmin, got = world
    p = pmaj * pmin
    src, dst, w = _ingest_case()
    mesh = _mesh(pmaj, pmin)
    g, nmap, _ = jp.build_dist_graph_from_chunks(
        mesh, np.array_split(src, p), np.array_split(dst, p),
        np.array_split(w, p), store_push=True)
    np.testing.assert_allclose(got["ingest/pagerank"],
                               np.asarray(jp.mg_pagerank(g, mesh)[0]),
                               rtol=1e-5, atol=1e-7)
    ext = np.sort(np.unique(np.concatenate([src, dst])))
    np.testing.assert_array_equal(got["ingest/ids"], nmap.to_internal(ext))


@pytest.mark.parametrize("name", ["route", "hot"])
def test_shuffle_to_owners_matches_jax(world, name):
    pmaj, pmin, got = world
    p = pmaj * pmin
    keys, payload, n, _ = _shuffle_cases(p)[name]
    part = JaxPartition2D.create(n, pmaj, pmin)
    ko, po = shuffle_to_owners(_mesh(pmaj, pmin), part, keys, payload)
    ko, po = np.asarray(ko), np.asarray(po)
    per = len(ko) // p
    for r in range(p):
        k, pl = ko[r * per:(r + 1) * per], po[r * per:(r + 1) * per]
        np.testing.assert_array_equal(got[f"shuffle/{name}/{r}/keys"],
                                      k[k >= 0])
        np.testing.assert_array_equal(got[f"shuffle/{name}/{r}/payload"],
                                      pl[k >= 0])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_shuffle_reduce_by_key_matches_jax(world, op):
    pmaj, pmin, got = world
    keys, vals, n, _ = _shuffle_cases(pmaj * pmin)[op]
    part = JaxPartition2D.create(n, pmaj, pmin)
    want = np.asarray(shuffle_reduce_by_key(_mesh(pmaj, pmin), part, keys,
                                            vals, op=op))
    if op == "sum":
        np.testing.assert_allclose(got[f"shuffle/{op}"], want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[f"shuffle/{op}"], want)


def test_mesh_coordinates(world):
    """Rank r sits at divmod(r, pmin) (the JAX mesh's row-major order);
    the row group has pmin ranks, the column group pmaj."""
    pmaj, pmin, got = world
    coords = got["mesh/coords"]
    for r in range(pmaj * pmin):
        assert tuple(coords[r]) == (*divmod(r, pmin), r, r)
    assert int(got["mesh/row_size"][0]) == pmin
    assert int(got["mesh/col_size"][0]) == pmaj


def test_allgather_scalars(world):
    """One int64 per rank, past 2^32, to every rank in mesh order."""
    pmaj, pmin, got = world
    np.testing.assert_array_equal(
        got["allgather_scalars"],
        [(r + 1) << 33 for r in range(pmaj * pmin)])
