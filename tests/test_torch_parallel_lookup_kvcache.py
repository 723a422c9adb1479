"""The port's ``parallel.lookup`` and ``parallel.kvcache`` against
``cugraph_tpu.parallel``'s, on meshes of the same shape.

Each world (2×2, 2×1 and 1×2 gloo processes) runs
``torch_port_plc_mg.lookup_kvcache_body`` once in a module-scoped
fixture.  Bounds: the lookup frames bit for bit (present, missing,
negative and past-the-end ids, every type, 64-bit vertex and edge ids on
the sharded build; after ``tests/test_plc_surface_smoke_mg.py:303``);
each rank's cache equal to the JAX ``MinorCache`` slice [i, j] trimmed
to its real lengths (``send_idx`` where ``send_valid``, ``perm_recv`` over
the rank's distinct sources, ``src_comp`` over its edges as (dst slot,
compressed source) pairs, since a slot's edges are in input order there
and by source here), with the same U, R and compression ratio;
the compressed SpMV within 1e-6 of the JAX package's and bit for bit the
port's ``pull_spmv`` on every rank, on ``tests/test_kvcache.py``'s
random, hypersparse and mostly-empty graphs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from cugraph_tpu import parallel as jp
from cugraph_tpu import plc as jplc
from cugraph_tpu.parallel import kvcache as jkv
from cugraph_tpu.parallel.mesh import vertex_spec

from torch_port_mg import WORLDS, run_worlds
from torch_port_plc_mg import (SPMV_CALLS, lookup_graphs, lookup_queries,
                               spmv_graphs, spmv_x)

torch.set_num_threads(1)
IDS = [f"{a}x{b}" for a, b in WORLDS]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from torch_port_plc_mg import lookup_kvcache_body

    return run_worlds(tmp_path_factory.mktemp("lookup_kvcache"),
                      lookup_kvcache_body, {shape: () for shape in WORLDS})


@functools.lru_cache(maxsize=None)
def _mesh(pmaj, pmin):
    return jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])


@pytest.mark.parametrize("name", sorted(lookup_graphs()))
@pytest.mark.parametrize("shape", WORLDS, ids=IDS)
def test_lookup_frames_match_jax(worlds, shape, name):
    src, dst, ids, types, build = lookup_graphs()[name]
    h = jplc.ResourceHandle(mesh=_mesh(*shape))
    g = jplc.MGGraph(h, None, src, dst, None, edge_id_array=ids,
                     edge_type_array=types, build=build)
    table = jplc.edge_id_lookup_table(h, g)
    found = 0
    for t in range(4):
        want = table.lookup_vertex_ids(lookup_queries(ids), t)
        for c in want.columns:
            got = worlds[shape][f"lookup/{name}/{t}/{c}"]
            assert got.dtype == want[c].to_numpy().dtype
            np.testing.assert_array_equal(got, want[c].to_numpy())
        found += int((want["src"] >= 0).sum())
    assert found >= 4      # the present ids resolve under their types


@functools.lru_cache(maxsize=None)
def _jax_spmv(name, pmaj, pmin):
    src, dst, w, n = spmv_graphs()[name]
    mesh = _mesh(pmaj, pmin)
    g = jp.build_dist_graph(src, dst, w, n, pmaj, pmin, store_push=False)
    cache = jkv.build_minor_cache(g)
    ys = []
    for k in range(SPMV_CALLS):
        xd = jax.device_put(jnp.asarray(spmv_x(g.pad_v, k)),
                            NamedSharding(mesh, vertex_spec()))
        ys.append(np.asarray(jkv.pull_spmv_compressed(g, cache, mesh, xd)))
    return g, cache, ys


@pytest.mark.parametrize("name", sorted(spmv_graphs()))
@pytest.mark.parametrize("shape", WORLDS, ids=IDS)
def test_cache_is_the_jax_slice(worlds, shape, name):
    res = worlds[shape]
    g, cache, _ = _jax_spmv(name, *shape)
    pmaj, pmin = shape
    valid = np.asarray(g.pull.valid)
    cv = np.asarray(cache.cache_valid)
    sv = np.asarray(cache.send_valid)
    np.testing.assert_array_equal(res[f"cache/{name}/u_r"],
                                  [cache.u_max, cache.r_max])
    assert float(res[f"cache/{name}/ratio"]) == cache.compression_ratio
    for r in range(pmaj * pmin):
        i, j = divmod(r, pmin)
        e, u = int(valid[i, j].sum()), int(cv[i, j].sum())
        got_valid = res[f"cache/{name}/send_valid"][r][:pmin * cache.r_max]
        np.testing.assert_array_equal(got_valid.astype(bool),
                                      sv[i, j].reshape(-1))
        got_idx = res[f"cache/{name}/send_idx"][r][:pmin * cache.r_max]
        want_idx = np.asarray(cache.send_idx)[i, j].reshape(-1)
        np.testing.assert_array_equal(got_idx[sv[i, j].reshape(-1)],
                                      want_idx[sv[i, j].reshape(-1)])
        got_perm = res[f"cache/{name}/perm_recv"][r]
        np.testing.assert_array_equal(got_perm[:u],
                                      np.asarray(cache.perm_recv)[i, j, :u])
        assert (got_perm[u:] == -1).all()
        # a dst slot's edges: by source here, in input order in the JAX
        # package, so the (slot, compressed source) pairs are compared
        got_comp = res[f"cache/{name}/src_comp"][r]
        assert (got_comp[e:] == -1).all()
        got_key = res[f"cache/{name}/dst_loc"][r][:e] * (1 << 20) \
            + got_comp[:e]
        want_key = np.asarray(g.pull.dst_loc)[i, j][valid[i, j]].astype(
            np.int64) * (1 << 20) + np.asarray(cache.src_comp)[i, j][
            valid[i, j]]
        np.testing.assert_array_equal(np.sort(got_key), np.sort(want_key))


@pytest.mark.parametrize("name", sorted(spmv_graphs()))
@pytest.mark.parametrize("shape", WORLDS, ids=IDS)
def test_compressed_spmv(worlds, shape, name):
    res = worlds[shape]
    assert bool(res[f"spmv/{name}/same"]), "differs from pull_spmv"
    _, cache, ys = _jax_spmv(name, *shape)
    for k, want in enumerate(ys):
        np.testing.assert_allclose(res[f"spmv/{name}/{k}"], want, rtol=0,
                                   atol=1e-6)
    if name == "hypersparse":
        assert cache.compression_ratio > 4.0
