"""The multi-device port's mesh and partition against ``cugraph_tpu.parallel``.

No world is spawned here: ``Partition2D`` and the block builder
(``partition.build_block``) are pure functions, checked for every (i, j)
of several mesh shapes in one process; the mesh's refusals and a 1×1
mesh run in-process over a one-rank gloo group on a file store.

Bounds: the rank/range math equal; each block's CSR holding the JAX
``EdgeBlocks``' valid lanes as sorted (dst_loc, src_loc, weight[, eid])
triples (the JAX native builder keeps input order within a dst slot, its
NumPy path src_loc order), and in the JAX order itself where the JAX
build takes its NumPy path (edge types and times); the 1×1 mesh's
PageRank within rtol 1e-6 of the single-device port's.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cugraph_tpu import parallel as jp
from cugraph_tpu.parallel.partition import Partition2D as JaxPartition2D

import cugraph_tpu_torch as ctt
import cugraph_tpu_torch.parallel as tp
from cugraph_tpu_torch.parallel import mesh as pmesh
from cugraph_tpu_torch.parallel import (Partition2D, all_gather_vertex,
                                        build_block, build_dist_graph,
                                        get_chunksize, get_n_workers,
                                        make_mesh_2d, mesh_shape_for,
                                        mg_pagerank, shard_dist_graph)

from torch_port_mg import GRAPHS

torch.set_num_threads(1)
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4), (3, 2)]


# the JAX modules' public names with no counterpart: the JAX shardings,
# the TPU plan route, the padding constant, the axis names, and names the
# modules import
NO_COUNTERPART = {
    "mesh": {"edge_spec", "vertex_spec", "Mesh", "NamedSharding", "P"},
    "nn": {"mg_spmm_pallas_fn", "mg_spmm_pallas_arg_fn", "edge_spec",
           "vertex_spec", "NamedSharding", "P", "lru_cache"},
    "partition": {"E_ALIGN", "field"},
    "prims": {"MAJOR", "MINOR"},
    "construct": {"BOTH", "E_ALIGN", "EdgeBlocks", "NamedSharding", "P",
                  "lru_cache"},
    "shuffle": {"vertex_spec", "NamedSharding", "P", "lru_cache"},
    "sampling_mg": set(),
    "algos": {"NamedSharding", "P", "edge_spec", "vertex_spec",
              "lru_cache", "dataclass", "partial"},
    "louvain": {"NamedSharding", "P", "edge_spec", "vertex_spec",
                "lru_cache"},
    "lookup": set(),
    "kvcache": {"P", "edge_spec", "vertex_spec", "lru_cache", "field"}}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), type(np))}


@pytest.mark.parametrize("name", sorted(NO_COUNTERPART))
def test_every_public_name_has_a_counterpart(name):
    """Each public name of the JAX module has one in the port's module of
    the same name, but the JAX-only ones above."""
    import importlib

    jm = importlib.import_module(f"cugraph_tpu.parallel.{name}")
    tm = importlib.import_module(f"cugraph_tpu_torch.parallel.{name}")
    assert _public(jm) - _public(tm) - NO_COUNTERPART[name] == set()


def test_the_slice_names_and_aliases():
    """This slice's algorithms and the package's reference-named aliases
    (``cugraph_tpu/parallel/__init__.py:59-85``) as in the JAX package."""
    names = ["mg_pagerank", "mg_bfs", "mg_sssp", "mg_wcc",
             "mg_katz_centrality", "mg_degrees", "mg_hits",
             "mg_eigenvector_centrality", "Partition2D", "DistGraph",
             "build_dist_graph", "DistNumberMap",
             "build_dist_graph_from_chunks", "build_dist_graph_sharded",
             "renumber_edgelist_sharded", "make_mesh_2d", "mesh_shape_for",
             "prims", "shuffle_to_owners", "shuffle_reduce_by_key",
             "get_n_workers", "get_chunksize",
             # the analytics: parallel/algos.py and parallel/louvain.py
             "mg_all_pairs_similarity", "mg_betweenness_centrality",
             "mg_core_number", "mg_jaccard_coefficients",
             "mg_sorensen_coefficients", "mg_overlap_coefficients",
             "mg_cosine_coefficients", "mg_ecg",
             "mg_edge_betweenness_centrality", "mg_egonet",
             "mg_induced_subgraph", "mg_k_core", "mg_k_hop_nbrs",
             "mg_k_truss", "mg_negative_sampling",
             "mg_strongly_connected_components", "mg_triangle_count",
             "mg_two_hop_neighbors", "mg_leiden", "mg_louvain",
             "mg_louvain_move_phase"]
    for n in names:
        assert hasattr(jp, n) and hasattr(tp, n), n
    for alias, fn in (("pagerank", "mg_pagerank"), ("bfs", "mg_bfs"),
                      ("sssp", "mg_sssp"), ("hits", "mg_hits"),
                      ("katz_centrality", "mg_katz_centrality"),
                      ("eigenvector_centrality",
                       "mg_eigenvector_centrality"),
                      ("weakly_connected_components", "mg_wcc"),
                      ("louvain", "mg_louvain"), ("leiden", "mg_leiden"),
                      ("ecg", "mg_ecg"), ("jaccard",
                                          "mg_jaccard_coefficients"),
                      ("sorensen", "mg_sorensen_coefficients"),
                      ("overlap", "mg_overlap_coefficients"),
                      ("cosine", "mg_cosine_coefficients"),
                      ("triangle_count", "mg_triangle_count"),
                      ("ktruss_subgraph", "mg_k_truss"),
                      ("ego_graph", "mg_egonet"),
                      ("induced_subgraph", "mg_induced_subgraph"),
                      ("core_number", "mg_core_number"),
                      ("k_core", "mg_k_core"),
                      ("betweenness_centrality",
                       "mg_betweenness_centrality"),
                      ("edge_betweenness_centrality",
                       "mg_edge_betweenness_centrality"),
                      ("strongly_connected_components",
                       "mg_strongly_connected_components")):
        assert getattr(jp, alias) is getattr(jp, fn)
        assert getattr(tp, alias) is getattr(tp, fn)
    for kind in ("jaccard", "sorensen", "overlap", "cosine"):
        for pkg in (jp, tp):
            fn = getattr(pkg, f"all_pairs_{kind}")
            assert fn.__name__ == f"all_pairs_{kind}"


def test_block_segment_reduce_matches_jax():
    """The plain-torch segment reduce against ``jax.ops.segment_*``,
    empty segments included (0, the dtype's max for min, min for max)."""
    import jax.numpy as jnp

    from cugraph_tpu.parallel import prims as jpr
    from cugraph_tpu_torch.parallel import prims as tpr

    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, 12, 60)) * 2
    for vals in (rng.normal(size=60).astype(np.float32),
                 rng.integers(-50, 50, 60).astype(np.int32),
                 rng.normal(size=(60, 3)).astype(np.float32)):
        for op in ("sum", "min", "max"):
            want = np.asarray(jpr.block_segment_reduce(
                jnp.asarray(vals), jnp.asarray(seg), 25, op))
            got = tpr.block_segment_reduce(torch.from_numpy(vals),
                                           torch.from_numpy(seg), 25, op)
            if op == "sum" and vals.dtype == np.float32:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_shape_for_matches_jax():
    for n in range(1, 17):
        assert mesh_shape_for(n) == jp.mesh_shape_for(n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 8, 150, 241])
def test_partition2d_matches_jax(n, shape):
    pmaj, pmin = shape
    mine, theirs = Partition2D.create(n, pmaj, pmin), \
        JaxPartition2D.create(n, pmaj, pmin)
    assert (mine.chunk, mine.pad_v, mine.row_block, mine.num_devices) == (
        theirs.chunk, theirs.pad_v, theirs.row_block, theirs.num_devices)
    v = np.arange(mine.pad_v)
    rng = np.random.default_rng(n)
    s, d = rng.integers(0, mine.pad_v, 64), rng.integers(0, mine.pad_v, 64)
    for a, b in ((mine.owner(v), theirs.owner(v)),
                 (mine.edge_device(s, d), theirs.edge_device(s, d)),
                 ([mine.dst_local(v)], [theirs.dst_local(v)]),
                 ([mine.src_local(s, s // mine.row_block)],
                  [theirs.src_local(s, s // theirs.row_block)])):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for i in range(pmaj):
        for j in range(pmin):
            assert mine.owned_range(i, j) == theirs.owned_range(i, j)


def _lanes(blocks, i, j, fields):
    v = np.asarray(blocks.valid)[i, j]
    return np.stack([np.asarray(blocks.dst_loc)[i, j][v],
                     np.asarray(blocks.src_loc)[i, j][v]]
                    + [np.asarray(getattr(blocks, f))[i, j][v]
                       .astype(np.float64) for f in fields])


def _csr_lanes(b, fields):
    rows = np.repeat(np.arange(b.num_segments), np.diff(b.offsets.numpy()))
    return np.stack([rows, b.indices.numpy()]
                    + [getattr(b, f).numpy().astype(np.float64)
                       for f in fields])


def _sorted(t):
    return t[:, np.lexsort(t[::-1])]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_block_builder_matches_jax(name, shape):
    """Pull and push blocks (the push with its input instance ids) of
    every (i, j) against ``build_dist_graph``'s stacked blocks."""
    pmaj, pmin = shape
    src, dst, w, n = GRAPHS[name]
    want = jp.build_dist_graph(src, dst, w, n, pmaj, pmin, store_push=True)
    part = Partition2D.create(n, pmaj, pmin)
    ww = np.ones(len(src), np.float32) if w is None else w
    eid = np.arange(len(src), dtype=np.int32) if w is not None else None
    for i in range(pmaj):
        for j in range(pmin):
            pull = build_block(part, i, j, src, dst, ww, device="cpu")
            push = build_block(part, i, j, dst, src, ww, eid=eid,
                               device="cpu")
            assert pull.offsets.shape[0] == pmaj * part.chunk + 1
            assert pull.offsets.dtype == pull.indices.dtype == torch.int32
            np.testing.assert_array_equal(
                _sorted(_csr_lanes(pull, ["weights"])),
                _sorted(_lanes(want.pull, i, j, ["weight"])))
            fields = ["weights"] + (["eid"] if eid is not None else [])
            np.testing.assert_array_equal(
                _sorted(_csr_lanes(push, fields)),
                _sorted(_lanes(want.push, i, j,
                               ["weight"] + (["eid"] if eid is not None
                                             else []))))


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)])
def test_block_builder_keeps_the_jax_order(shape):
    """With edge types and times the JAX build sorts by (dst_loc,
    src_loc, input order) in NumPy; the port's blocks are that order."""
    pmaj, pmin = shape
    rng = np.random.default_rng(4)
    n, m = 90, 700
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    et, tm = (src * 7 + dst) % 3, rng.random(m).astype(np.float32)
    want = jp.build_dist_graph(src, dst, w, n, pmaj, pmin, edge_type=et,
                               edge_time=tm)
    part = Partition2D.create(n, pmaj, pmin)
    for i in range(pmaj):
        for j in range(pmin):
            b = build_block(part, i, j, src, dst, w, et, tm,
                            device="cpu")
            np.testing.assert_array_equal(
                _csr_lanes(b, ["weights", "etype", "etime"]),
                _lanes(want.pull, i, j, ["weight", "etype", "etime"]))


def test_block_builder_takes_no_default_device():
    """The caller names the device: no block lands on the host unasked."""
    src, dst, w, n = GRAPHS["weighted"]
    with pytest.raises(TypeError, match="device"):
        build_block(Partition2D.create(n, 1, 1), 0, 0, src, dst, w)


@pytest.mark.parametrize("shape", [(1, 3), (3, 1), (2, 2)])
def test_square_views_are_the_block_and_its_transpose(shape):
    pmaj, pmin = shape
    src, dst, w, n = GRAPHS["weighted"]
    part = Partition2D.create(n, pmaj, pmin)
    for i in range(pmaj):
        for j in range(pmin):
            b = build_block(part, i, j, src, dst, w, device="cpu")
            side = max(pmaj, pmin) * part.chunk
            assert b.side == side
            dense = np.zeros((side, side))
            rows = b.dst_loc.numpy()
            np.add.at(dense, (rows, b.indices.numpy()), b.weights.numpy())
            for csr, want in ((b.square, dense), (b.transposed_square,
                                                  dense.T)):
                assert csr.offsets.shape[0] == side + 1
                got = np.zeros((side, side))
                r = np.repeat(np.arange(side), np.diff(csr.offsets.numpy()))
                np.add.at(got, (r, csr.indices.numpy()), csr.weights.numpy())
                np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, on a file store."""
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_mesh_refuses_a_cuda_device_over_gloo(one_rank):
    with pytest.raises(ValueError, match="NCCL"):
        make_mesh_2d(1, 1, device="cuda:0")


def test_mesh_refuses_a_cpu_device_over_nccl(one_rank, monkeypatch):
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        make_mesh_2d(1, 1, device="cpu")


def test_mesh_refuses_a_shape_off_the_world_size(one_rank):
    with pytest.raises(ValueError, match="2x1 mesh over 1 ranks"):
        make_mesh_2d(2, 1, device="cpu")


def test_mesh_without_a_device_needs_cuda(one_rank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d(1, 1)


def test_one_rank_mesh_matches_the_single_device_port(one_rank):
    mesh = make_mesh_2d(device="cpu")
    assert (mesh.pmaj, mesh.pmin, mesh.i, mesh.j) == (1, 1, 0, 0)
    src, dst, w, n = GRAPHS["weighted"]
    g = build_dist_graph(src, dst, w, n, mesh)
    p, _, iters = mg_pagerank(g, mesh, tol=1e-6)
    moved = shard_dist_graph(g, mesh)
    assert torch.equal(moved.pull.offsets, g.pull.offsets)
    assert moved.out_degree.device == mesh.device
    G = ctt.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    want = ctt.pagerank(G, tol=1e-6)
    got = all_gather_vertex(mesh, p).numpy()
    np.testing.assert_allclose(
        got[want["vertex"].to_numpy()], want["pagerank"].to_numpy(),
        rtol=1e-6)
    assert iters > 1


def test_workers_and_chunksize(one_rank, tmp_path):
    """``get_n_workers`` counts the ranks; ``get_chunksize`` splits one
    file over them, or takes the largest of several (reference
    common/read_utils.py:5-12), as the JAX package's does over devices."""
    mesh = make_mesh_2d(device="cpu")
    assert get_n_workers() == get_n_workers(mesh) == 1
    one = tmp_path / "a.csv"
    one.write_text("0 1\n" * 10)
    (tmp_path / "b.csv").write_text("0 1\n" * 3)
    assert get_chunksize(one, mesh) == jp.get_chunksize(
        one, type("M", (), {"size": 1})()) == 40
    assert get_chunksize(tmp_path / "*.csv") == 40
