"""The port's plc wrappers (``cugraph_tpu_torch.plc``) against
``cugraph_tpu.plc`` on the CPU: one case per non-sampling wrapper and
option, both packages called with the same arguments on ``SGGraph``s built
from the same arrays.

Tolerances: vertex ids, integers, labels, partitions, edge lists and
coefficients of unweighted graphs exact; the power methods within ATOL
1e-6 (both iterate in float32 and sum in other orders,
``tests/test_torch_link_analysis.py``); betweenness within relative L1
1e-5; the weighted similarity coefficients within rtol 1e-6 (the port sums
in float64, the JAX package in float32); SSSP distances within rtol 1e-6,
its predecessors exact, on weights in [0.5, 2] (above the JAX package's
predecessor tolerance, ROADMAP §3); the clustering scores within 1e-6 (the
port evaluates them in float64); ForceAtlas2 within 1e-4 of the positions'
norm after 5 steps.  Leiden runs on the JAX package's level seeds
(``level_seed`` replaced by its ``fold_in`` derivation) and spectral
clustering on one ARPACK starting vector, as in the top-level tests.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse.linalg as spl
import torch

import cugraph_tpu as jt
import cugraph_tpu.plc as jp

import cugraph_tpu_torch.plc as tp
from cugraph_tpu_torch.algos import community as tcom

torch.set_num_threads(1)

ATOL = 1e-6
BC_REL_L1 = 1e-5
SIM_RTOL = 1e-6
SSSP_RTOL = 1e-6
SCORE_ATOL = 1e-6
FA2_REL = 1e-4


def _random_edges(seed, n, m):
    """Distinct directed pairs without self-loops, weights in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    w = rng.uniform(0.5, 2.0, len(pairs)).astype(np.float32)
    return pairs[:, 0], pairs[:, 1], w


EDGES = _random_edges(6, 40, 260)
OUT_WEIGHTS = np.bincount(EDGES[0], weights=EDGES[2], minlength=40)


def _build(P, h):
    """The graphs of every case, built by plc package ``P``."""
    src, dst, w = EDGES
    n_e = len(src)
    props = dict(edge_id_array=np.arange(n_e, dtype=np.int64) + 100,
                 edge_type_array=(np.arange(n_e) % 3).astype(np.int32))
    sym = (np.concatenate([src, dst]), np.concatenate([dst, src]),
           np.concatenate([w, w]))
    e = np.array(list(nx.karate_club_graph().edges()))
    ms, md = np.array([0, 0, 1, 1, 2, 2, 2]), np.array([1, 1, 2, 3, 0, 0, 0])
    return {
        "directed": P.SGGraph(h, P.GraphProperties(), src, dst, w, **props),
        "unweighted": P.SGGraph(h, P.GraphProperties(), src, dst, None),
        "symmetric": P.SGGraph(h, P.GraphProperties(is_symmetric=True),
                               *sym),
        "karate": P.SGGraph(h, P.GraphProperties(is_symmetric=True),
                            e[:, 0], e[:, 1], None, symmetrize=True),
        "multi": P.SGGraph(h, P.GraphProperties(is_multigraph=True), ms, md,
                           None),
        "sparse_ids": P.SGGraph(h, P.GraphProperties(), src * 7 + 1000,
                                dst * 7 + 1000, w),
    }


@pytest.fixture(scope="module")
def graphs():
    ht = tp.ResourceHandle(device="cpu")
    hj = jp.ResourceHandle()
    return {tp: (ht, _build(tp, ht)), jp: (hj, _build(jp, hj))}


@pytest.fixture
def jax_seeds(monkeypatch):
    """Leiden on the JAX package's level seeds; one ARPACK start."""
    import jax

    def level_seed(random_state, level):
        key = jax.random.fold_in(
            jax.random.key(0 if random_state is None else int(random_state)),
            level)
        return int(np.asarray(jax.random.key_data(key)).ravel()[-1])

    monkeypatch.setattr(tcom, "level_seed", level_seed)
    real = spl.eigsh

    def eigsh(A, *args, **kw):
        kw.setdefault("v0", np.random.default_rng(0).random(A.shape[0]))
        return real(A, *args, **kw)

    monkeypatch.setattr(spl, "eigsh", eigsh)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _exact(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, float):
            assert a == b
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _vertices_then(check):
    """Vertices (the first array) exactly, every other array by ``check``."""
    def compare(got, want):
        got, want = _flat(got), _flat(want)
        assert len(got) == len(want)
        _exact(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            check(np.asarray(a), np.asarray(b))
    return compare


def _atol(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _rel_l1(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    assert np.abs(a - b).sum() <= BC_REL_L1 * max(np.abs(b).sum(), 1e-30)


def _edges_then(check):
    """(src, dst) exactly, the values by ``check``."""
    def compare(got, want):
        _exact(got[:2], want[:2])
        check(np.asarray(got[2]), np.asarray(want[2]))
    return compare


def _sim_close(a, b):
    np.testing.assert_allclose(a, b, rtol=SIM_RTOL, atol=0)


def _sssp_close(got, want):
    _exact(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SSSP_RTOL, atol=0)
    _exact(got[2], want[2])


def _partition_q(got, want):
    """Vertices and partition exactly; Leiden's q, float64 in the port and
    float32 in the JAX package, within 1e-6."""
    _exact(got[:2], want[:2])
    assert abs(got[2] - want[2]) <= SCORE_ATOL


def _score_close(got, want):
    assert isinstance(got, float)
    assert abs(got - want) <= SCORE_ATOL


def _fa2_close(got, want):
    _exact(got[0], want[0])
    pos_t = np.stack([got[1], got[2]], 1).astype(np.float64)
    pos_j = np.stack([want[1], want[2]], 1).astype(np.float64)
    assert np.linalg.norm(pos_t - pos_j) <= FA2_REL * np.linalg.norm(pos_j)


def _lookup_same(got, want):
    ids = np.arange(95, 400)
    for t in (0, 1, 2):
        pd.testing.assert_frame_equal(got.lookup_vertex_ids(ids, t),
                                      want.lookup_vertex_ids(ids, t))


def _clusters(h, g):
    v = np.arange(40)
    return h, g, 4, v, (v * 7) % 4


PAIRS = (np.array([0, 1, 2, 5, 7, 3]), np.array([3, 2, 9, 11, 20, 3]))
SUBSET = np.array([3, 0, 17, 39])

# name -> (call(P, h, graphs), comparison)
CASES = {
    "pagerank": (lambda P, h, g: P.pagerank(h, g["directed"]),
                 _vertices_then(_atol)),
    "pagerank_out_weights_and_guess": (
        lambda P, h, g: P.pagerank(
            h, g["directed"], np.arange(40), OUT_WEIGHTS, np.arange(40),
            np.linspace(1.0, 2.0, 40) / 60.0, 0.9, 1e-6, 200),
        _vertices_then(_atol)),
    "pagerank_sparse_ids": (lambda P, h, g: P.pagerank(h, g["sparse_ids"]),
                            _vertices_then(_atol)),
    "personalized_pagerank": (
        lambda P, h, g: P.personalized_pagerank(
            h, g["directed"], np.array([0, 5, 9]),
            np.array([0.5, 0.25, 0.25])),
        _vertices_then(_atol)),
    "hits": (lambda P, h, g: P.hits(h, g["directed"], 1e-7, 200),
             _vertices_then(_atol)),
    "hits_initial_guess": (
        lambda P, h, g: P.hits(h, g["directed"], 1e-7, 200, np.arange(40),
                               np.linspace(0.1, 1.0, 40), False),
        _vertices_then(_atol)),
    "bfs": (lambda P, h, g: P.bfs(h, g["directed"], np.array([3])), _exact),
    "bfs_depth_limit_no_predecessors": (
        lambda P, h, g: P.bfs(h, g["symmetric"], np.array([3]), False, 2,
                              False), _exact),
    "bfs_multi_source": (
        lambda P, h, g: P.bfs(h, g["directed"], np.array([3, 17, 30])),
        _exact),
    "bfs_multi_source_depth_limit": (
        lambda P, h, g: P.bfs(h, g["karate"], np.array([0, 33]),
                              depth_limit=1, compute_predecessors=False),
        _exact),
    "sssp": (lambda P, h, g: P.sssp(h, g["directed"], 3), _sssp_close),
    "sssp_cutoff_no_predecessors": (
        lambda P, h, g: P.sssp(h, g["symmetric"], 5, 2.5, False),
        _sssp_close),
    "katz_centrality": (
        lambda P, h, g: P.katz_centrality(h, g["directed"], None, 0.05, 1.0,
                                          1e-7, 300), _vertices_then(_atol)),
    "katz_centrality_betas": (
        lambda P, h, g: P.katz_centrality(
            h, g["sparse_ids"], np.linspace(0.5, 2.0, 40), 0.05, 1.0, 1e-7,
            300), _vertices_then(_atol)),
    "eigenvector_centrality": (
        lambda P, h, g: P.eigenvector_centrality(h, g["symmetric"], 1e-7,
                                                 300),
        _vertices_then(_atol)),
    "betweenness_centrality": (
        lambda P, h, g: P.betweenness_centrality(h, g["directed"]),
        _vertices_then(_rel_l1)),
    "betweenness_centrality_k_state": (
        lambda P, h, g: P.betweenness_centrality(
            h, g["symmetric"], 8, P.CuGraphRandomState(h, 5), False, True),
        _vertices_then(_rel_l1)),
    "edge_betweenness_centrality": (
        lambda P, h, g: P.edge_betweenness_centrality(h, g["directed"], 8,
                                                      3, False),
        _edges_then(_rel_l1)),
    "edge_betweenness_centrality_karate": (
        lambda P, h, g: P.edge_betweenness_centrality(h, g["karate"]),
        _edges_then(_rel_l1)),
    "louvain": (lambda P, h, g: P.louvain(h, g["symmetric"], 10, 1e-7, 1.0),
                _exact),
    "louvain_karate_resolution": (
        lambda P, h, g: P.louvain(h, g["karate"], resolution=0.7), _exact),
    "leiden": (lambda P, h, g: P.leiden(h, 5, g["symmetric"], 10, 1.0, 1.0),
               _partition_q),
    "leiden_legacy_order": (
        lambda P, h, g: P.leiden(h, g["karate"], 3), _partition_q),
    "leiden_state": (
        lambda P, h, g: P.leiden(h, P.CuGraphRandomState(h, 2),
                                 g["symmetric"]) if P is tp else
        P.leiden(h, tp.CuGraphRandomState(None, 2).next_seed(),
                 g["symmetric"]), _partition_q),
    "ecg": (lambda P, h, g: P.ecg(h, None, g["symmetric"]), _exact),
    "ecg_legacy_order": (lambda P, h, g: P.ecg(h, g["karate"]), _exact),
    "triangle_count": (lambda P, h, g: P.triangle_count(h, g["karate"]),
                       _exact),
    "triangle_count_start_list": (
        lambda P, h, g: P.triangle_count(h, g["symmetric"],
                                         np.array([0, 1, 7])), _exact),
    "core_number": (lambda P, h, g: P.core_number(h, g["karate"]), _exact),
    "core_number_incoming": (
        lambda P, h, g: P.core_number(h, g["directed"], "incoming"), _exact),
    "k_core": (lambda P, h, g: P.k_core(h, g["symmetric"], 3), _exact),
    "k_core_core_result": (
        lambda P, h, g: P.k_core(h, g["karate"], 2, "bidirectional",
                                 P.core_number(h, g["karate"])), _exact),
    "k_truss_subgraph": (lambda P, h, g: P.k_truss_subgraph(h, g["karate"],
                                                            4), _exact),
    "egonet": (lambda P, h, g: P.egonet(h, g["symmetric"],
                                        np.array([0, 7]), 1), _exact),
    "ego_graph": (lambda P, h, g: P.ego_graph(h, g["karate"],
                                              np.array([0, 33, 5]), 2),
                  _exact),
    "induced_subgraph": (
        lambda P, h, g: P.induced_subgraph(h, g["directed"], np.arange(12)),
        _exact),
    "induced_subgraph_offsets": (
        lambda P, h, g: P.induced_subgraph(
            h, g["directed"], np.concatenate([np.arange(10),
                                              np.arange(10, 25)]),
            np.array([0, 10, 25])), _exact),
    "weakly_connected_components": (
        lambda P, h, g: P.weakly_connected_components(h, g["directed"]),
        _exact),
    "weakly_connected_components_legacy_csr": (
        lambda P, h, g: P.weakly_connected_components(
            h, None, np.array([0, 1, 2, 2, 3, 3, 5]),
            np.array([1, 2, 4, 0, 3]), None, None), _exact),
    "strongly_connected_components": (
        lambda P, h, g: P.strongly_connected_components(h, g["directed"]),
        _exact),
    "strongly_connected_components_legacy_csr": (
        lambda P, h, g: P.strongly_connected_components(
            h, None, np.array([0, 1, 2, 3, 3, 4]),
            np.array([1, 2, 0, 0]), np.ones(4, np.float32)), _exact),
    "jaccard_coefficients": (
        lambda P, h, g: P.jaccard_coefficients(h, g["karate"], *PAIRS),
        _exact),
    "jaccard_coefficients_weighted": (
        lambda P, h, g: P.jaccard_coefficients(h, g["symmetric"], *PAIRS,
                                               True),
        _edges_then(_sim_close)),
    "sorensen_coefficients": (
        lambda P, h, g: P.sorensen_coefficients(h, g["karate"], *PAIRS),
        _exact),
    "sorensen_coefficients_weighted": (
        lambda P, h, g: P.sorensen_coefficients(h, g["symmetric"], *PAIRS,
                                                True),
        _edges_then(_sim_close)),
    "overlap_coefficients": (
        lambda P, h, g: P.overlap_coefficients(h, g["karate"], *PAIRS),
        _exact),
    "overlap_coefficients_weighted": (
        lambda P, h, g: P.overlap_coefficients(h, g["symmetric"], *PAIRS,
                                               True),
        _edges_then(_sim_close)),
    "cosine_coefficients": (
        lambda P, h, g: P.cosine_coefficients(h, g["karate"], *PAIRS),
        _edges_then(_sim_close)),
    "cosine_coefficients_weighted": (
        lambda P, h, g: P.cosine_coefficients(h, g["symmetric"], *PAIRS,
                                              True),
        _edges_then(_sim_close)),
    "all_pairs_jaccard_coefficients": (
        lambda P, h, g: P.all_pairs_jaccard_coefficients(h, g["karate"],
                                                         topk=20), _exact),
    "all_pairs_sorensen_coefficients": (
        lambda P, h, g: P.all_pairs_sorensen_coefficients(
            h, g["karate"], np.array([0, 1, 33])), _exact),
    "all_pairs_overlap_coefficients": (
        lambda P, h, g: P.all_pairs_overlap_coefficients(h, g["symmetric"],
                                                         topk=15), _exact),
    "all_pairs_cosine_coefficients": (
        lambda P, h, g: P.all_pairs_cosine_coefficients(
            h, g["karate"], np.array([2, 3]), topk=10),
        _edges_then(_sim_close)),
    "balanced_cut_clustering": (
        lambda P, h, g: P.balanced_cut_clustering(h, g["karate"], 3),
        _exact),
    "spectral_modularity_maximization": (
        lambda P, h, g: P.spectral_modularity_maximization(h, g["karate"],
                                                           4), _exact),
    "analyze_clustering_modularity": (
        lambda P, h, g: P.analyze_clustering_modularity(
            *_clusters(h, g["symmetric"])), _score_close),
    "analyze_clustering_edge_cut": (
        lambda P, h, g: P.analyze_clustering_edge_cut(
            *_clusters(h, g["symmetric"])), _score_close),
    "analyze_clustering_ratio_cut": (
        lambda P, h, g: P.analyze_clustering_ratio_cut(
            *_clusters(h, g["symmetric"])), _score_close),
    "two_hop_neighbors": (
        lambda P, h, g: P.two_hop_neighbors(h, g["directed"]), _exact),
    "two_hop_neighbors_start": (
        lambda P, h, g: P.two_hop_neighbors(h, g["karate"], [0, 5]), _exact),
    "get_two_hop_neighbors": (
        lambda P, h, g: P.get_two_hop_neighbors(h, g["symmetric"],
                                                np.array([1, 4])), _exact),
    "degrees": (lambda P, h, g: P.degrees(h, g["directed"]), _exact),
    "degrees_subset": (lambda P, h, g: P.degrees(h, g["directed"], SUBSET),
                       _exact),
    "in_degrees": (lambda P, h, g: P.in_degrees(h, g["symmetric"], SUBSET),
                   _exact),
    "out_degrees": (lambda P, h, g: P.out_degrees(h, g["directed"]), _exact),
    "replicate_edgelist": (
        lambda P, h, g: P.replicate_edgelist(h, graph=g["directed"]),
        _exact),
    "replicate_edgelist_arrays": (
        lambda P, h, g: P.replicate_edgelist(
            h, np.array([0, 1]), np.array([1, 2]),
            np.array([0.5, 2.5], np.float32)), _exact),
    "decompress_to_edgelist": (
        lambda P, h, g: P.decompress_to_edgelist(h, g["sparse_ids"]),
        _exact),
    "decompress_to_edgelist_unweighted": (
        lambda P, h, g: P.decompress_to_edgelist(h, g["karate"]), _exact),
    "extract_vertex_list": (
        lambda P, h, g: P.extract_vertex_list(h, g["sparse_ids"]), _exact),
    "has_vertex": (
        lambda P, h, g: P.has_vertex(h, g["sparse_ids"],
                                     np.array([1000, 1001, 1007, 5])),
        _exact),
    "count_multi_edges": (
        lambda P, h, g: P.count_multi_edges(h, g["multi"]), _exact),
    "renumber_arbitrary_edgelist": (
        lambda P, h, g: P.renumber_arbitrary_edgelist(
            h, np.array([10, 20, 30, 40]), np.array([20, 30, 40]),
            np.array([30, 40, 10])), _exact),
    "minimum_spanning_tree": (
        lambda P, h, g: P.minimum_spanning_tree(h, g["symmetric"]), _exact),
    "minimum_spanning_tree_unweighted": (
        lambda P, h, g: P.minimum_spanning_tree(h, g["karate"]), _exact),
    "force_atlas2": (lambda P, h, g: P.force_atlas2(h, g["karate"],
                                                    max_iter=5),
                     _fa2_close),
    "edge_id_lookup_table": (
        lambda P, h, g: P.edge_id_lookup_table(h, g["directed"]),
        _lookup_same),
}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_matches_jax(name, graphs, jax_seeds):
    call, compare = CASES[name]
    ht, gt = graphs[tp]
    hj, gj = graphs[jp]
    compare(call(tp, ht, gt), call(jp, hj, gj))


def test_ecg_forwards_every_argument(graphs):
    """The JAX wrapper's single-device branch passes only min_weight and
    ensemble_size; the port's passes the random state, max_level,
    threshold and resolution too, and equals the JAX package's top-level
    ecg called with them."""
    ht, gt = graphs[tp]
    hj, gj = graphs[jp]
    kw = dict(min_weight=0.01, ensemble_size=4, max_level=3,
              threshold=1e-6, resolution=0.8)
    v, part = tp.ecg(ht, 9, gt["symmetric"], **kw)
    want = jt.ecg(gj["symmetric"].graph(), random_state=9, **kw)
    want = (want[0] if isinstance(want, tuple) else want) \
        .sort_values("vertex")
    np.testing.assert_array_equal(v, want["vertex"].to_numpy())
    np.testing.assert_array_equal(part, want["partition"].to_numpy())
    # and the JAX wrapper ignores the state: seed 9 gives its seed-0 result
    jv, jpart = jp.ecg(hj, 9, gj["symmetric"], **kw)
    _, jpart0 = jp.ecg(hj, 0, gj["symmetric"], **kw)
    np.testing.assert_array_equal(jpart, jpart0)


def test_wrappers_take_raw_graphs(graphs):
    """A port Graph in the graph slot runs as its SGGraph does."""
    ht, gt = graphs[tp]
    G = gt["directed"].graph()
    _exact(tp.bfs(ht, G, np.array([3])), tp.bfs(ht, gt["directed"],
                                                  np.array([3])))
    _exact(tp.degrees(None, G), tp.degrees(None, gt["directed"]))


def test_results_are_host_arrays(graphs):
    ht, gt = graphs[tp]
    for out in (tp.pagerank(ht, gt["directed"]),
                tp.bfs(ht, gt["directed"], np.array([3, 4])),
                tp.weakly_connected_components(ht, gt["directed"])):
        assert all(isinstance(a, np.ndarray) for a in out)
