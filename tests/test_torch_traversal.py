"""The port's traversal slice end to end: bfs, sssp, k_hop_neighbors,
filter_unreachable, shortest_path_length and extract_bfs_paths in
cugraph_tpu_torch against cugraph_tpu, on the same graphs, on the CPU.

The JAX side runs its XLA route, and its Pallas route in interpret mode
(``CUGRAPH_TPU_PALLAS_INTERPRET``) on graphs of at most 500 vertices, as
its own tests do.  BFS distances and predecessors must be equal.  SSSP
distances must agree within rtol 1e-6 and its predecessors must be equal:
both packages relax in float32, and the minimum over the same candidate
sums is the same value whatever the order; the tolerance covers only a
float32 rounding step.  Trees must pass the Graph500 validators.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.prims import frontier as jfrontier
from cugraph_tpu.core.structure import build_structure_host

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.kernels import semiring as sr
from cugraph_tpu_torch.prims import frontier
from cugraph_tpu_torch.testing import validate_bfs_tree, validate_sssp_tree

torch.set_num_threads(1)
SSSP_RTOL = 1e-6
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, weights or None, directed)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None, False
    if kind in ("netscience", "email-Eu-core"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return (a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                a[:, 2].astype(np.float32), kind == "email-Eu-core")
    if kind.startswith("rmat12"):
        e = ctpu.rmat(12, 16 << 12, seed=12)
        w = np.random.default_rng(12).uniform(0.1, 2.0, len(e)).astype(
            np.float32)
        return e["src"].to_numpy(), e["dst"].to_numpy(), w, \
            kind == "rmat12_directed"
    # "random<n>": a directed weighted graph without self-loops
    n = int(kind[len("random"):])
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, 7 * n), rng.integers(0, n, 7 * n)
    keep = src != dst
    w = (0.25 + rng.random(keep.sum())).astype(np.float32)
    return src[keep], dst[keep], w, True


def _pair(kind, weighted=True):
    src, dst, w, directed = _edges(kind)
    w = w if weighted else None
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    return Gj, Gt


def _sorted(df):
    return df.sort_values("vertex").reset_index(drop=True)


def _assert_bfs_equal(got, want):
    got, want = _sorted(got), _sorted(want)
    pd.testing.assert_frame_equal(got, want)


def _assert_sssp_equal(got, want):
    got, want = _sorted(got), _sorted(want)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["vertex"], want["vertex"])
    assert got["distance"].dtype == want["distance"].dtype == np.float64
    np.testing.assert_allclose(got["distance"], want["distance"],
                               rtol=SSSP_RTOL, atol=0)
    np.testing.assert_array_equal(got["predecessor"], want["predecessor"])
    assert got["predecessor"].dtype == want["predecessor"].dtype


def _roots(G, k=3):
    """k start vertices spread over the id range, by external id."""
    verts = G.number_map.to_external(np.arange(G.number_of_vertices()))
    return [int(v) for v in verts[::max(1, len(verts) // k)][:k]]


def _validate(Gt, root, bfs_df, sssp_df):
    src, dst, w = Gt.edgelist_arrays()
    ext = Gt.number_map.to_external
    directed = Gt.is_directed()
    b, s = _sorted(bfs_df), _sorted(sssp_df)
    validate_bfs_tree(ext(src), ext(dst), root, b["distance"].to_numpy(),
                      b["predecessor"].to_numpy(), directed=directed,
                      vertices=b["vertex"].to_numpy())
    ww = np.ones(len(src), np.float32) if w is None else w
    validate_sssp_tree(ext(src), ext(dst), ww, root, s["distance"].to_numpy(),
                       s["predecessor"].to_numpy(), directed=directed,
                       vertices=s["vertex"].to_numpy())


@pytest.mark.parametrize("kind", ["karate", "email-Eu-core", "netscience",
                                  "rmat12", "rmat12_directed"])
def test_bfs_and_sssp_match_jax_xla_route(kind):
    Gj, Gt = _pair(kind)
    for root in _roots(Gt):
        b = ct.bfs(Gt, root)
        _assert_bfs_equal(b, ctpu.bfs(Gj, root))
        s = ct.sssp(Gt, root)
        _assert_sssp_equal(s, ctpu.sssp(Gj, root))
        _validate(Gt, root, b, s)


def test_rmat12_runs_both_regimes():
    """At RMAT-12 the middle BFS levels and SSSP iterations outgrow the
    top-down caps, so both the sparse levels and the K2 sweeps run."""
    _, Gt = _pair("rmat12")
    root = _roots(Gt)[0]
    ct.bfs(Gt, root)
    run = dict(traversal.LAST_RUN)
    assert run["dense_levels"] > 0 and run["sparse_levels"] > 0
    levels = run["dense_levels"] + run["sparse_levels"]
    assert run["syncs"] in (levels, levels + 1)
    ct.sssp(Gt, root)
    assert traversal.LAST_RUN["dense_iterations"] > 0
    assert traversal.LAST_RUN["sparse_iterations"] > 0


@pytest.mark.parametrize("td", [(0, 0), (10, 200)])
@pytest.mark.parametrize("kind", ["karate", "random300"])
def test_regime_caps_do_not_change_results(kind, td, monkeypatch):
    """The regime switch is a schedule, not a semantics: forcing every level
    dense (caps 0) or mixing regimes gives the JAX package's frames."""
    monkeypatch.setattr(traversal, "_TD_K", td[0])
    monkeypatch.setattr(traversal, "_TD_E", td[1])
    Gj, Gt = _pair(kind)
    for root in _roots(Gt, 2):
        _assert_bfs_equal(ct.bfs(Gt, root), ctpu.bfs(Gj, root))
        _assert_sssp_equal(ct.sssp(Gt, root), ctpu.sssp(Gj, root))
    if td == (0, 0):
        assert traversal.LAST_RUN["sparse_iterations"] == 0


@pytest.mark.parametrize("kind", ["karate", "random300"])
def test_bfs_and_sssp_match_jax_pallas_interpret(kind, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    Gj, Gt = _pair(kind)
    root = _roots(Gt)[1]
    b = ct.bfs(Gt, root)
    _assert_bfs_equal(b, ctpu.bfs(Gj, root))
    s = ct.sssp(Gt, root)
    _assert_sssp_equal(s, ctpu.sssp(Gj, root))
    _validate(Gt, root, b, s)


def test_options_match_jax():
    Gj, Gt = _pair("random300")
    root = _roots(Gt)[0]
    for kw in (dict(depth_limit=1), dict(depth_limit=2),
               dict(return_predecessors=False)):
        _assert_bfs_equal(ct.bfs(Gt, root, **kw), ctpu.bfs(Gj, root, **kw))
    _assert_bfs_equal(ct.bfs(Gt, source=root), ctpu.bfs(Gj, source=root))
    _assert_sssp_equal(ct.sssp(Gt, indices=root), ctpu.sssp(Gj, root))
    _assert_sssp_equal(ct.sssp(Gt, root, cutoff=1.5),
                       ctpu.sssp(Gj, root, cutoff=1.5))
    Gj_u, Gt_u = _pair("random300", weighted=False)
    _assert_sssp_equal(ct.sssp(Gt_u, root), ctpu.sssp(Gj_u, root))
    pd.testing.assert_frame_equal(
        _sorted(ct.shortest_path_length(Gt, root)),
        _sorted(ctpu.shortest_path_length(Gj, root)), rtol=SSSP_RTOL)
    pd.testing.assert_frame_equal(
        _sorted(ct.shortest_path_length(Gt_u, root)),
        _sorted(ctpu.shortest_path_length(Gj_u, root)))
    target = _roots(Gt)[2]
    assert ct.shortest_path_length(Gt, root, target) == pytest.approx(
        ctpu.shortest_path_length(Gj, root, target), rel=SSSP_RTOL)
    for df_t, df_j in ((ct.bfs(Gt, root, depth_limit=2),
                        ctpu.bfs(Gj, root, depth_limit=2)),
                       (ct.sssp(Gt, root, cutoff=1.0),
                        ctpu.sssp(Gj, root, cutoff=1.0))):
        pd.testing.assert_frame_equal(
            _sorted(ct.filter_unreachable(df_t)),
            _sorted(ctpu.filter_unreachable(df_j)), rtol=SSSP_RTOL)


def test_errors_match_jax():
    Gj, Gt = _pair("karate")
    for pkg, G in ((ct, Gt), (ctpu, Gj)):
        with pytest.raises(TypeError, match="directed"):
            pkg.bfs(G, 0, directed=True)
        with pytest.raises(TypeError, match="directed"):
            pkg.sssp(G, 0, directed=True)
        with pytest.raises(ValueError, match="start vertex"):
            pkg.bfs(G)
        with pytest.raises(ValueError, match="source vertex"):
            pkg.sssp(G)
        with pytest.raises(ValueError, match="method"):
            pkg.sssp(G, 0, method="astar")
        with pytest.raises(ValueError, match="not in graph"):
            pkg.bfs(G, 1000)
        with pytest.raises(ValueError, match="target"):
            pkg.shortest_path_length(G, 0, 1000)
    src, dst = np.array([0, 1]), np.array([1, 2])
    w = np.array([1.0, -1.0], np.float32)
    with pytest.raises(ValueError, match="non-negative"):
        ct.sssp(ct.Graph(device="cpu").from_edgelist(src, dst, w), 0)


def test_sssp_reads_the_weight_checks_once_per_graph():
    """The negative-weight test and the delta heuristic's mean weight are
    computed at the first sssp call and kept on the Graph."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 0])
    w = np.array([1.0, 2.0, 4.5], np.float32)
    G = ct.Graph(device="cpu").from_edgelist(src, dst, w)
    ct.sssp(G, 0)
    s_w = G.edgelist_arrays()[2]
    assert G.weight_summary() == (False, float(np.mean(s_w)))
    assert traversal._sssp_delta(G) == 32.0 * float(np.mean(s_w)) / 2.0
    G._weight_summary = (True, 1.0)  # the kept answer is the one read
    with pytest.raises(ValueError, match="non-negative"):
        ct.sssp(G, 0)
    U = ct.Graph(device="cpu").from_edgelist(src, dst)
    assert U.weight_summary() == (False, 1.0)


@pytest.mark.parametrize("kind", ["karate", "email-Eu-core"])
def test_k_hop_neighbors_match_jax(kind):
    Gj, Gt = _pair(kind)
    roots = _roots(Gt)
    for k in (1, 2, 3):
        got = ct.k_hop_neighbors(Gt, roots, k)
        want = ctpu.algos.traversal.k_hop_neighbors(Gj, roots, k)
        pd.testing.assert_frame_equal(got, want)
    assert len(ct.k_hop_neighbors(Gt, roots[:1], 0)) == 0


def test_extract_bfs_paths_match_jax():
    Gj, Gt = _pair("random300")
    root = _roots(Gt)[0]
    dests = _roots(Gt, 10)
    for df_t, df_j in ((ct.bfs(Gt, root), ctpu.bfs(Gj, root)),
                       (ct.sssp(Gt, root), ctpu.sssp(Gj, root))):
        got = ct.extract_bfs_paths(Gt, df_t, dests)
        want = ctpu.extract_bfs_paths(Gj, df_j, dests)
        pd.testing.assert_frame_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    # an unreachable destination gets a row of -1
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.array([0, 3]), np.array([1, 4]), None, vertices=np.arange(5),
        renumber=False)
    offs, paths, max_len = ct.extract_bfs_paths(G, ct.bfs(G, 0), [1, 4])
    assert max_len == 2 and paths.tolist() == [0, 1, -1, -1]


def test_ids_past_two_to_the_sixteen():
    """A star of 70,000 leaves with a tail: the hub's id and the leaves'
    predecessors must come back exactly, with no id passed through a
    float32 selection (XLA route of the JAX package)."""
    leaves = 70_000
    hub = 5_000_000
    src = np.concatenate([np.full(leaves, hub), np.arange(leaves),
                          [leaves - 1, leaves + 1]])
    dst = np.concatenate([np.arange(leaves), np.full(leaves, hub),
                          [leaves + 1, leaves + 2]])
    w = np.random.default_rng(3).uniform(0.5, 1.5, len(src)).astype(
        np.float32)
    Gj = ctpu.Graph(directed=True).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    b = ct.bfs(Gt, 17)
    _assert_bfs_equal(b, ctpu.bfs(Gj, 17))
    assert traversal.LAST_RUN["dense_levels"] >= 1
    row = _sorted(b).set_index("vertex")
    assert row.loc[leaves + 2, "predecessor"] == leaves + 1
    assert row.loc[12_345, "predecessor"] == hub
    _assert_sssp_equal(ct.sssp(Gt, 17), ctpu.sssp(Gj, 17))


def test_sssp_parents_form_a_tree_where_jax_cycles():
    """An undirected edge lighter than the relaxation tolerance between two
    vertices at almost the same distance: the JAX package makes each the
    other's parent, which the Graph500 validator rejects; the port keeps
    the strictly closer one.  A zero-weight edge leaves its far end no
    strictly closer parent, and the host pass attaches it to the tree."""
    src = np.array([0, 0, 1, 3])
    dst = np.array([1, 2, 2, 4])
    w = np.array([1.0, 1.0 + 1e-6, 1e-6, 0.0], np.float32)
    src, dst = np.append(src, [0]), np.append(dst, [3])
    w = np.append(w, np.float32(2.0))
    Gj = ctpu.Graph().from_edgelist(src, dst, w)
    Gt = ct.Graph(device="cpu").from_edgelist(src, dst, w)
    want = _sorted(ctpu.sssp(Gj, 0))
    with pytest.raises(AssertionError, match="cycle"):
        validate_sssp_tree(src, dst, w, 0, want["distance"].to_numpy(),
                           want["predecessor"].to_numpy(),
                           vertices=want["vertex"].to_numpy())
    before = traversal.PRED_STRAGGLERS
    got = _sorted(ct.sssp(Gt, 0))
    assert traversal.PRED_STRAGGLERS == before + 1  # vertex 4, weight 0
    np.testing.assert_allclose(got["distance"], want["distance"],
                               rtol=SSSP_RTOL)
    assert got["predecessor"].tolist() == [-1, 0, 1, 0, 3]
    validate_sssp_tree(src, dst, w, 0, got["distance"].to_numpy(),
                       got["predecessor"].to_numpy(),
                       vertices=got["vertex"].to_numpy())


def test_frontier_prims_match_jax():
    rng = np.random.default_rng(9)
    n, m = 80, 400
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    jg = build_structure_host(src, dst, None, n)
    tg = build_structure(src, dst, None, n, "cpu")
    verts = np.array([-1, 3, 3, 17, 79, 80, 500])
    want = np.asarray(jfrontier.bitmap_from_vertices(verts, jg.pad_v))[:n]
    got = frontier.bitmap_from_vertices(torch.from_numpy(verts), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        frontier.vertices_from_bitmap(got, n).numpy(), [3, 17, 79])
    front = rng.random(n) < 0.2
    eligible = rng.random(n) < 0.7
    pad = np.zeros(jg.pad_v, bool)
    fj, ej = pad.copy(), pad.copy()
    fj[:n], ej[:n] = front, eligible
    nxt_j, pred_j = jfrontier.frontier_expand_by_dst(jg, fj, ej)
    before = sr.SEMIRING_LAUNCHES["max_left_i32"]
    nxt_t, pred_t = frontier.frontier_expand_by_dst(
        tg, torch.from_numpy(front), torch.from_numpy(eligible))
    assert sr.SEMIRING_LAUNCHES["max_left_i32"] == before  # CPU: no launch
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j)[:n])
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j)[:n])


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _edges("rmat12")
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst, w)
    root = _roots(Gc)[0]
    before = dict(sr.SEMIRING_LAUNCHES), dict(sr.SELECT_LAUNCHES)
    b = ct.bfs(Gg, root)
    s = ct.sssp(Gg, root)
    assert sr.SEMIRING_LAUNCHES["max_left_i32"] > before[0]["max_left_i32"]
    assert sr.SEMIRING_LAUNCHES["min_add"] > before[0]["min_add"]
    assert sr.SELECT_LAUNCHES["eqsel_rel_unit"] == \
        before[1]["eqsel_rel_unit"] + 1
    assert sr.SELECT_LAUNCHES["eqsel_rel"] == before[1]["eqsel_rel"] + 1
    _assert_bfs_equal(b, ct.bfs(Gc, root))
    _assert_sssp_equal(s, ct.sssp(Gc, root))
    assert traversal.PRED_STRAGGLERS == 0
