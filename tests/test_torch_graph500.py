"""The port's copy of the Graph500 validators against cugraph_tpu's.

Both must accept the same valid trees and reject the same broken ones,
naming the same rule; the TEPS summary must agree to the last bit.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu.testing.graph500 as jg500

import cugraph_tpu_torch as ct
import cugraph_tpu_torch.testing.graph500 as tg500

torch.set_num_threads(1)
UNREACHED = 2**31 - 1


def _graph(n, m, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    return (key // n).astype(np.int64), (key % n).astype(np.int64)


def _verdict(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except AssertionError as err:
        return str(err)


def _same_verdict(name, *args, **kw):
    got = _verdict(getattr(tg500, name), *args, **kw)
    want = _verdict(getattr(jg500, name), *args, **kw)
    assert got == want
    return got


def _bfs_tree(directed):
    n = 200
    src, dst = _graph(n, 900, 3)
    G = ct.Graph(directed=directed, device="cpu").from_edgelist(
        src, dst, renumber=False)
    root = int(src[0])
    df = ct.bfs(G, root).sort_values("vertex")
    return (src, dst, root, df["distance"].to_numpy().copy(),
            df["predecessor"].to_numpy().copy())


def _bfs_breaks(src, dst, root, dist, pred):
    """(rule, distances, predecessors): one broken tree per rule."""
    n = len(dist)
    reached = np.flatnonzero((dist < UNREACHED) & (np.arange(n) != root))
    v = int(reached[-1])
    out = []
    bad = dist.copy()
    bad[root] = 1
    out.append(("root distance", bad, pred))
    bad_pred = pred.copy()
    bad_pred[root] = v
    out.append(("root parent", dist, bad_pred))
    bad_pred = pred.copy()
    bad_pred[v] = -1
    out.append(("missing parent", dist, bad_pred))
    bad = dist.copy()
    bad[v] += 5
    out.append(("distance step", bad, pred))
    nbrs = set(dst[src == v]) | set(src[dst == v])
    bad_pred = pred.copy()
    bad_pred[v] = next(u for u in range(n) if u not in nbrs and u != v
                       and dist[u] == dist[v] - 1)
    out.append(("not an edge", dist, bad_pred))
    bad, bad_pred = dist.copy(), pred.copy()
    bad[v], bad_pred[v] = UNREACHED, -1
    out.append(("component", bad, bad_pred))
    bad_pred = pred.copy()
    bad_pred[v] = n + 5
    out.append(("out of range", dist, bad_pred))
    return out


@pytest.mark.parametrize("directed", [False, True])
def test_bfs_validators_agree(directed):
    src, dst, root, dist, pred = _bfs_tree(directed)
    assert _same_verdict("validate_bfs_tree", src, dst, root, dist, pred,
                         directed=directed) is True
    # a non-contiguous id space through ``vertices``
    verts = np.arange(len(dist)) * 3 + 1
    ext_pred = np.where(pred >= 0, pred * 3 + 1, -1)
    assert _same_verdict("validate_bfs_tree", src * 3 + 1, dst * 3 + 1,
                         root * 3 + 1, dist, ext_pred, directed=directed,
                         vertices=verts) is True
    for rule, d, p in _bfs_breaks(src, dst, root, dist, pred):
        verdict = _same_verdict("validate_bfs_tree", src, dst, root, d, p,
                                directed=directed)
        assert verdict is not True, rule


@pytest.mark.parametrize("directed", [False, True])
def test_sssp_validators_agree(directed):
    n = 200
    src, dst = _graph(n, 900, 9)
    w = (1.0 - np.random.default_rng(6).random(len(src))).astype(np.float32)
    G = ct.Graph(directed=directed, device="cpu").from_edgelist(
        src, dst, w, renumber=False)
    root = int(src[0])
    df = ct.sssp(G, root).sort_values("vertex")
    dist = df["distance"].to_numpy().copy()
    pred = df["predecessor"].to_numpy().copy()
    assert _same_verdict("validate_sssp_tree", src, dst, w, root, dist, pred,
                         directed=directed) is True
    fmax = np.float64(np.finfo(np.float32).max)
    reached = np.flatnonzero((dist < fmax) & (np.arange(n) != root))
    v = int(reached[-1])
    breaks = []
    bad = dist.copy()
    bad[v] += 5.0
    breaks.append(bad)  # distance step
    bad = dist.copy()
    bad[reached[0]] = dist.max() * 3 + 7
    breaks.append(bad)  # an edge that relaxes further
    broken_pred = []
    bp = pred.copy()
    bp[v] = -1
    broken_pred.append(bp)  # missing parent
    nbrs = set(dst[src == v]) | set(src[dst == v])
    bp = pred.copy()
    bp[v] = next(u for u in range(n) if u not in nbrs and u != v)
    broken_pred.append(bp)  # not an edge
    a = v
    b = int(pred[a])
    if b != root:  # a 2-cycle in the parent pointers
        bp = pred.copy()
        bp[b] = a
        broken_pred.append(bp)
    for d in breaks:
        assert _same_verdict("validate_sssp_tree", src, dst, w, root, d,
                             pred, directed=directed) is not True
    for p in broken_pred:
        assert _same_verdict("validate_sssp_tree", src, dst, w, root, dist,
                             p, directed=directed) is not True
    neg = w.copy()
    neg[0] = -1.0
    assert "nonneg" in _same_verdict("validate_sssp_tree", src, dst, neg,
                                     root, dist, pred, directed=directed)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("ids", ["positions", "vertices", "sparse_vertices"])
def test_prepared_edges_give_the_public_verdicts(directed, ids):
    """The validators' split: one edge list prepared once
    (``_bfs_edges``/``_sssp_edges``) and checked for many trees
    (``_check_bfs``/``_check_sssp``) gives, tree by tree, the verdict of
    the public function, failing ones included, and the JAX package's."""
    n = 200
    src, dst = _graph(n, 900, 11)
    w = (1.0 - np.random.default_rng(4).random(len(src))).astype(np.float32)
    # "vertices" ids take the validators' dense table, "sparse_vertices"
    # ids (far above 4n) their binary search
    scale, shift = {"positions": (1, 0), "vertices": (3, 1),
                    "sparse_vertices": (1000, 7)}[ids]
    verts = None if ids == "positions" else np.arange(n) * scale + shift
    es, ed = src * scale + shift, dst * scale + shift
    bfs_edges = tg500._bfs_edges(es, ed, n, directed=directed,
                                 vertices=verts)
    sssp_edges = tg500._sssp_edges(es, ed, w, n, directed=directed,
                                   vertices=verts)
    G = ct.Graph(directed=directed, device="cpu").from_edgelist(
        src, dst, w, renumber=False)
    checked = 0
    for root in (int(src[0]), int(src[7]), int(src[13])):
        b = ct.bfs(G, root).sort_values("vertex")
        d, p = b["distance"].to_numpy().copy(), b["predecessor"].to_numpy()
        trees = [("valid", d, p.copy())] + _bfs_breaks(src, dst, root, d,
                                                      p.copy())
        for rule, dist, pred in trees:
            ext = np.where(pred >= 0, pred * scale + shift, pred)
            r = root * scale + shift
            want = _verdict(tg500.validate_bfs_tree, es, ed, r, dist, ext,
                            directed=directed, vertices=verts)
            got = _verdict(tg500._check_bfs, bfs_edges, r, dist, ext,
                           directed=directed)
            assert got == want == _verdict(
                jg500.validate_bfs_tree, es, ed, r, dist, ext,
                directed=directed, vertices=verts), rule
            assert (want is True) == (rule == "valid"), rule
        sp_ = ct.sssp(G, root).sort_values("vertex")
        d, p = sp_["distance"].to_numpy().copy(), sp_["predecessor"].to_numpy()
        reached = np.flatnonzero(d < np.finfo(np.float32).max)
        bad_d = d.copy()
        bad_d[reached[-1]] += 5.0
        bad_p = p.copy()
        bad_p[reached[-1]] = -1
        for rule, dist, pred in (("valid", d, p), ("step", bad_d, p),
                                 ("parent", d, bad_p)):
            ext = np.where(pred >= 0, pred * scale + shift, pred)
            r = root * scale + shift
            want = _verdict(tg500.validate_sssp_tree, es, ed, w, r, dist,
                            ext, directed=directed, vertices=verts)
            got = _verdict(tg500._check_sssp, sssp_edges, r, dist, ext,
                           directed=directed)
            assert got == want == _verdict(
                jg500.validate_sssp_tree, es, ed, w, r, dist, ext,
                directed=directed, vertices=verts), rule
            assert (want is True) == (rule == "valid"), rule
            checked += 1
    assert checked == 9


def test_teps_summary_agrees():
    edges = [1e6, 2.5e6, 3e5]
    secs = [0.01, 0.02, 0.003]
    assert tg500.teps_summary(edges, secs) == jg500.teps_summary(edges, secs)
    assert ct.testing.teps_summary is tg500.teps_summary
