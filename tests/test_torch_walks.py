"""The port's random walks against cugraph_tpu on the CPU.

Uniform and biased first-order walks, fed the JAX package's per-step
uniforms (``tests/torch_port_draws.walk_uniforms``), give its paths and
edge weights bit for bit: both draw ``floor(u·deg)`` or search the same
float32 cumulative weights.  node2vec sums each step's float32 scores
(``cumsum`` and the row total) in another order than XLA does, so its
factor tile and CDF are held within rtol 1e-6, and its picks step by step
(each step from the JAX package's own (cur, prev)): equal at every step
whose draw u·total does not lie within 1e-5 (relative) of a CDF step; the
test counts the steps it excluded and allows at most 0.1 %.  The public
functions are checked on the port's own draws: every step an edge, -1
after a sink, and the frames' layout.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cugraph_tpu as ctpu
from cugraph_tpu.algos import sampling as jS
from cugraph_tpu.prims import intersection as jI

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import sampling as tS
from torch_port_draws import walk_uniforms

torch.set_num_threads(1)
N2V_EXCLUDE_RTOL = 1e-5


def _rmat_like(scale, m, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= 0.76).astype(np.int64) << bit
        dst |= (((r >= 0.57) & (r < 0.76)) | (r >= 0.95)).astype(np.int64) \
            << bit
    return src, dst


def _graph(kind):
    """(src, dst, weights, directed)."""
    if kind == "karate_w":
        e = np.array(list(nx.karate_club_graph().edges(data="weight")))
        return e[:, 0], e[:, 1], e[:, 2].astype(np.float32), False
    if kind == "rmat9_sinks":   # directed, with sinks and zero weights
        src, dst = _rmat_like(9, 3000, 7)
        w = np.random.default_rng(8).uniform(0.1, 2.0, len(src))
        w[::13] = 0.0
        return src, dst + 200, w.astype(np.float32), True
    if kind == "rmat9_u":
        src, dst = _rmat_like(9, 2500, 9)
        w = np.random.default_rng(10).uniform(0.5, 1.5, len(src))
        return src, dst, w.astype(np.float32), False
    raise KeyError(kind)


def _pair(kind):
    src, dst, w, directed = _graph(kind)
    return (ctpu.Graph(directed=directed).from_edgelist(src, dst, w),
            ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst,
                                                                    w))


def _starts(Gt, W, seed):
    n = Gt.number_of_vertices()
    return np.random.default_rng(seed).integers(0, n, W).astype(np.int32)


@pytest.mark.parametrize("kind", ["karate_w", "rmat9_sinks"])
@pytest.mark.parametrize("biased", [False, True])
def test_walks_match_jax(kind, biased):
    Gj, Gt = _pair(kind)
    W, depth = 64, 12
    starts = _starts(Gt, W, 3)
    cumw_j = jS._row_cumweights(Gj.structure) if biased else None
    pj, wj = jS._walk_kernel(Gj.structure, jnp.asarray(starts),
                             jax.random.PRNGKey(17), depth, biased, cumw_j,
                             None)
    pt, wt = tS._walk_kernel(Gt.structure,
                             torch.from_numpy(starts.astype(np.int64)),
                             walk_uniforms(17, depth, W), depth, biased,
                             tS._row_cumweights(Gt.structure)
                             if biased else None)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    if kind == "rmat9_sinks":
        assert (pt.numpy() == -1).any()


def _node2vec_reference_scores(g, cur, prev, p, q, max_deg):
    """The JAX package's step (sampling.py:711-733) up to its CDF, on its
    CSR: (valid, factor, score, cdf, total)."""
    adj = g.csr
    safe_cur = jnp.clip(cur, 0, adj.pad_v - 1)
    nbr, valid, eidx = jI.enumerate_neighbors(adj, safe_cur, max_deg)
    w = jnp.take(adj.weights, eidx)
    is_back = nbr == prev[:, None]
    near, _ = jI.lower_bound_rows(
        adj, jnp.clip(prev, 0, adj.pad_v - 1)[:, None], nbr)
    factor = jnp.where(is_back, 1.0 / p, jnp.where(near, 1.0, 1.0 / q))
    factor = jnp.where((prev >= 0)[:, None], factor, 1.0)
    score = jnp.where(valid, w * factor, 0.0)
    return (np.asarray(valid), np.asarray(factor), np.asarray(score),
            np.asarray(jnp.cumsum(score, axis=1)),
            np.asarray(jnp.sum(score, axis=1)))


@pytest.mark.parametrize("kind", ["karate_w", "rmat9_u", "rmat9_sinks"])
def test_node2vec_matches_jax(kind):
    Gj, Gt = _pair(kind)
    W, depth, p, q = 128, 10, 0.5, 2.0
    starts = _starts(Gt, W, 5)
    D = tS._max_out_degree(Gt.structure)
    paths = np.asarray(jS._node2vec_kernel(
        Gj.structure, jnp.asarray(starts), jax.random.PRNGKey(23), depth, p,
        q, D, None)[0])
    u = walk_uniforms(23, depth, W)
    excluded = compared = 0
    for i in range(depth):
        cur = paths[:, i]
        prev = paths[:, i - 1] if i else np.full(W, -1, np.int32)
        v_j, f_j, s_j, cdf_j, tot_j = _node2vec_reference_scores(
            Gj.structure, jnp.asarray(cur), jnp.asarray(prev), p, q, D)
        cur_t = torch.from_numpy(cur.astype(np.int64))
        prev_t = torch.from_numpy(prev.astype(np.int64))
        _, f_t, s_t, cdf_t = tS._node2vec_scores(Gt.structure.csr, cur_t,
                                                 prev_t, p, q, D)
        live = cur >= 0
        lanes = v_j & live[:, None]    # lanes past a row's degree differ
        np.testing.assert_allclose(f_t.numpy()[lanes], f_j[lanes], rtol=1e-6)
        np.testing.assert_allclose(s_t.numpy()[live], s_j[live], rtol=1e-6)
        np.testing.assert_allclose(cdf_t.numpy()[live], cdf_j[live],
                                   rtol=1e-6, atol=1e-6 * tot_j.max())
        nxt, _ = tS._node2vec_step(Gt.structure.csr, cur_t, prev_t, u[i], p,
                                   q, D)
        target = u[i].numpy().astype(np.float64) * tot_j
        near = (np.abs(cdf_j - target[:, None])
                <= N2V_EXCLUDE_RTOL * target[:, None]).any(axis=1) \
            & (target > 0)
        keep = live & ~near
        excluded += int((live & near).sum())
        compared += int(live.sum())
        np.testing.assert_array_equal(nxt.numpy()[keep], paths[keep, i + 1])
        np.testing.assert_array_equal(nxt.numpy()[~live], -1)
    print(f"node2vec {kind}: {excluded} of {compared} steps excluded")
    assert compared > 350
    assert excluded <= 0.001 * compared


def _assert_walks_follow_edges(G, vp, W, depth, by_weight):
    """Every step an edge, -1 after a sink and ever after; ``by_weight``:
    a vertex whose out-edges all weigh 0 also ends a walk (node2vec's
    ``tot <= 0``)."""
    src, dst, w = G.edgelist_arrays()
    ext = G.nodes()
    edges = set(zip(ext[src].tolist(), ext[dst].tolist()))
    out = np.bincount(src, weights=w if by_weight else None,
                      minlength=len(ext))
    deg = dict(zip(ext.tolist(), out))
    p = vp.to_numpy().reshape(W, depth + 1)
    for row in p:
        for a, b in zip(row[:-1], row[1:]):
            if a == -1:
                assert b == -1
            elif b == -1:
                assert deg[a] == 0
            else:
                assert (a, b) in edges
    return p


@pytest.mark.parametrize("walk", ["uniform", "biased", "node2vec"])
def test_public_walks_follow_edges(walk):
    _, Gt = _pair("rmat9_sinks")
    starts = Gt.nodes()[_starts(Gt, 40, 6)]
    fn = {"uniform": ct.uniform_random_walks,
          "biased": ct.biased_random_walks,
          "node2vec": lambda G, s, d, random_state: ct.node2vec_random_walks(
              G, s, d, p=0.5, q=2.0, random_state=random_state)}[walk]
    vp, wp, d = fn(Gt, starts, 8, random_state=2)
    assert d == 8 and len(vp) == 40 * 9 and len(wp) == 40 * 8
    p = _assert_walks_follow_edges(Gt, vp, 40, 8, walk == "node2vec")
    np.testing.assert_array_equal(p[:, 0], starts)
    w = wp.to_numpy().reshape(40, 8)
    assert ((p[:, 1:] == -1) <= (w == 0)).all()
    vp2, _, _ = fn(Gt, starts, 8, random_state=2)
    np.testing.assert_array_equal(vp2.to_numpy(), vp.to_numpy())
    if walk == "biased":   # a zero-weight edge only out of a zero row
        src, _, wt = Gt.edgelist_arrays()
        wsum = dict(zip(Gt.nodes().tolist(),
                        np.bincount(src, weights=wt,
                                    minlength=Gt.number_of_vertices())))
        zero = (w == 0) & (p[:, 1:] != -1)
        assert all(wsum[a] == 0 for a in p[:, :-1][zero].tolist())


def test_walk_aliases_and_errors():
    _, Gt = _pair("karate_w")
    a = ct.random_walks(Gt, [0, 1], 4, random_state=3)
    b = ct.uniform_random_walks(Gt, [0, 1], 4, random_state=3)
    np.testing.assert_array_equal(a[0].to_numpy(), b[0].to_numpy())
    c = ct.node2vec(Gt, [0, 1], 4)
    d = ct.node2vec_random_walks(Gt, [0, 1], 4)
    np.testing.assert_array_equal(c[0].to_numpy(), d[0].to_numpy())
    unweighted = ct.Graph(device="cpu").from_edgelist(np.array([0, 1]),
                                                      np.array([1, 2]))
    with pytest.raises(ValueError, match="edge weights"):
        ct.biased_random_walks(unweighted, [0], 3)
    # unweighted walks carry weight 1.0 per step, as the JAX package's
    _, w, _ = ct.random_walks(unweighted, [0], 3, random_state=0)
    assert set(w.tolist()) <= {0.0, 1.0}
    empty = ct.random_walks(unweighted, [0], 0)
    assert len(empty[0]) == 1 and len(empty[1]) == 0


@pytest.mark.cuda
def test_walks_on_the_card_match_the_cpu():
    """The same per-step uniforms give the same walks on the card as on
    the CPU (uniform and biased bit for bit; node2vec's float32 sums may
    order differently, so its paths are held to 99 % of steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _graph("rmat9_u")
    W, depth = 256, 16
    u = torch.rand((depth, W), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        G = ct.Graph(directed=directed, device=dev).from_edgelist(src, dst, w)
        g = G.structure
        starts = torch.arange(W, device=dev) % g.num_vertices
        out[dev] = [
            tS._walk_kernel(g, starts, u.to(dev), depth, False, None),
            tS._walk_kernel(g, starts, u.to(dev), depth, True,
                            tS._row_cumweights(g)),
            tS._node2vec_kernel(g, starts, u.to(dev), depth, 0.5, 2.0,
                                tS._max_out_degree(g))]
    for i, ((pc, wc), (pg, wg)) in enumerate(zip(out["cpu"], out["cuda"])):
        if i < 2:
            torch.testing.assert_close(pg.cpu(), pc, rtol=0, atol=0)
            torch.testing.assert_close(wg.cpu(), wc, rtol=0, atol=0)
        else:
            assert (pg.cpu() == pc).float().mean() > 0.99
