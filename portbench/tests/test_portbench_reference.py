"""The plain references and the generator against independent oracles:
networkx and scipy on karate and a tiny R-MAT, dense autograd, NumPy."""

import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import kronecker
from portbench.reference import graph as rgraph
from portbench.reference import pagerank as rpr
from portbench.reference import sage_fullbatch as rsage


def _karate():
    g = nx.karate_club_graph()
    e = np.array(g.edges(), dtype=np.int64)
    return g, torch.as_tensor(e[:, 0]), torch.as_tensor(e[:, 1])


def _rmat(scale=8, edges=3000, seed=5):
    return kronecker.kronecker_edges(scale, edges,
                                     kronecker.generator(seed, "cpu"))


def test_generator_is_the_seed_s_and_simple_enough():
    s1, d1 = _rmat(seed=11)
    s2, d2 = _rmat(seed=11)
    s3, _ = _rmat(seed=12)
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert not torch.equal(s1[:100], s3[:100])
    assert bool((s1 != d1).all())                  # no self-loops
    assert int(s1.min()) >= 0 and int(max(s1.max(), d1.max())) < 1 << 8
    assert 2900 < s1.numel() <= 3000               # only loops dropped
    big, _ = kronecker.kronecker_edges(
        4, 10, kronecker.generator(2 ** 31 + 12345, "cpu"))
    assert big.numel() <= 10                       # seeds past 32 bits


def test_generator_skew_follows_a_b_c():
    # the vertex whose every bit is 0 before the permutation is a source
    # with probability (a + b)^scale and a target with (a + c)^scale:
    # 0.76^10 of the m edges each way
    s, d = kronecker.kronecker_edges(10, 200000, kronecker.generator(3, "cpu"))
    top = int(torch.bincount(torch.cat([s, d])).max())
    expect = 2 * 0.76 ** 10 * 200000
    assert 0.8 * expect < top < 1.2 * expect


def test_undirected_pairs_against_networkx():
    s, d = _rmat()
    ids, a, b = rgraph.simple_pairs(s, d)
    g = nx.Graph()
    g.add_edges_from(zip(s.tolist(), d.tolist()))
    assert ids.tolist() == sorted(g.nodes())
    assert a.numel() == g.number_of_edges()
    ids2, ss, dd = rgraph.undirected(s, d)
    assert ss.numel() == 2 * g.number_of_edges()


@pytest.mark.parametrize("graph", ["karate", "rmat"])
def test_pagerank_against_networkx(graph):
    if graph == "karate":
        g, s, d = _karate()
    else:
        s, d = _rmat()
        g = nx.Graph()
        g.add_edges_from(zip(s.tolist(), d.tolist()))
    ids, ss, dd = rgraph.undirected(s, d)
    p = rpr.pagerank(ss, dd, ids.numel(), 0.85, 200)
    want = nx.pagerank(g, alpha=0.85, tol=1e-14, max_iter=1000,
                       weight=None)
    got = dict(zip(ids.tolist(), p.tolist()))
    assert max(abs(got[k] - v) / v for k, v in want.items()) < 1e-9


def test_pagerank_fixed_iterations_against_scipy():
    s, d = _rmat(seed=8)
    ids, ss, dd = rgraph.undirected(s, d)
    n = ids.numel()
    a = sp.csr_matrix((np.ones(ss.numel()), (ss.numpy(), dd.numpy())),
                      shape=(n, n))
    deg = np.asarray(a.sum(axis=1)).ravel()
    p = np.full(n, 1.0 / n)
    for _ in range(20):
        p = 0.85 * (a.T @ (p / deg)) + 0.15 / n
    got = rpr.pagerank(ss, dd, n, 0.85, 20).numpy()
    np.testing.assert_allclose(got, p, rtol=1e-12)


def test_pull_sum_in_blocks_matches_scipy():
    s, d = _rmat()
    ids, ss, dd = rgraph.undirected(s, d)
    n = ids.numel()
    x = torch.randn(n, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    a = sp.csr_matrix((np.ones(ss.numel()), (ss.numpy(), dd.numpy())),
                      shape=(n, n))
    want = a.T @ x.numpy()
    for block in (7, 100, 1 << 27):
        got = rgraph.pull_sum(ss, dd, x, n, block=block).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12)


def _sage_inputs(steps=3):
    s, d = _rmat(seed=21)
    ids, _, _ = rgraph.simple_pairs(s, d)
    n = ids.numel()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, 6, generator=gen)
    labels = torch.randint(0, 3, (n,), generator=gen)
    mask = torch.rand(n, generator=gen) < 0.5
    init = [{"w_self": torch.randn(a, b, generator=gen) * 0.3,
             "w_nbr": torch.randn(a, b, generator=gen) * 0.3,
             "b": torch.randn(b, generator=gen) * 0.1}
            for a, b in ((6, 8), (8, 8), (8, 3))]
    return {"src": s.numpy(), "dst": d.numpy(), "x": x, "labels": labels,
            "mask": mask, "init": init, "lr": 0.01, "betas": (0.9, 0.999),
            "eps": 1e-8, "steps": steps}


def _dense_sage(inputs):
    """The same model on a dense adjacency, autograd and torch's Adam."""
    s = torch.as_tensor(inputs["src"])
    d = torch.as_tensor(inputs["dst"])
    ids, ss, dd = rgraph.undirected(s, d)
    n = ids.numel()
    adj = torch.zeros(n, n, dtype=torch.float64)
    adj[dd, ss] = 1.0
    mean = adj / adj.sum(1, keepdim=True)
    params = [{k: v.double().clone().requires_grad_(True)
               for k, v in layer.items()} for layer in inputs["init"]]
    leaves = [p[k] for p in params for k in rsage.LEAVES]
    opt = torch.optim.Adam(leaves, lr=inputs["lr"], betas=inputs["betas"],
                           eps=inputs["eps"])
    x = inputs["x"].double()
    losses, logits1, g1 = [], None, None
    for step in range(inputs["steps"]):
        h = x
        for i, p in enumerate(params):
            h = h @ p["w_self"] + (mean @ h) @ p["w_nbr"] + p["b"]
            if i + 1 < len(params):
                h = torch.relu(h)
        loss = torch.nn.functional.cross_entropy(
            h[inputs["mask"]], inputs["labels"][inputs["mask"]])
        opt.zero_grad()
        loss.backward()
        if step == 0:
            logits1 = h.detach()
            g1 = [float(t.grad.norm()) for t in leaves]
        opt.step()
        losses.append(loss.item())
    return losses, logits1, g1, leaves


def test_sage_reference_against_dense_autograd_and_torch_adam():
    inputs = _sage_inputs()
    ref = rsage.train(inputs, "cpu")
    losses, logits1, g1, leaves = _dense_sage(inputs)
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-12)
    torch.testing.assert_close(ref["logits"], logits1, rtol=1e-12, atol=0)
    np.testing.assert_allclose(list(ref["grad_norms"].values()), g1,
                               rtol=1e-12)
    start = [v.double() for layer in inputs["init"] for v in
             (layer[k] for k in rsage.LEAVES)]
    change = [float((t.detach() - s).norm()) for t, s in zip(leaves, start)]
    np.testing.assert_allclose(list(ref["change_norms"].values()), change,
                               rtol=1e-9)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -11 - 2 ** -20])
    want = [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10]
    # 1 + 2^-11 and 1 + 3 2^-11 are ties and round to even
    assert rsage.tf32(x).tolist() == want


def test_readings_are_zero_against_itself_and_see_a_changed_leaf():
    inputs = _sage_inputs()
    ref = rsage.train(inputs, "cpu")
    same = rsage.readings(ref, ref)
    assert all(v == 0.0 for v in same.values())
    frozen = dict(ref, change_norms={k: 0.0 for k in ref["change_norms"]})
    assert rsage.readings(ref, frozen)["change_norm_gap"] == 1.0
