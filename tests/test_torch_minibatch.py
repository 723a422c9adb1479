"""The port's sampled mini-batch GNN (``nn.minibatch``) and link
prediction (``nn.linkpred``) against cugraph_tpu on the CPU.

Batches: with the JAX package's draws fed to the port's sampler
(``tests/torch_port_draws.py``) and its neighbour tables off,
``make_batches`` gives the JAX package's batches bit for bit: the CSR and
CSC of each batch (the JAX package's padded past the live rows), the
global ids, the seed mask and the features.  GraphSAGE over one sampled
batch, with the JAX weights carried across by ``state_dict_from_jax``:
logits within rtol/atol 1e-5, and 5 Adam steps against ``optax.adam``
with losses within rtol 1e-5 and weights within atol 1e-4 (the
tolerances of tests/test_torch_nn.py, which says why).  Link prediction:
the decoders, the loss, ``roc_auc`` and ``hits_at_k`` within 1e-6;
``make_linkpred_train_step``, 5 steps against ``optax.adam``, within the
same training tolerances; ``sample_negatives`` degree-biased (NumPy
draws) bit for bit against the JAX package's ``negative_sampling`` fed
each vertex's degree in ``G.nodes()`` order, and its bias and the law of
its sources checked on karate.
"""

import networkx as nx
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import cugraph_tpu as ctpu
from cugraph_tpu import nn as jnn
from cugraph_tpu.algos import sampling as jS
from cugraph_tpu.nn import linkpred as jL
from cugraph_tpu.nn import minibatch as jM

import cugraph_tpu_torch as ct
from cugraph_tpu_torch import nn as tnn
from cugraph_tpu_torch.algos import sampling as tS
from cugraph_tpu_torch.nn import minibatch as tM
from torch_port_draws import CpuDraws, JaxDraws

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, HIDDEN, CLASSES = 6, 8, 3


def _community_graph(n_half=30, seed=0, weighted=False):
    """tests/test_minibatch.py's two communities, ids offset by 100."""
    rng = np.random.default_rng(seed)
    edges = set()
    for c in range(2):
        for _ in range(240):
            u, v = rng.integers(0, n_half, 2)
            if u != v:
                edges.add((c * n_half + u, c * n_half + v))
    src, dst = np.array(sorted(edges)).T
    w = (rng.uniform(0.5, 1.5, len(src)).astype(np.float32) if weighted
         else None)
    return src + 100, dst + 100, w, 2 * n_half


def _pair(weighted=False):
    src, dst, w, n = _community_graph(weighted=weighted)
    return (ctpu.Graph().from_edgelist(src, dst, w),
            ct.Graph(device="cpu").from_edgelist(src, dst, w), n)


@pytest.fixture
def fed_draws(monkeypatch):
    """The port's make_batches samples with the JAX package's draws, and
    the JAX package walks its CSR as the port does."""
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)

    def sample(G, seeds, fanouts, with_replacement=True, random_state=None):
        return tS._neighbor_sample(G, seeds, fanouts, with_replacement,
                                   False, random_state,
                                   draws=JaxDraws(random_state))

    monkeypatch.setattr(tM, "uniform_neighbor_sample", sample)


def _features(n):
    """Indexed by external id (100 .. 100 + n)."""
    return np.random.default_rng(1).normal(
        size=(100 + n, F_IN)).astype(np.float32)


def _assert_same_csr(got, want):
    n, m = got.num_vertices, got.num_edges
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets)[:n + 1])
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices)[:m])
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights)[:m])
    assert int(np.asarray(want.offsets)[n]) == m


@pytest.mark.parametrize("fanouts,batch_size", [([4, 3], 16), ([3, 2, 2], 7),
                                                ([5], 10)])
def test_make_batches_matches_jax(fed_draws, fanouts, batch_size):
    Gj, Gt, n = _pair()
    seeds = np.arange(100, 100 + n)[::-1]
    feats = _features(n)
    want = list(jM.make_batches(Gj, seeds, fanouts, batch_size=batch_size,
                                features=feats, random_state=3))
    got = list(tM.make_batches(Gt, seeds, fanouts, batch_size=batch_size,
                               features=feats, random_state=3))
    assert len(got) == len(want) == -(-n // batch_size)
    for (bt, xt), (bj, xj) in zip(got, want):
        k = bt.g.num_vertices
        assert bt.num_seeds == bj.num_seeds
        _assert_same_csr(bt.g.csr, bj.g.csr)
        _assert_same_csr(bt.g.csc, bj.g.csc)
        np.testing.assert_array_equal(bt.global_ids.numpy(),
                                      np.asarray(bj.global_ids)[:k])
        assert (np.asarray(bj.global_ids)[k:] == -1).all()
        np.testing.assert_array_equal(bt.seed_mask.numpy(),
                                      np.asarray(bj.seed_mask)[:k])
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj)[:k])
    # features given as a tensor are indexed where they lie
    got_t = list(tM.make_batches(Gt, seeds, fanouts, batch_size=batch_size,
                                 features=torch.from_numpy(feats),
                                 random_state=3))
    for (_, a), (_, b) in zip(got_t, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batch_from_sampling_matches_jax_and_its_bounds():
    Gj, Gt, n = _pair(weighted=True)
    df = ctpu.uniform_neighbor_sample(Gj, [100, 101, 140], [3, 2],
                                      random_state=1).assign(batch_id=0)
    pack = ctpu.sampling_results_to_batches(df)[0]
    want = jM.batch_from_sampling(pack, pad_vertices=64, pad_edges=128,
                                  num_seeds=2)
    got = tM.batch_from_sampling(pack, pad_vertices=64, pad_edges=128,
                                 num_seeds=2, device="cpu")
    _assert_same_csr(got.g.csr, want.g.csr)
    _assert_same_csr(got.g.csc, want.g.csc)
    assert got.num_seeds == 2 and int(got.seed_mask.sum()) == 2
    np.testing.assert_array_equal(got.global_ids.numpy(),
                                  np.asarray(want.global_ids)[
                                      :got.g.num_vertices])
    for mod in (tM, jM):
        with pytest.raises(ValueError, match="vertices > pad"):
            mod.batch_from_sampling(pack, pad_vertices=2, pad_edges=128,
                                    num_seeds=2, **(
                                        {"device": "cpu"} if mod is tM
                                        else {}))
        with pytest.raises(ValueError, match="edges > pad"):
            mod.batch_from_sampling(pack, pad_vertices=64, pad_edges=3,
                                    num_seeds=2, **(
                                        {"device": "cpu"} if mod is tM
                                        else {}))


def test_seeds_first_matches_the_list_comprehensions():
    rng = np.random.default_rng(5)
    vmap = rng.permutation(1000)[:300]
    seeds = np.concatenate([vmap[rng.integers(0, 300, 40)], [5000, 5001]])
    got_map, remap, k = tM._seeds_first(vmap, seeds)
    seed_set = set(int(s) for s in seeds)
    lead = [v for v in vmap if v in seed_set]
    rest = [v for v in vmap if v not in seed_set]
    reorder = {v: i for i, v in enumerate(lead + rest)}
    np.testing.assert_array_equal(got_map, np.array(lead + rest))
    np.testing.assert_array_equal(remap, np.array([reorder[v] for v in vmap]))
    assert k == len(lead)


def _port(cls, params, *args, **kw):
    module = cls(*args, device="cpu", **kw)
    module.load_state_dict(tnn.state_dict_from_jax(
        module, jax.tree_util.tree_map(np.asarray, params)))
    return module


def _assert_tree_close(got, want, **tol):
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_sampled_graphsage_matches_jax(fed_draws):
    """The forward and 5 Adam steps over one sampled batch."""
    Gj, Gt, n = _pair(weighted=True)
    seeds = np.arange(100, 100 + n, 2)
    feats = _features(n)
    labels = np.random.default_rng(2).integers(0, CLASSES, 100 + n)
    bj, xj = next(jM.make_batches(Gj, seeds, [4, 3], batch_size=16,
                                  features=feats))
    bt, xt = next(tM.make_batches(Gt, seeds, [4, 3], batch_size=16,
                                  features=feats))
    k = bt.g.num_vertices
    params = jnn.graphsage_init(jax.random.key(3), F_IN, HIDDEN, CLASSES)
    model = _port(tnn.GraphSAGE, params, F_IN, HIDDEN, CLASSES)
    want = np.asarray(jax.jit(jM.sage_minibatch_forward)(params, bj, xj))
    got = tM.sage_minibatch_forward(model, bt, xt).detach().numpy()
    np.testing.assert_allclose(got, want[:k], **TOL)

    gid = np.asarray(bj.global_ids)
    yj = jnp.asarray(np.where(gid >= 0, labels[np.maximum(gid, 0)], 0))
    yt = torch.from_numpy(labels[bt.global_ids.numpy()])
    opt = optax.adam(1e-2)
    state = opt.init(params)
    step_j = jax.jit(jnn.make_train_step(jnn.graphsage_apply, opt))
    step_t = tnn.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                         lr=1e-2))
    losses_j, losses_t = [], []
    for _ in range(5):
        params, state, loss = step_j(params, state, bj.g, xj, yj,
                                     bj.seed_mask)
        losses_j.append(float(loss))
        losses_t.append(float(step_t(bt.g, xt, yt, bt.seed_mask)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    _assert_tree_close(tnn.jax_params_from_state_dict(model), params,
                       rtol=0, atol=1e-4)


# -- link prediction ----------------------------------------------------------

def _embeddings(n=40, f=F_IN, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n, 64).astype(np.int32)
    dst = rng.integers(0, n, 64).astype(np.int32)
    return z, src, dst


def test_decoders_match_jax():
    z, src, dst = _embeddings()
    zj, sj, dj = map(jnp.asarray, (z, src, dst))
    zt, st, dt = map(torch.from_numpy, (z, src, dst))
    np.testing.assert_allclose(tnn.dot_decoder(zt, st, dt).numpy(),
                               np.asarray(jL.dot_decoder(zj, sj, dj)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tnn.DotDecoder()(zt, st, dt).numpy(),
                               np.asarray(jL.dot_decoder(zj, sj, dj)),
                               rtol=1e-6, atol=1e-6)
    p_mlp = jL.mlp_decoder_init(jax.random.key(1), F_IN, 16)
    mlp = _port(tnn.MLPDecoder, p_mlp, F_IN, 16)
    np.testing.assert_allclose(mlp(zt, st, dt).detach().numpy(),
                               np.asarray(jL.mlp_decoder(p_mlp, zj, sj, dj)),
                               rtol=1e-6, atol=1e-6)
    p_dm = jL.distmult_decoder_init(jax.random.key(2), F_IN, 3)
    dm = _port(tnn.DistMultDecoder, p_dm, F_IN, 3)
    rel = np.arange(64, dtype=np.int32) % 3
    for r in (None, rel):
        want = jL.distmult_decoder(p_dm, zj, sj, dj,
                                   None if r is None else jnp.asarray(r))
        got = dm(zt, st, dt, None if r is None else torch.from_numpy(r))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    for module, params in ((mlp, p_mlp), (dm, p_dm)):
        _assert_tree_close(tnn.jax_params_from_state_dict(module),
                           jax.tree_util.tree_map(np.asarray, params),
                           rtol=0, atol=0)


def test_decoder_initial_weights_follow_the_generator():
    a = tnn.MLPDecoder(4, 8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    b = tnn.MLPDecoder(4, 8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    for x, y in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.w1.weight.shape == (8, 8)
    assert float(a.w1.bias.detach().abs().sum()) == 0
    d = tnn.DistMultDecoder(5, 2, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert d.rel.shape == (2, 5) and float(d.rel.detach().abs().max()) < 1.0


@pytest.mark.parametrize("ties", [False, True])
def test_loss_and_metrics_match_jax(ties):
    rng = np.random.default_rng(4)
    pos = rng.normal(0.5, 1.0, 300).astype(np.float32)
    neg = rng.normal(-0.5, 1.0, 500).astype(np.float32)
    if ties:
        pos, neg = np.round(pos, 1), np.round(neg, 1)
    pj, nj = jnp.asarray(pos), jnp.asarray(neg)
    pt, nt = torch.from_numpy(pos), torch.from_numpy(neg)
    for got, want in (
            (tnn.link_prediction_loss(pt, nt),
             jL.link_prediction_loss(pj, nj)),
            (tnn.roc_auc(pt, nt), jL.roc_auc(pj, nj)),
            (tnn.hits_at_k(pt, nt, 20), jL.hits_at_k(pj, nj, 20)),
            (tnn.hits_at_k(pt, nt, 10_000), jL.hits_at_k(pj, nj, 10_000))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("decoder", ["dot", "mlp"])
def test_linkpred_training_matches_optax(decoder):
    Gj, Gt, n = _pair(weighted=True)
    gj, gt = Gj.structure, Gt.structure
    x = np.random.default_rng(6).normal(size=(n, F_IN)).astype(np.float32)
    xj = jnp.zeros((gj.pad_v, F_IN)).at[:n].set(x)
    xt = torch.from_numpy(x)
    src, dst, _ = Gt.edgelist_arrays()
    pos = np.random.default_rng(7).integers(0, len(src), 50)
    ns, nd = jL.sample_negatives(Gj, 50, random_state=1)
    arrays = (src[pos], dst[pos], np.array(ns), np.array(nd))
    params = {"encoder": jnn.graphsage_init(jax.random.key(8), F_IN, HIDDEN,
                                            HIDDEN)}
    encoder = _port(tnn.GraphSAGE, params["encoder"], F_IN, HIDDEN, HIDDEN)
    if decoder == "dot":
        dec_j, dec_t = jL.dot_decoder, tnn.dot_decoder
        trainable = list(encoder.parameters())
    else:
        params["decoder"] = jL.mlp_decoder_init(jax.random.key(9), HIDDEN, 16)
        dec_j = jL.mlp_decoder
        dec_t = _port(tnn.MLPDecoder, params["decoder"], HIDDEN, 16)
        trainable = list(encoder.parameters()) + list(dec_t.parameters())
    opt = optax.adam(1e-2)
    state = opt.init(params)
    step_j = jax.jit(jL.make_linkpred_train_step(jnn.graphsage_apply, dec_j,
                                                 opt))
    step_t = tnn.make_linkpred_train_step(
        encoder, dec_t, torch.optim.Adam(trainable, lr=1e-2))
    losses_j, losses_t = [], []
    for _ in range(5):
        params, state, loss = step_j(params, state, gj, xj,
                                     *map(jnp.asarray, arrays))
        losses_j.append(float(loss))
        losses_t.append(float(step_t(gt, xt, *map(torch.from_numpy,
                                                  arrays))))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    _assert_tree_close(tnn.jax_params_from_state_dict(encoder),
                       params["encoder"], rtol=0, atol=1e-4)
    if decoder == "mlp":
        _assert_tree_close(tnn.jax_params_from_state_dict(dec_t),
                           params["decoder"], rtol=0, atol=1e-4)


def test_sample_negatives():
    """Degree-biased: NumPy draws only, so the JAX package's
    ``negative_sampling`` with each vertex's degree in ``G.nodes()`` order
    gives the same pairs bit for bit (its own ``sample_negatives`` sorts
    the degrees by external id first, which pairs a renumbered vertex
    with another's degree); uniform: int32 tensors on the graph's device,
    no edges, no self-loops, no duplicates."""
    Gj, Gt, n = _pair()
    deg = Gj.degree()["degree"].to_numpy(np.float64)
    df = ctpu.negative_sampling(Gj, 120, random_state=3, src_bias=deg,
                                dst_bias=deg)
    st, dt = tnn.sample_negatives(Gt, 120, random_state=3, degree_biased=True)
    np.testing.assert_array_equal(
        st.numpy(), Gj.lookup_internal_vertex_id(df["src"].to_numpy()))
    np.testing.assert_array_equal(
        dt.numpy(), Gj.lookup_internal_vertex_id(df["dst"].to_numpy()))
    s, d = tnn.sample_negatives(Gt, 200, random_state=4)
    assert s.dtype == d.dtype == torch.int32 and s.device == Gt.device
    src, dst, _ = Gt.edgelist_arrays()
    edges = set(zip(src.tolist(), dst.tolist()))
    pairs = list(zip(s.tolist(), d.tolist()))
    assert len(pairs) == 200 and len(set(pairs)) == 200
    assert not any(p in edges or p[0] == p[1] for p in pairs)


def test_sample_negatives_degree_bias_follows_each_vertex(monkeypatch):
    """On karate, whose renumbering by degree reorders the vertices, the
    bias that ``sample_negatives(degree_biased=True)`` hands to
    ``negative_sampling`` is each ``G.nodes()`` vertex's own degree, and
    20,000 draws with that bias (no exclusion, no dedupe) pick each source
    with probability p(1 - p) / (1 - Σp²), p = degree / Σdegree (a drawn
    self-loop is dropped): χ² (33 dof) below 63.9, its 0.999 quantile."""
    e = np.array(list(nx.karate_club_graph().edges()))
    Gt = ct.Graph(device="cpu").from_edgelist(e[:, 0], e[:, 1])
    assert not np.array_equal(Gt.nodes(), np.sort(Gt.nodes()))
    seen = {}
    real = tnn.linkpred.negative_sampling

    def spy(G, **kw):
        seen.update(kw)
        return real(G, **kw)

    monkeypatch.setattr(tnn.linkpred, "negative_sampling", spy)
    tnn.sample_negatives(Gt, 50, random_state=0, degree_biased=True)
    nxg = nx.karate_club_graph()
    want = np.array([nxg.degree(int(v)) for v in Gt.nodes()], np.float64)
    np.testing.assert_array_equal(seen["src_bias"], want)
    np.testing.assert_array_equal(seen["dst_bias"], want)
    df = real(Gt, num_samples=20_000, src_bias=want, dst_bias=want,
              remove_duplicates=False, remove_existing_edges=False,
              random_state=1)
    p = want / want.sum()
    expect = len(df) * p * (1 - p) / (1 - (p ** 2).sum())
    counts = (pd.Series(df["src"].to_numpy()).value_counts()
              .reindex(Gt.nodes(), fill_value=0).to_numpy())
    assert len(df) == 20_000
    assert ((counts - expect) ** 2 / expect).sum() < 63.9


@pytest.mark.cuda
def test_sampled_step_on_the_card_matches_cpu(monkeypatch):
    """One batch, the same draws on both: the card's batch equals the
    CPU's, and one GraphSAGE step on it (K4 over its CSC and CSR) gives
    the CPU's loss within rtol 1e-5 and gradients within 1e-4 of their
    largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, n = _community_graph(weighted=True)
    feats = _features(n)
    labels = np.random.default_rng(2).integers(0, CLASSES, 100 + n)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(
            tM, "uniform_neighbor_sample",
            lambda G, s, f, with_replacement=True, random_state=None:
            tS._neighbor_sample(G, s, f, with_replacement, False,
                                random_state,
                                draws=CpuDraws(random_state, dev)))
        G = ct.Graph(device=dev).from_edgelist(src, dst, w)
        b, x = next(tM.make_batches(G, np.arange(100, 100 + n, 2), [4, 3],
                                    batch_size=16, features=feats))
        model = tnn.GraphSAGE(F_IN, HIDDEN, CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(0))
        step = tnn.make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-2))
        y = torch.from_numpy(labels[b.global_ids.cpu().numpy()]).to(dev)
        loss = step(b.g, x, y, b.seed_mask)
        out[dev] = (b.global_ids.cpu(), float(loss),
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=0)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
    for k, want in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][k], want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
