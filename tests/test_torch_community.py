"""The port's louvain, leiden, ecg and analyzeClustering_* against
cugraph_tpu on the CPU.

Both packages run the same native host engines over the same arrays, so
Louvain and ECG must give the same partitions bit for bit and the same
modularity (float64 in both level loops).  Leiden's native refinement is
keyed per level: fed the JAX package's level seeds it must give the same
partitions; its final modularity is float64 in the port and float32 in the
JAX package.  The torch local-moving sweep is held against the JAX
package's jitted sweep.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.algos import community as jcom

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import community as tcom
from cugraph_tpu_torch.core import native

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")
KINDS = ["karate", "dolphins", "netscience", "netscience_unweighted",
         "rmat10", "rmat12_weighted", "loops"]


def _edges(kind):
    """(src, dst, weights or None) of an undirected test graph."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None
    if kind.startswith(("dolphins", "netscience")):
        a = np.loadtxt(os.path.join(DATA, f"{kind.split('_')[0]}.csv"))
        w = None if kind.endswith("unweighted") else a[:, 2]
        return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), w
    if kind.startswith("rmat"):
        scale = int(kind[4:6])
        e = ctpu.rmat(scale, 8 << scale, seed=4)
        s, d = e["src"].to_numpy(), e["dst"].to_numpy()
        w = (np.random.default_rng(scale).integers(1, 9, len(s)) / 4.0
             if kind.endswith("weighted") else None)
        return s, d, w
    # "loops": random edges with self-loops, weighted
    rng = np.random.default_rng(5)
    s = rng.integers(0, 90, 600)
    d = np.where(rng.random(600) < 0.1, s, rng.integers(0, 90, 600))
    return s, d, rng.integers(1, 5, 600).astype(np.float32)


def _pair(kind):
    s, d, w = _edges(kind)
    return (ctpu.Graph().from_edgelist(s, d, w),
            ct.Graph(device="cpu").from_edgelist(s, d, w))


def _jax_level_seed(random_state, level):
    """The JAX package's per-level seed (community.py:374,415,429)."""
    import jax

    key = jax.random.fold_in(
        jax.random.key(0 if random_state is None else int(random_state)),
        level)
    return int(np.asarray(jax.random.key_data(key)).ravel()[-1])


def _assert_compact(df, n):
    p = df["partition"].to_numpy()
    assert len(p) == n
    assert set(np.unique(p)) == set(range(p.max() + 1))


@pytest.mark.parametrize("kind", KINDS)
def test_louvain_matches_jax(kind):
    Gj, Gt = _pair(kind)
    dj, qj = ctpu.louvain(Gj)
    dt, qt = ct.louvain(Gt)
    pd.testing.assert_frame_equal(dt, dj)
    assert abs(qt - qj) <= 1e-9
    _assert_compact(dt, Gt.number_of_vertices())


@pytest.mark.parametrize("kw", [dict(resolution=0.5), dict(resolution=2.0),
                                dict(max_level=1), dict(max_iter=2),
                                dict(threshold=1e-3)])
def test_louvain_options_match_jax(kw):
    Gj, Gt = _pair("netscience")
    dj, qj = ctpu.louvain(Gj, **kw)
    dt, qt = ct.louvain(Gt, **kw)
    pd.testing.assert_frame_equal(dt, dj)
    assert abs(qt - qj) <= 1e-9


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_ecg_matches_jax(kind, seed):
    Gj, Gt = _pair(kind)
    dj, qj = ctpu.ecg(Gj, random_state=seed)
    dt, qt = ct.ecg(Gt, random_state=seed)
    pd.testing.assert_frame_equal(dt, dj)
    assert abs(qt - qj) <= 1e-9


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_leiden_matches_jax_on_its_level_seeds(kind, seed, monkeypatch):
    monkeypatch.setattr(tcom, "level_seed", _jax_level_seed)
    Gj, Gt = _pair(kind)
    dj, qj = ctpu.leiden(Gj, random_state=seed)
    dt, qt = ct.leiden(Gt, random_state=seed)
    pd.testing.assert_frame_equal(dt, dj)
    assert abs(qt - qj) <= 1e-6


def test_leiden_refinement_follows_the_seed(monkeypatch):
    """The refinement's partition depends on the level seed: the JAX seeds
    and the port's own give different refinements on RMAT-12, both within
    their communities."""
    Gt = _pair("rmat12_weighted")[1]
    src, dst, w = Gt.edgelist_arrays()
    w = tcom._loop_doubled_weights(src, dst, w)
    n = Gt.number_of_vertices()
    lab, _ = tcom._louvain_one_level(src, dst, w, n, 1.0)
    a = tcom._leiden_refine(src, dst, w, n, lab, 1.0, 1.0,
                            tcom.level_seed(0, 0))
    b = tcom._leiden_refine(src, dst, w, n, lab, 1.0, 1.0,
                            _jax_level_seed(0, 0))
    assert not np.array_equal(a, b)
    for r in (a, b):
        assert np.all(lab[r] == lab)   # a sub-community lies in one community
        assert np.all(r[r] == r)       # labels are roots


@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat12_weighted"])
def test_leiden_own_seeds_structure(kind):
    """With the port's own level seeds: a compact partition whose
    communities are connected, modularity recomputed in float64 and near
    Louvain's or above, and the same partition twice."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    Gt = _pair(kind)[1]
    dt, qt = ct.leiden(Gt, random_state=3)
    n = Gt.number_of_vertices()
    _assert_compact(dt, n)
    lab = tcom._cluster_arrays(Gt, dt)
    src, dst, w = Gt.edgelist_arrays()
    keep = lab[src] == lab[dst]
    A = sp.csr_matrix((np.ones(int(keep.sum())), (src[keep], dst[keep])),
                      shape=(n, n))
    k, cc = csgraph.connected_components(A, directed=False)
    assert k == lab.max() + 1     # one component per community
    assert abs(ct.analyzeClustering_modularity(Gt, k, dt) - qt) <= 1e-12
    assert qt > 0.9 * ct.louvain(Gt)[1]
    pd.testing.assert_frame_equal(ct.leiden(Gt, random_state=3)[0], dt)


def test_level_seed_default_is_deterministic_and_varies():
    seeds = {tcom.level_seed(r, lv) for r in (None, 0, 1, 2) for lv in
             range(4)}
    assert tcom.level_seed(None, 2) == tcom.level_seed(0, 2)
    assert len(seeds) == 12
    assert all(0 <= s < 2**32 for s in seeds)


@pytest.mark.parametrize("kind", ["karate", "dolphins", "netscience",
                                  "rmat12_weighted", "loops"])
def test_analyze_clustering_matches_jax(kind):
    Gj, Gt = _pair(kind)
    n = Gt.number_of_vertices()
    frames = [ctpu.louvain(Gj)[0]]
    rng = np.random.default_rng(9)
    frames.append(pd.DataFrame({"vertex": Gj.nodes(),
                                "cluster": rng.integers(0, 6, n)}))
    for df in frames:
        k = int(df.iloc[:, 1].max()) + 1
        assert abs(ct.analyzeClustering_modularity(Gt, k, df)
                   - ctpu.analyzeClustering_modularity(Gj, k, df)) <= 1e-6
        assert ct.analyzeClustering_edge_cut(Gt, k, df) == \
            ctpu.analyzeClustering_edge_cut(Gj, k, df)
        assert ct.analyzeClustering_ratio_cut(Gt, k, df) == \
            ctpu.analyzeClustering_ratio_cut(Gj, k, df)


def _sweep_graphs():
    rng = np.random.default_rng(2)
    edges = []
    for base in (0, 10):
        for i in range(10):
            for j in range(i + 1, 10):
                if rng.random() < 0.8:
                    edges.append((base + i, base + j))
    edges.append((0, 10))
    e = np.array(edges)
    yield "cliques", np.concatenate([e[:, 0], e[:, 1]]), \
        np.concatenate([e[:, 1], e[:, 0]]), None, 20
    for kind in ("karate", "rmat10", "loops"):
        Gt = _pair(kind)[1]
        s, d, w = Gt.edgelist_arrays()
        yield kind, s, d, w, Gt.number_of_vertices()


@pytest.mark.parametrize("case", ["cliques", "karate", "rmat10", "loops"])
def test_louvain_move_sweep_torch_matches_jax(case):
    """Four alternating sweeps from singletons, each from the JAX sweep's
    previous clusters: the same clusters, and the modularity of each within
    1e-6 of the JAX package's float32 value."""
    import jax.numpy as jnp

    _, s, d, w, n = next(c for c in _sweep_graphs() if c[0] == case)
    w = tcom._loop_doubled_weights(s, d, w)
    sj, dj, wj, pad_v = jcom._pad_coo(s, d, w, n)
    cluster = np.arange(n, dtype=np.int32)
    up_down = True
    moved = False
    for _ in range(4):
        cj = np.arange(pad_v, dtype=np.int32)
        cj[:n] = cluster
        want = np.asarray(jcom._louvain_move_sweep(
            sj, dj, wj, jnp.asarray(cj), jnp.bool_(up_down),
            jnp.float32(1.0), pad_v))[:n]
        got = tcom._louvain_move_sweep_torch(
            torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(w),
            torch.from_numpy(cluster), up_down, 1.0, n).numpy()
        np.testing.assert_array_equal(got, want)
        cj[:n] = want
        q_jax = float(jcom._modularity(sj, dj, wj, jnp.asarray(cj),
                                       jnp.float32(1.0), pad_v))
        assert abs(tcom._modularity(s, d, w, got, 1.0, n) - q_jax) <= 1e-6
        moved |= not np.array_equal(want, cluster)
        cluster = want.astype(np.int32)
        up_down = not up_down
    assert moved


@pytest.mark.parametrize("fn", ["louvain", "leiden", "ecg"])
def test_directed_graph_raises_as_jax(fn):
    s, d, _ = _edges("karate")
    Gj = ctpu.Graph(directed=True).from_edgelist(s, d)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(s, d)
    with pytest.raises(ValueError, match="undirected") as ej:
        getattr(ctpu, fn)(Gj)
    with pytest.raises(ValueError, match="undirected") as et:
        getattr(ct, fn)(Gt)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("engine,fn", [("louvain_sweep", "louvain"),
                                       ("coarsen_edges", "louvain"),
                                       ("leiden_refine_sweep", "leiden"),
                                       ("louvain_sweep", "ecg")])
def test_engine_failure_raises(engine, fn, monkeypatch):
    """A nonzero return of an engine raises; the JAX package would fall
    back to its XLA sweeps, the port has no fallback."""
    lib = native.get_lib()

    class Failing:
        def __getattr__(self, name):
            if name == engine:
                return lambda *a: -1
            return getattr(lib, name)

    Gt = _pair("karate")[1]
    monkeypatch.setattr(native, "get_lib", lambda: Failing())
    with pytest.raises(RuntimeError, match=engine):
        getattr(ct, fn)(Gt)


def test_ecg_graph_stays_on_the_device_and_repeats():
    Gt = _pair("netscience")[1]
    a = ct.ecg(Gt, random_state=1, ensemble_size=4)
    b = ct.ecg(Gt, random_state=1, ensemble_size=4)
    pd.testing.assert_frame_equal(a[0], b[0])
    assert a[1] == b[1]
    c = ct.ecg(Gt, random_state=2, ensemble_size=4)
    assert isinstance(c[1], float)


@pytest.mark.cuda
def test_community_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, d, w = _edges("netscience")
    cpu = ct.Graph(device="cpu").from_edgelist(s, d, w)
    gpu = ct.Graph().from_edgelist(s, d, w)
    for fn in (ct.louvain, lambda G: ct.leiden(G, random_state=0),
               lambda G: ct.ecg(G, random_state=0)):
        a, b = fn(cpu), fn(gpu)
        pd.testing.assert_frame_equal(a[0], b[0])
        assert a[1] == b[1]
