"""The port's components against cugraph_tpu on the CPU.

WCC labels are the smallest internal vertex id of each component, SCC
labels the largest internal id of each SCC, mapped to external ids, so the
frames must be identical: on the JAX package's XLA route, and for WCC on
its Pallas route in interpret mode (graphs of at most 500 vertices); the
hybrid WCC gives the default labels.  MIS and coloring draw priorities
from torch's generator, which never agrees with jax.random bit for bit:
fed the JAX package's own permutations, the port's rounds give its sets
and colours bit for bit; with its own generator they are checked as
independent, maximal and proper.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import components
from cugraph_tpu_torch.kernels import semiring as sr

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _random_sparse(n, m, seed, directed=True):
    """Sparse enough to fall apart into many components; ids shuffled so
    that labels are not just the first id of a run."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(10 * n)[:n]
    return ids[rng.integers(0, n, m)], ids[rng.integers(0, n, m)], directed


def _netscience():
    a = np.loadtxt(os.path.join(DATA, "netscience.csv"))
    return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), False


GRAPHS = {
    "sparse200": lambda: _random_sparse(200, 150, 1),
    "sparse500": lambda: _random_sparse(500, 420, 2),
    "sparse3000": lambda: _random_sparse(3000, 2600, 3),
    "sparse500_undirected": lambda: _random_sparse(500, 380, 4, False),
    "netscience": _netscience,
}


def _pair(kind):
    src, dst, directed = GRAPHS[kind]()
    return (ctpu.Graph(directed=directed).from_edgelist(src, dst),
            ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst))


def _assert_same(got, want):
    pd.testing.assert_frame_equal(
        got.sort_values("vertex").reset_index(drop=True),
        want.sort_values("vertex").reset_index(drop=True))


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_wcc_matches_jax_xla_route(kind):
    Gj, Gt = _pair(kind)
    got = ct.weakly_connected_components(Gt)
    _assert_same(got, ctpu.weakly_connected_components(Gj))
    assert got["labels"].nunique() > 1
    _assert_same(ct.connected_components(Gt, connection="weak"),
                 ctpu.connected_components(Gj, connection="weak"))


@pytest.mark.parametrize("kind", ["sparse200", "sparse500_undirected"])
def test_wcc_matches_jax_pallas_interpret(kind, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    Gj, Gt = _pair(kind)
    _assert_same(ct.weakly_connected_components(Gt),
                 ctpu.weakly_connected_components(Gj))


def test_wcc_labels_are_component_minima():
    """A path 0-1-...-9 directed one way, plus an isolated pair: every
    vertex of a component gets its smallest internal id."""
    src = np.array([*range(9), 20])
    dst = np.array([*range(1, 10), 21])
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        src, dst, renumber=False)
    df = ct.weakly_connected_components(G).set_index("vertex")
    assert (df.loc[list(range(10)), "labels"] == 0).all()
    assert (df.loc[[20, 21], "labels"] == 20).all()
    # ids 10..19 have no edges: each is its own component
    assert (df.loc[list(range(10, 20)), "labels"].to_numpy()
            == np.arange(10, 20)).all()
    assert components.LAST_SWEEPS >= 2


def test_connected_components_options():
    Gj, Gt = _pair("sparse200")
    _assert_same(ct.connected_components(Gt, connection="strong"),
                 ctpu.connected_components(Gj, connection="strong"))
    with pytest.raises(ValueError, match="connection"):
        ct.connected_components(Gt, connection="bogus")
    before = dict(sr.SEMIRING_LAUNCHES)
    ct.weakly_connected_components(Gt)
    assert sr.SEMIRING_LAUNCHES == before  # CPU tensors count no launch


@pytest.mark.cuda
def test_wcc_on_the_card_matches_cpu_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, directed = GRAPHS["sparse3000"]()
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst)
    before = sr.SEMIRING_LAUNCHES["min_left_i32"]
    got = ct.weakly_connected_components(Gg)
    assert sr.SEMIRING_LAUNCHES["min_left_i32"] == \
        before + 2 * components.LAST_SWEEPS
    _assert_same(got, ct.weakly_connected_components(Gc))


# -- SCC ----------------------------------------------------------------------

def _email():
    a = np.loadtxt(os.path.join(DATA, "email-Eu-core.csv"))
    return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), True


def _rmat12():
    e = ctpu.rmat(12, 8 << 12, seed=12)
    return e["src"].to_numpy(), e["dst"].to_numpy(), True


SCC_GRAPHS = {
    "sparse500": GRAPHS["sparse500"],
    "dense300": lambda: _random_sparse(300, 900, 5),
    "sparse500_undirected": GRAPHS["sparse500_undirected"],
    "email-Eu-core": _email,
    "rmat12": _rmat12,
    # tests/test_components.py's cycle plus tail
    "cycle_plus_tail": lambda: (np.array([0, 1, 2, 2, 3]),
                                np.array([1, 2, 0, 3, 4]), True),
}


@pytest.mark.parametrize("kind", list(SCC_GRAPHS))
def test_scc_matches_jax_bit_for_bit(kind):
    src, dst, directed = SCC_GRAPHS[kind]()
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
    got = ct.strongly_connected_components(Gt)
    _assert_same(got, ctpu.strongly_connected_components(Gj))
    run = dict(components.LAST_RUN)
    assert run["rounds"] >= 1
    assert run["forward_sweeps"] >= run["rounds"]
    # each label is the largest internal id of its SCC
    internal = Gt.lookup_internal_vertex_id(got["vertex"].to_numpy())
    label = Gt.lookup_internal_vertex_id(got["labels"].to_numpy())
    top = pd.Series(internal).groupby(label).max()
    np.testing.assert_array_equal(top.index.to_numpy(), top.to_numpy())
    if kind == "cycle_plus_tail":
        parts = got.groupby("labels")["vertex"].apply(frozenset)
        assert set(parts) == {frozenset({0, 1, 2}), frozenset({3}),
                              frozenset({4})}


def _backward_masked_max(g, active, color, roots):
    """The JAX package's backward sweep (components.py:208-217) in NumPy:
    the max over out-edges of reached[v] & (colour[v] == colour[u])."""
    rows = g.csr.row_ids().numpy()
    cols = g.csr.indices.numpy().astype(np.int64)
    same = color[cols] == color[rows]
    reach = roots.copy()
    while True:
        hit = np.zeros(len(reach), np.int32)
        np.maximum.at(hit, rows, (reach[cols] & same).astype(np.int32))
        new = reach | ((hit > 0) & active)
        if np.array_equal(new, reach):
            return reach
        reach = new


@pytest.mark.parametrize("kind", ["dense300", "email-Eu-core", "rmat12"])
def test_scc_min_form_backward_sweep_equals_the_masked_max_form(kind):
    src, dst, directed = SCC_GRAPHS[kind]()
    g = ct.Graph(directed=directed, device="cpu").from_edgelist(
        src, dst).structure
    n = g.num_vertices
    active = torch.ones(n, dtype=torch.bool)
    stats = {"forward_sweeps": 0, "backward_sweeps": 0}
    rounds = 0
    while bool(active.any()):
        reach, color = components._scc_round(g, active, stats)
        a, c = active.numpy(), color.numpy()
        roots = (c == np.arange(n)) & a
        want = _backward_masked_max(g, a, c, roots)
        np.testing.assert_array_equal(reach.numpy(), want)
        active &= ~reach
        rounds += 1
    assert rounds >= 2


# -- MIS and coloring ---------------------------------------------------------

def _jax_mis_draw(key, pad_v, n):
    """The priorities of the JAX package's Luby rounds (components.py:
    272-276): split the key, then a permutation of [0, pad_v), cut to the
    n real vertices (the padding is never eligible)."""
    import jax

    state = {"key": key}

    def draw():
        state["key"], sub = jax.random.split(state["key"])
        perm = np.asarray(jax.random.permutation(sub, pad_v))[:n]
        return torch.from_numpy(perm.astype(np.int32))
    return draw


def _loops_graph(seed, directed, n=150, m=500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = np.where(rng.random(m) < 0.1, src, rng.integers(0, n, m))
    return src, dst, directed


def _karate():
    e = np.array(list(nx.karate_club_graph().edges()))
    return e[:, 0], e[:, 1], False


MIS_GRAPHS = {
    "karate": _karate,
    "loops_undirected": lambda: _loops_graph(1, False),
    "loops_directed": lambda: _loops_graph(2, True),
    "netscience": _netscience,
}


def _mis_pair(kind):
    src, dst, directed = MIS_GRAPHS[kind]()
    return (ctpu.Graph(directed=directed).from_edgelist(src, dst),
            ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", list(MIS_GRAPHS))
def test_mis_fed_jax_permutations_matches_jax_bit_for_bit(kind, seed):
    import jax

    Gj, Gt = _mis_pair(kind)
    n = Gt.number_of_vertices()
    g = Gt.structure
    stats = {"luby_rounds": 0}
    mis = components._mis_rounds(
        g.loop_free, Gt.is_directed(), torch.ones(n, dtype=torch.bool),
        _jax_mis_draw(jax.random.PRNGKey(seed), Gj.structure.pad_v, n),
        stats)
    want = ctpu.maximal_independent_set(Gj, seed=seed)
    np.testing.assert_array_equal(
        Gt.number_map.to_external(np.flatnonzero(mis.numpy())),
        want["vertex"].to_numpy())
    assert stats["luby_rounds"] >= 1


@pytest.mark.parametrize("max_colors", [None, 2])
@pytest.mark.parametrize("kind", ["karate", "loops_undirected",
                                  "loops_directed"])
def test_coloring_fed_jax_permutations_matches_jax_bit_for_bit(kind,
                                                               max_colors):
    import jax

    Gj, Gt = _mis_pair(kind)
    n = Gt.number_of_vertices()
    pad_v = Gj.structure.pad_v
    state = {"key": jax.random.PRNGKey(1)}

    def draws():  # components.py:311-313: one split per colour
        state["key"], sub = jax.random.split(state["key"])
        return _jax_mis_draw(sub, pad_v, n)

    limit = n if max_colors is None else max_colors
    colors = components._coloring(Gt.structure.loop_free, Gt.is_directed(),
                                  limit, draws, {"luby_rounds": 0})
    want = ctpu.vertex_coloring(Gj, seed=1, max_colors=max_colors)
    np.testing.assert_array_equal(colors.numpy(), want["color"].to_numpy())


def _undirected_pairs(G):
    s, d, _ = G.edgelist_arrays()
    ext = G.number_map.to_external
    keep = s != d
    return ext(s[keep]), ext(d[keep])


@pytest.mark.parametrize("kind", list(MIS_GRAPHS))
def test_mis_and_coloring_with_the_port_generator_are_proper(kind):
    _, Gt = _mis_pair(kind)
    s, d = _undirected_pairs(Gt)
    vertices = Gt.number_map.to_external(np.arange(Gt.number_of_vertices()))
    for seed in (0, 7):
        mis = set(ct.maximal_independent_set(Gt, seed=seed)["vertex"])
        assert not any(u in mis and v in mis for u, v in zip(s, d))
        covered = mis | {v for u, v in zip(s, d) if u in mis} \
            | {u for u, v in zip(s, d) if v in mis}
        assert covered == set(vertices)  # maximal: every vertex dominated
        again = set(ct.maximal_independent_set(Gt, seed=seed)["vertex"])
        assert again == mis  # one seed, one set
        df = ct.vertex_coloring(Gt, seed=seed)
        color = dict(zip(df["vertex"], df["color"]))
        assert min(color.values()) >= 0
        assert all(color[u] != color[v] for u, v in zip(s, d))
        assert components.LAST_RUN["colors"] == max(color.values()) + 1
    capped = ct.vertex_coloring(Gt, seed=0, max_colors=1)["color"]
    assert set(capped) <= {0, -1} and (capped == -1).any()


def test_mis_with_only_self_loops_terminates():
    """A vertex whose only edge is a loop to itself must win its round
    (components.py:250-252)."""
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.array([0, 1, 2]), np.array([0, 1, 3]))
    assert sorted(ct.maximal_independent_set(G)["vertex"]) in \
        ([0, 1, 2], [0, 1, 3])
    assert ct.vertex_coloring(G)["color"].max() == 1


# -- the hybrid WCC -----------------------------------------------------------

def _hybrid_cases():
    """tests/test_components.py:78-100: a giant component plus a fringe,
    and many small ones, with isolated vertices."""
    rng = np.random.default_rng(10)
    s = rng.integers(0, 300, 1500)
    d = rng.integers(0, 300, 1500)
    yield (np.concatenate([s, [500]]), np.concatenate([d, [501]]), 520)
    ss, dd = [], []
    for c in range(30):
        base = c * 5
        for i in range(4):
            for j in range(i + 1, 4):
                ss.append(base + i)
                dd.append(base + j)
    yield np.array(ss), np.array(dd), 160


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("case", [0, 1])
def test_hybrid_wcc_matches_the_default_labels(case, directed, monkeypatch):
    src, dst, n = list(_hybrid_cases())[case]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    Gj = ctpu.Graph(directed=directed).from_edgelist(
        src, dst, None, renumber=False, vertices=np.arange(n))
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(
        src, dst, None, renumber=False, vertices=np.arange(n))
    want = ctpu.weakly_connected_components(Gj)
    np.testing.assert_array_equal(components._wcc_hybrid(Gt),
                                  components._wcc_labels(
                                      Gt.structure, directed).numpy())
    monkeypatch.setenv("CUGRAPH_TPU_WCC_HYBRID", "1")
    got = ct.weakly_connected_components(Gt)
    assert components.LAST_RUN["algo"] == "wcc_hybrid"
    assert components.LAST_RUN["mask_sweeps"] >= 2
    _assert_same(got, want)


@pytest.mark.parametrize("kind", ["sparse500", "sparse500_undirected",
                                  "netscience"])
def test_hybrid_wcc_matches_jax_on_renumbered_graphs(kind, monkeypatch):
    Gj, Gt = _pair(kind)
    want = ctpu.weakly_connected_components(Gj)
    monkeypatch.setenv("CUGRAPH_TPU_WCC_HYBRID", "1")
    _assert_same(ct.weakly_connected_components(Gt), want)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_scc_mis_coloring_hybrid_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, directed = SCC_GRAPHS["rmat12"]()
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst)
    before = dict(sr.SEMIRING_LAUNCHES)
    got = ct.strongly_connected_components(Gg)
    run = dict(components.LAST_RUN)
    assert sr.SEMIRING_LAUNCHES["max_left_i32"] - before["max_left_i32"] \
        == run["forward_sweeps"]
    assert sr.SEMIRING_LAUNCHES["min_left_i32"] - before["min_left_i32"] \
        == run["backward_sweeps"]
    _assert_same(got, ct.strongly_connected_components(Gc))
    before = sr.SEMIRING_LAUNCHES["max_left"]
    monkeypatch.setenv("CUGRAPH_TPU_WCC_HYBRID", "1")
    got = ct.weakly_connected_components(Gg)
    assert sr.SEMIRING_LAUNCHES["max_left"] - before == \
        2 * components.LAST_RUN["mask_sweeps"]
    monkeypatch.delenv("CUGRAPH_TPU_WCC_HYBRID")
    _assert_same(got, ct.weakly_connected_components(Gc))
    Gu = ct.Graph().from_edgelist(src, dst)
    s, d = _undirected_pairs(Gu)
    before = sr.SEMIRING_LAUNCHES["max_left_i32"]
    df = ct.vertex_coloring(Gu, seed=0)
    assert sr.SEMIRING_LAUNCHES["max_left_i32"] - before == \
        2 * components.LAST_RUN["luby_rounds"]
    color = df.set_index("vertex")["color"]
    assert (color >= 0).all()
    assert not (color.loc[s].to_numpy() == color.loc[d].to_numpy()).any()
