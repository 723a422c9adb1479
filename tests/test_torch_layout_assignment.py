"""The port's ForceAtlas2, auction assignment, spectral clusterings and
biclique search against cugraph_tpu on the CPU.

ForceAtlas2 sums its forces in another order than XLA (segmented sums
over the CSR, a segmented binning in place of the one-hot matmuls), so
positions after 1 and 10 exact iterations, and the particle-mesh
repulsion on one input, are held within rtol 1e-4 of the largest
magnitude.  The auction runs the same float32 rounds, ties to the first
index, so assignments and totals are equal bit for bit on tied integer
costs.  The spectral clusterings are the same scipy and NumPy code: fed
the same ARPACK starting vector (its default one is drawn afresh at each
call), the labels are equal.  ``find_bicliques`` gives the same frames.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse.linalg as spl
import torch
from scipy.optimize import linear_sum_assignment

import cugraph_tpu as ctpu
from cugraph_tpu.algos import layout as jlayout
from cugraph_tpu.experimental import find_bicliques as j_find_bicliques

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import layout as tlayout
from cugraph_tpu_torch.algos import linear_assignment as tla

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")
FA2_RTOL = 1e-4


def _edges(kind):
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None
    a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
    return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), a[:, 2]


def _pair(kind, directed=False):
    s, d, w = _edges(kind)
    return (ctpu.Graph(directed=directed).from_edgelist(s, d, w),
            ct.Graph(directed=directed, device="cpu").from_edgelist(s, d, w))


def _close(got, want):
    """||got - want|| within FA2_RTOL of ||want|| (2-norms over all
    entries)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= FA2_RTOL, f"relative error {err:.3e} > {FA2_RTOL}"


# -- ForceAtlas2 --------------------------------------------------------------

FA2_CASES = {
    "default": {},
    "lin_log": dict(lin_log_mode=True),
    "strong_gravity": dict(strong_gravity_mode=True, gravity=0.5),
    "no_outbound": dict(outbound_attraction_distribution=False,
                        edge_weight_influence=0.5, jitter_tolerance=0.7),
    "scaling": dict(scaling_ratio=3.0),
}
FA2_GRAPHS = [("karate", False), ("dolphins", True), ("netscience", False)]
# Ten steps are held where the layout is not chaotic.  Elsewhere the JAX
# package itself moves by more than 1e-4 within ten steps when one
# coordinate moves by one ulp (measured on the CPU at random_state 3:
# karate no_outbound 4.4e-6 -> port 1.5e-3, karate scaling 1.8e-3,
# dolphins default 5.1e-5, netscience default 0.95, strong_gravity 0.23),
# since 1/d² of the closest pairs amplifies every rounding difference.
FA2_RUNS = [(kind, directed, case, 1) for kind, directed in FA2_GRAPHS
            for case in sorted(FA2_CASES)] + [
    ("karate", False, "default", 10), ("karate", False, "lin_log", 10),
    ("karate", False, "strong_gravity", 10),
    ("dolphins", True, "lin_log", 10), ("dolphins", True, "scaling", 10)]


@pytest.mark.parametrize("kind,directed,case,iters", FA2_RUNS)
def test_force_atlas2_exact_matches_jax(kind, directed, case, iters):
    Gj, Gt = _pair(kind, directed)
    kw = dict(max_iter=iters, random_state=3, **FA2_CASES[case])
    got = ct.force_atlas2(Gt, **kw)
    want = ctpu.force_atlas2(Gj, **kw)
    pd.testing.assert_series_equal(got["vertex"], want["vertex"])
    _close(got[["x", "y"]].to_numpy(), want[["x", "y"]].to_numpy())


def test_force_atlas2_pos_list_and_callback_match_jax():
    Gj, Gt = _pair("karate")
    xy = np.random.default_rng(9).uniform(-50, 50, (34, 2)).astype(
        np.float32)
    start = pd.DataFrame({"vertex": np.arange(34), "x": xy[:, 0],
                          "y": xy[:, 1]})

    class Record:
        def __init__(self):
            self.seen = []

        def on_preprocess_end(self, pos):
            self.seen.append(("pre", np.array(pos)))

        def on_epoch_end(self, pos):
            self.seen.append(("epoch", np.array(pos)))

        def on_train_end(self, pos):
            self.seen.append(("end", np.array(pos)))

    a, b = Record(), Record()
    got = ct.force_atlas2(Gt, max_iter=3, pos_list=start, callback=a)
    want = ctpu.force_atlas2(Gj, max_iter=3, pos_list=start, callback=b)
    _close(got[["x", "y"]].to_numpy(), want[["x", "y"]].to_numpy())
    assert [k for k, _ in a.seen] == [k for k, _ in b.seen] == \
        ["pre"] + ["epoch"] * 3 + ["end"]
    for (_, x), (_, y) in zip(a.seen, b.seen):
        assert x.shape == (34, 2)
        _close(x, y)


def _clustered(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-100, 100, (8, 2))
    pos = (centers[rng.integers(0, 8, n)]
           + rng.normal(0, 5.0, (n, 2))).astype(np.float32)
    return pos, rng.integers(1, 20, n).astype(np.float32)


@pytest.mark.parametrize("n,grid", [(768, 64), (2048, 16), (300, 32)])
def test_pm_repulsion_matches_jax(n, grid):
    import jax.numpy as jnp

    pos, deg = _clustered(7, n)
    want = np.asarray(jlayout._pm_repulsion(
        jnp.asarray(pos), jnp.asarray(deg), jnp.ones(n, jnp.float32), grid,
        jnp.float32(2.0)))
    got = tlayout._pm_repulsion(torch.from_numpy(pos),
                                torch.from_numpy(deg), grid, 2.0)
    _close(got.numpy(), want)


@pytest.mark.parametrize("n", [34, 1000])
def test_exact_repulsion_matches_jax(n):
    """On FA2's own start, uniform in [-100, 100]^2."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    pos = rng.uniform(-100, 100, (n, 2)).astype(np.float32)
    deg = rng.integers(1, 20, n).astype(np.float32)
    got = tlayout._exact_repulsion(torch.from_numpy(pos),
                                   torch.from_numpy(deg), 2.0)
    _close(got.numpy(), np.asarray(jlayout._exact_repulsion(
        jnp.asarray(pos), jnp.asarray(deg), jnp.ones(n, jnp.float32),
        jnp.float32(2.0))))


def test_pm_repulsion_tracks_the_exact_force():
    """The bound of the JAX package's own test (test_misc_algos.py)."""
    pos, deg = _clustered(7, 768)
    p, m = torch.from_numpy(pos), torch.from_numpy(deg)
    exact = tlayout._exact_repulsion(p, m, 2.0).numpy()
    pm = tlayout._pm_repulsion(p, m, 64, 2.0).numpy()
    num = np.linalg.norm(pm - exact, axis=1)
    den = np.linalg.norm(exact, axis=1) + 1e-6
    assert np.median(num / den) < 0.02
    assert num.sum() / den.sum() < 0.03


def test_force_atlas2_barnes_hut_matches_jax():
    Gj, Gt = _pair("netscience")
    kw = dict(max_iter=2, barnes_hut_optimize=True, random_state=1)
    _close(ct.force_atlas2(Gt, **kw)[["x", "y"]].to_numpy(),
           ctpu.force_atlas2(Gj, **kw)[["x", "y"]].to_numpy())


def test_pm_grid_dim_matches_jax():
    for n in (10, 5000, 65536, 10**6):
        for theta in (0.1, 0.5, 1.2):
            assert tlayout._pm_grid_dim(n, theta) == \
                jlayout._pm_grid_dim(n, theta)
    assert (tlayout._PM_AUTO_V, tlayout._PM_CHUNK, tlayout._PM_HALO) == \
        (jlayout._PM_AUTO_V, jlayout._PM_CHUNK, jlayout._PM_HALO)


# -- the auction ----------------------------------------------------------------

def _eps_final(costs):
    """The last ε of the schedule: C/2 divided by 4 until ε <= 1e-6·C."""
    C = float(np.abs(costs).max()) + 1.0 + 1.0  # padding is max + 1
    eps = C / 2
    while not (eps <= 1e-6 * C or eps <= 1e-9):
        eps /= 4.0
    return eps


@pytest.mark.parametrize("shape,high,seed", [((24, 24), 4, 0),
                                             ((40, 40), 1000, 1),
                                             ((20, 31), 3, 2),
                                             ((33, 17), 50, 3)])
def test_dense_hungarian_matches_jax_bitwise(shape, high, seed):
    costs = np.random.default_rng(seed).integers(0, high, shape)
    total, cols = ct.dense_hungarian(costs, device="cpu")
    want_total, want_cols = ctpu.dense_hungarian(costs)
    np.testing.assert_array_equal(cols, want_cols)
    assert total == want_total
    if shape[0] <= shape[1]:  # every row gets a real column
        r, c = linear_sum_assignment(costs)
        assert total - costs[r, c].sum() <= max(shape) * _eps_final(costs)
    flat, fcols = ct.dense_hungarian(costs.ravel(), *shape, device="cpu")
    assert flat == total and np.array_equal(fcols, cols)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_round_matches_jax_bitwise(seed):
    """One round on tied integer benefits, from a partial assignment: the
    first maximum wins the bidder's pick, the smallest bidder the object."""
    import jax.numpy as jnp
    from cugraph_tpu.algos import linear_assignment as jla

    rng = np.random.default_rng(seed)
    N = 48
    benefit = -rng.integers(0, 4, (N, N)).astype(np.float32)
    price = rng.integers(0, 3, N).astype(np.float32) / 2
    owner = np.where(rng.random(N) < 0.4, rng.permutation(N), -1)
    got = tla._auction_round(torch.from_numpy(benefit),
                             torch.from_numpy(price),
                             torch.from_numpy(owner),
                             torch.tensor(0.25, dtype=torch.float32))
    want = jla._auction_round(jnp.asarray(benefit), jnp.asarray(price),
                              jnp.asarray(owner, jnp.int32),
                              jnp.float32(0.25))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not np.array_equal(got[1].numpy(), owner)


def test_hungarian_matches_jax():
    rng = np.random.default_rng(4)
    workers = np.arange(12)
    s = np.repeat(workers, 6)
    d = 100 + rng.integers(0, 14, len(s))
    w = rng.integers(1, 9, len(s)).astype(np.float32)
    Gj = ctpu.Graph().from_edgelist(s, d, w)
    Gt = ct.Graph(device="cpu").from_edgelist(s, d, w)
    cost, df = ct.hungarian(Gt, workers)
    want_cost, want_df = ctpu.hungarian(Gj, workers)
    assert cost == want_cost
    pd.testing.assert_frame_equal(df, want_df)
    with pytest.raises(ValueError, match="weights"):
        ct.hungarian(_pair("karate")[1], [0, 1])


# -- spectral clustering --------------------------------------------------------

@pytest.fixture
def fixed_arpack_start(monkeypatch):
    """One ARPACK starting vector for every eigsh call."""
    real = spl.eigsh

    def eigsh(A, *args, **kw):
        kw.setdefault("v0", np.random.default_rng(0).random(A.shape[0]))
        return real(A, *args, **kw)

    monkeypatch.setattr(spl, "eigsh", eigsh)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", ["karate", "dolphins", "netscience"])
@pytest.mark.parametrize("fn", ["spectralBalancedCutClustering",
                                "spectralModularityMaximizationClustering"])
def test_spectral_matches_jax(fn, kind, k, fixed_arpack_start):
    Gj, Gt = _pair(kind)
    got = getattr(ct, fn)(Gt, k)
    pd.testing.assert_frame_equal(got, getattr(ctpu, fn)(Gj, k))
    lab = got["cluster"].to_numpy()
    assert lab.dtype == np.int32 and lab.min() >= 0 and lab.max() < k
    assert len(lab) == Gt.number_of_vertices()


def test_spectral_no_convergence_raises_as_in_jax(fixed_arpack_start):
    """Two balanced-cut clusters of netscience: the smallest eigenpairs of
    its Laplacian (a zero eigenvalue per component) do not converge in
    either package."""
    Gj, Gt = _pair("netscience")
    for fn in (ctpu.spectralBalancedCutClustering,
               ct.spectralBalancedCutClustering):
        with pytest.raises(spl.ArpackNoConvergence):
            fn(Gj if fn is ctpu.spectralBalancedCutClustering else Gt, 2)


# -- bicliques ------------------------------------------------------------------

def _bipartite_frame(seed):
    """Noise on features 1010..1049 plus a planted biclique: machines
    0..14 all carry features 1000..1005, which no other machine carries."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 60, 400)
    dst = 1010 + rng.integers(0, 40, 400)
    ps, pd_ = np.meshgrid(np.arange(15), 1000 + np.arange(6))
    src = np.r_[src, ps.ravel()]
    dst = np.r_[dst, pd_.ravel()]
    flag = (src % 7 == 0).astype(np.int64)
    return pd.DataFrame({"src": src, "dst": dst, "flag": flag})


@pytest.mark.parametrize("kw", [dict(k=5), dict(k=-1, support=0.5),
                                dict(k=3, offset=1000, min_machines=4),
                                dict(k=2, max_iter=3, min_features=0)])
def test_find_bicliques_matches_jax(kw):
    df = _bipartite_frame(0)
    B, S = ct.experimental.find_bicliques(df, **kw)
    Bj, Sj = j_find_bicliques(df, **kw)
    pd.testing.assert_frame_equal(B, Bj)
    pd.testing.assert_frame_equal(S, Sj)


def test_find_bicliques_finds_the_planted_one():
    B, S = ct.experimental.find_bicliques(_bipartite_frame(1), k=1,
                                          min_machines=10)
    assert len(S) == 1
    machines = set(B[B["type"] == 0]["vert"])
    feats = set(B[B["type"] == 1]["vert"])
    assert set(range(15)) <= machines and set(range(1000, 1006)) <= feats
    with pytest.raises(NameError):
        ct.experimental.find_bicliques(_bipartite_frame(1)[["src", "dst"]],
                                       1)


def test_experimental_exports():
    import cugraph_tpu.experimental as jexp

    names = {n for n in dir(jexp) if not n.startswith("_")}
    assert names - {"bicliques"} <= set(dir(ct.experimental))
    Gj, Gt = _pair("karate", directed=True)
    np.testing.assert_array_equal(
        ct.experimental.strong_connected_component(Gt)["labels"].nunique(),
        ctpu.experimental.strong_connected_component(Gj)["labels"].nunique())


@pytest.mark.cuda
def test_layout_and_assignment_on_the_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # netscience is chaotic past one step (FA2_RUNS); karate is not
    for kind, kws in (("netscience", (dict(max_iter=1), dict(
            max_iter=1, barnes_hut_optimize=True))),
            ("karate", (dict(max_iter=10),))):
        s, d, w = _edges(kind)
        Gc = ct.Graph(device="cpu").from_edgelist(s, d, w)
        Gg = ct.Graph().from_edgelist(s, d, w)
        for kw in kws:
            _close(ct.force_atlas2(Gg, **kw)[["x", "y"]].to_numpy(),
                   ct.force_atlas2(Gc, **kw)[["x", "y"]].to_numpy())
    costs = np.random.default_rng(0).integers(0, 50, (64, 64))
    a = ct.dense_hungarian(costs)
    b = ct.dense_hungarian(costs, device="cpu")
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
