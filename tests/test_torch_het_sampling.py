"""Heterogeneous and temporal neighbour sampling of the PyTorch port, and
the homogeneous samplers' edge-property columns, against cugraph_tpu on
the CPU.

Fed the JAX package's own draws (``tests/torch_port_draws.py``: one key
split per hop and edge type with a nonzero fanout, as the JAX package's
masked sampling loop splits), the six samplers and
``heterogeneous_neighbor_sample`` give its frames bit for bit on the tile
route, with every flag and all five temporal comparisons.  The JAX
package is called with its neighbour tables off (``_fetch_tables`` ->
None), so both walk the CSR.  The per-edge route (beyond
``_TILE_FALLBACK_ENTRIES``, forced here with the threshold at 0) draws its
own keys: under "last" it needs none and gives the tile route's frames bit
for bit; under the random comparisons it is checked structurally (every
row an eligible edge with its properties, min(k, eligible) distinct edges
per source, batch and type) and by χ² tests of uniform and
weight-proportional picks.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.algos import sampling as jS

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import sampling as tS
from torch_port_draws import CpuDraws, JaxDraws

torch.set_num_threads(1)

COMPARISONS = ("strictly_increasing", "monotonically_increasing",
               "strictly_decreasing", "monotonically_decreasing", "last")


def _rmat_like(scale, m, seed):
    """R-MAT quadrant recursion (a, b, c = .57, .19, .19) in NumPy."""
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= 0.76).astype(np.int64) << bit
        dst |= (((r >= 0.57) & (r < 0.76)) | (r >= 0.95)).astype(np.int64) \
            << bit
    return src, dst


def _typed(kind):
    """(src, dst, weights, props, directed, cls): external ids, 3 edge
    types, integer-valued float32 times in [0, 64), ids 100 + position."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        src, dst, directed, cls = e[:, 0], e[:, 1], False, "Graph"
    elif kind == "rmat10":
        src, dst = _rmat_like(10, 6000, 3)
        directed, cls = True, "Graph"
    elif kind == "multi":
        src, dst = _rmat_like(8, 3000, 4)
        src[:500], dst[:500] = src[500:1000], dst[500:1000]   # parallel
        directed, cls = False, "MultiGraph"
    else:
        raise KeyError(kind)
    rng = np.random.default_rng(len(src))
    w = rng.uniform(0.1, 3.0, len(src)).astype(np.float32)
    w[::17] = 0.0          # never picked when biased (but under "last")
    props = dict(edge_id=np.arange(len(src), dtype=np.int64) + 100,
                 edge_type=rng.integers(0, 3, len(src)).astype(np.int32),
                 edge_time=rng.integers(0, 64, len(src)).astype(np.float32))
    return src, dst, w, props, directed, cls


def _pair(kind, weighted=True):
    src, dst, w, props, directed, cls = _typed(kind)
    w = w if weighted else None
    gj = getattr(ctpu, cls)(directed=directed).from_edgelist(src, dst, w,
                                                              **props)
    gt = getattr(ct, cls)(directed=directed, device="cpu").from_edgelist(
        src, dst, w, **props)
    return gj, gt


@pytest.fixture
def jax_draws(monkeypatch):
    """The JAX package walks its CSR, and the port draws jax.random's
    numbers in the JAX package's order."""
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)
    monkeypatch.setattr(tS, "Draws", lambda random_state, device: JaxDraws(
        random_state))


def _seeds(G, count, seed):
    deg = G.structure.out_degrees().numpy()
    return np.random.default_rng(seed).choice(G.nodes()[deg > 0], count,
                                              replace=False)


# -- whole frames on the JAX package's draws ----------------------------------

HET = [2, 1, 3, 1, 2, 2]
FRAME_CASES = {
    "het_uniform": ("heterogeneous_uniform_neighbor_sample", "rmat10",
                    HET, {}),
    "het_uniform_karate": ("heterogeneous_uniform_neighbor_sample", "karate",
                           HET, {}),
    "het_all_and_zero": ("heterogeneous_uniform_neighbor_sample", "rmat10",
                         [2, -1, 0, 0, 1, -1], {}),
    "het_zero_hop": ("heterogeneous_uniform_neighbor_sample", "rmat10",
                     [2, 1, 1, 0, 0, 0, 2, 2, 2], {}),
    "het_four_types": ("heterogeneous_uniform_neighbor_sample", "rmat10",
                       [1, 2, 1, 3, 2, 1, 1, 1], dict(num_edge_types=4)),
    "het_biased": ("heterogeneous_biased_neighbor_sample", "rmat10",
                   HET, {}),
    "het_biased_multi": ("heterogeneous_biased_neighbor_sample", "multi",
                         HET, {}),
    "het_carry_over": ("heterogeneous_uniform_neighbor_sample", "rmat10",
                       HET + [1, 1, 1],
                       dict(prior_sources_behavior="carry_over")),
    "het_exclude_dedupe": ("heterogeneous_biased_neighbor_sample", "multi",
                           HET + [1, 1, 1],
                           dict(prior_sources_behavior="exclude",
                                deduplicate_sources=True)),
    "het_no_hops_batches": ("heterogeneous_uniform_neighbor_sample",
                            "karate", HET, dict(return_hops=False,
                                                batch_id_list="two")),
    "temporal_strict": ("homogeneous_uniform_temporal_neighbor_sample",
                        "rmat10", [3, 2], dict(seed_time=20.0)),
    "temporal_not_strict": ("homogeneous_uniform_temporal_neighbor_sample",
                            "karate", [3, 2, 2], dict(seed_time=20.0,
                                                      strict=False)),
    "temporal_all": ("homogeneous_uniform_temporal_neighbor_sample",
                     "rmat10", [-1, 2], dict(seed_time=10.0)),
    "temporal_per_seed_times": (
        "homogeneous_uniform_temporal_neighbor_sample", "rmat10", [3, 3],
        dict(seed_time="per_seed")),
    "temporal_dedupe": ("homogeneous_uniform_temporal_neighbor_sample",
                        "multi", [3, 3, 3], dict(seed_time=5.0,
                                                 dedupe_sources=True)),
    "temporal_exclude": ("homogeneous_biased_temporal_neighbor_sample",
                         "rmat10", [3, 3, 3],
                         dict(seed_time=5.0,
                              prior_sources_behavior="exclude")),
    "temporal_biased": ("homogeneous_biased_temporal_neighbor_sample",
                        "rmat10", [4, -1], dict(seed_time=15.0)),
    "het_temporal": ("heterogeneous_uniform_temporal_neighbor_sample",
                     "rmat10", HET, dict(seed_time=12.0)),
    "het_temporal_biased": ("heterogeneous_biased_temporal_neighbor_sample",
                            "multi", HET, dict(seed_time=12.0)),
    "het_temporal_carry": ("heterogeneous_biased_temporal_neighbor_sample",
                           "rmat10", HET,
                           dict(seed_time=40.0,
                                prior_sources_behavior="carry_over",
                                temporal_sampling_comparison="last")),
}
for _cmp in COMPARISONS:
    FRAME_CASES[f"temporal_{_cmp}"] = (
        "homogeneous_uniform_temporal_neighbor_sample", "rmat10", [3, 2],
        dict(seed_time=32.0, temporal_sampling_comparison=_cmp))
    FRAME_CASES[f"het_temporal_biased_{_cmp}"] = (
        "heterogeneous_biased_temporal_neighbor_sample", "karate",
        [2, -1, 1, 1, 2, 0], dict(seed_time=32.0,
                                  temporal_sampling_comparison=_cmp))


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_masked_frames_match_jax(case, jax_draws):
    name, kind, fanouts, kw = FRAME_CASES[case]
    kw = dict(kw)
    gj, gt = _pair(kind)
    seeds = _seeds(gt, 12, 2)
    if kw.get("batch_id_list") == "two":
        kw["batch_id_list"] = np.arange(len(seeds)) % 2
    if kw.get("seed_time") == "per_seed":
        kw["seed_time"] = np.random.default_rng(5).integers(
            0, 40, len(seeds)).astype(np.float32)
    want = getattr(jS, name)(gj, seeds, fanouts, random_state=7, **kw)
    got = getattr(ct, name)(gt, seeds, fanouts, random_state=7, **kw)
    assert len(want) > 5
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(num_edge_types=3),
                                dict(num_edge_types=3, with_biases=True),
                                dict(num_edge_types=3,
                                     with_replacement=False)])
def test_heterogeneous_neighbor_sample_matches_jax(kw, jax_draws):
    gj, gt = _pair("rmat10")
    seeds = _seeds(gt, 10, 3)
    fanouts = [3, 2] if "num_edge_types" not in kw else HET
    want = ctpu.heterogeneous_neighbor_sample(gj, seeds, None, fanouts,
                                              random_state=1, **kw)
    got = ct.heterogeneous_neighbor_sample(gt, seeds, None, fanouts,
                                           random_state=1, **kw)
    pd.testing.assert_frame_equal(got, want)
    if "num_edge_types" not in kw:   # the default samples type 0 alone
        assert set(got["edge_type"]) == {0}


@pytest.mark.parametrize("fanouts,kw", [
    (HET, {}), ([2, 0, 1, 0, 0, 0, 3, 3, 3], {}),
    ([1, 2, 1, 3, 2, 1, 1, 1], dict(num_edge_types=4)),
    (HET, dict(seed_time=60.0, temporal_sampling_comparison="last"))])
def test_masked_draws_split_once_per_hop_and_type(fanouts, kw):
    """The tile route takes one split per hop and present edge type with a
    nonzero fanout, "last" included, as the JAX package's loop; a hop
    with no such type ends the sampling."""
    _, gt = _pair("rmat10")
    ntypes = kw.get("num_edge_types", 3)
    types, per_hop = tS._het_fanouts(gt, fanouts, kw.get("num_edge_types"))
    draws = JaxDraws(0)
    tS._masked_neighbor_sample(
        gt, _seeds(gt, 6, 1), per_hop, types=types, draws=draws,
        seed_time=kw.get("seed_time"),
        temporal_sampling_comparison=kw.get("temporal_sampling_comparison"))
    want = 0
    for i in range(0, len(fanouts), ntypes):
        live = sum(1 for t, k in enumerate(fanouts[i:i + ntypes])
                   if k != 0 and t < 3)
        if not live:
            break
        want += live
    assert draws.splits == want


def test_masked_tile_matches_jax_arrays():
    """``_sample_neighbors_masked`` on a fed key: the same [F, k] arrays
    as the JAX package's, uniform and biased, typed and temporal."""
    import jax
    import jax.numpy as jnp

    from torch_port_draws import JaxKeyDraws

    gj, gt = _pair("rmat10")
    fr = np.sort(np.random.default_rng(4).choice(
        gt.number_of_vertices(), 80, replace=False)).astype(np.int32)
    D = tS._max_out_degree(gt.structure)
    types = tS._csr_prop(gt, "edge_type")
    times = tS._csr_prop(gt, "edge_time")
    m = gt.structure.csr.num_edges
    et_j = jS._csr_prop(gj, gj.edge_types)
    tm_j = jnp.asarray(jS._csr_prop(gj, gj.edge_times).astype(np.float32))
    lim = np.random.default_rng(5).integers(0, 64, 80).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for biased in (False, True):
        for cmp_ in ("strictly_increasing", "last"):
            for t in (1, 2):
                ok_j = jnp.asarray((et_j == t)
                                   & (np.arange(len(et_j)) < m))
                dj, ej, vj = jS._sample_neighbors_masked(
                    gj.structure, jnp.asarray(fr), key, 4, D, ok_j,
                    jnp.asarray(lim), tm_j, cmp_, biased)
                dt, e_t, vt = tS._sample_neighbors_masked(
                    gt.structure, torch.from_numpy(fr.astype(np.int64)),
                    JaxKeyDraws(key), 4, D, t, types, torch.from_numpy(lim),
                    times, cmp_, biased)
                valid = np.asarray(vj)
                np.testing.assert_array_equal(vt.numpy(), valid)
                np.testing.assert_array_equal(dt.numpy()[valid],
                                              np.asarray(dj)[valid])
                np.testing.assert_array_equal(e_t.numpy()[valid],
                                              np.asarray(ej)[valid])
                assert valid.sum() > 20


# -- the per-edge route -------------------------------------------------------

def _sample(name, G, seeds, fanouts, threshold, monkeypatch, **kw):
    monkeypatch.setattr(tS, "_TILE_FALLBACK_ENTRIES", threshold)
    return getattr(ct, name)(G, seeds, fanouts, random_state=3, **kw)


@pytest.mark.parametrize("name,kind,fanouts", [
    ("homogeneous_uniform_temporal_neighbor_sample", "rmat10", [3, 2, -1]),
    ("homogeneous_biased_temporal_neighbor_sample", "multi", [4, 4]),
    ("heterogeneous_uniform_temporal_neighbor_sample", "rmat10", HET),
    ("heterogeneous_biased_temporal_neighbor_sample", "karate",
     [2, -1, 0, 1, 1, 3])])
def test_per_edge_route_last_equals_the_tile(name, kind, fanouts,
                                             monkeypatch):
    """Under "last" the per-edge route sorts by time with ties to the lower
    CSR position, the tile's top-k order: the frames are equal."""
    _, gt = _pair(kind)
    seeds = _seeds(gt, 20, 6)
    kw = dict(seed_time=50.0, temporal_sampling_comparison="last")
    tile = _sample(name, gt, seeds, fanouts, tS._TILE_FALLBACK_ENTRIES,
                   monkeypatch, **kw)
    edge = _sample(name, gt, seeds, fanouts, 0, monkeypatch, **kw)
    assert len(tile) > 20
    pd.testing.assert_frame_equal(edge, tile)


def _stored_edges(G):
    """The stored edges as a frame with their properties, external ids."""
    s, d, w = G.edgelist_arrays()
    nm = G.number_map
    return pd.DataFrame({
        "src": nm.to_external(s), "dst": nm.to_external(d),
        "weight": w if w is not None else np.ones(len(s), np.float32),
        "edge_id": G.edge_ids, "edge_type": G.edge_types,
        "edge_time": G.edge_times.astype(np.float32)})


def _rows_are_their_edges(G, df):
    """Each sampled row is a stored edge (its id and endpoints; an
    undirected edge's two directions share an id) with that edge's
    weight, type and time."""
    key = ["edge_id", "src", "dst"]
    edges = _stored_edges(G).set_index(key)
    rows = edges.loc[list(zip(df["edge_id"], df["sources"],
                              df["destinations"]))]
    for col in ("weight", "edge_type", "edge_time"):
        np.testing.assert_array_equal(rows[col].to_numpy(),
                                      df[col].to_numpy())


def _passes(t_edge, t_src, comparison):
    return {"strictly_increasing": t_edge > t_src,
            "monotonically_increasing": t_edge >= t_src,
            "strictly_decreasing": t_edge < t_src,
            "monotonically_decreasing": t_edge <= t_src,
            "last": t_edge < t_src}[comparison]


def _check_structure(G, df, seeds, fanouts, ntypes, seed_time, comparison,
                     biased):
    """``df`` (dedupe_sources=True, one batch per seed): every row is a
    stored edge with its weight, id, type and time, eligible for its
    source's arrival time (the earliest edge that reached it in its batch),
    and each (source, batch, type) of each hop has min(k, eligible)
    distinct edges (all eligible for k < 0)."""
    _rows_are_their_edges(G, df)
    edges = _stored_edges(G)
    hops = [fanouts[i:i + ntypes] for i in range(0, len(fanouts), ntypes)]
    frontier = pd.DataFrame({"v": seeds, "batch_id": np.arange(
        len(seeds), dtype=np.int32), "t": np.float32(seed_time)})
    out_edges = {v: grp for v, grp in edges.groupby("src")}
    for hop, fans in enumerate(hops):
        got = df[df["hop_id"] == hop]
        for v, b, t_arr in frontier.itertuples(index=False):
            mine = got[(got["sources"] == v) & (got["batch_id"] == b)]
            cand = out_edges.get(v, edges.iloc[:0])
            ok = _passes(cand["edge_time"].to_numpy(), np.float32(t_arr),
                         comparison)
            if biased and comparison != "last":
                ok &= cand["weight"].to_numpy() > 0
            for t, k in enumerate(fans):
                elig = cand[ok & (cand["edge_type"].to_numpy() == t)]
                picks = mine[mine["edge_type"] == t]
                want = 0 if k == 0 else len(elig) if k < 0 else min(
                    k, len(elig))
                assert len(picks) == want
                assert picks["edge_id"].is_unique
                assert set(picks["edge_id"]) <= set(elig["edge_id"])
        frontier = (got.groupby(["destinations", "batch_id"])["edge_time"]
                    .min().reset_index().rename(columns={
                        "destinations": "v", "edge_time": "t"}))


@pytest.mark.parametrize("comparison", COMPARISONS)
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("kind", ["rmat10", "multi"])
def test_per_edge_route_structure(comparison, biased, kind, monkeypatch):
    _, gt = _pair(kind)
    seeds = _seeds(gt, 16, 7)
    name = (f"heterogeneous_{'biased' if biased else 'uniform'}"
            "_temporal_neighbor_sample")
    fanouts = [2, -1, 3, 1, 0, 2]
    for threshold in (0, tS._TILE_FALLBACK_ENTRIES):
        df = _sample(name, gt, seeds, fanouts, threshold, monkeypatch,
                     seed_time=30.0, temporal_sampling_comparison=comparison,
                     dedupe_sources=True)
        assert len(df) > 10
        _check_structure(gt, df, seeds, fanouts, 3, 30.0, comparison, biased)


def _star(weights, types, times):
    src = np.zeros(len(weights), np.int64)
    dst = np.arange(1, len(weights) + 1)
    return ct.Graph(directed=True, device="cpu").from_edgelist(
        src, dst, np.asarray(weights, np.float32),
        edge_id=np.arange(len(weights)), edge_type=np.asarray(types),
        edge_time=np.asarray(times, np.float32))


@pytest.mark.parametrize("threshold", [0, None])
def test_uniform_within_type_chi_square(threshold, monkeypatch):
    """The hub of a star with 40 leaves, half of type 0; 3,000 batches each
    pick one type-0 edge among those after time 10: χ² (14 dof) below
    36.1, the 0.999 quantile."""
    G = _star(np.ones(40), np.arange(40) % 2,
              np.where(np.arange(40) < 10, 5.0, 20.0))
    if threshold is not None:
        monkeypatch.setattr(tS, "_TILE_FALLBACK_ENTRIES", threshold)
    df = ct.heterogeneous_uniform_temporal_neighbor_sample(
        G, np.zeros(3000, np.int64), [1, 0], seed_time=10.0,
        random_state=11)
    assert len(df) == 3000 and (df["edge_type"] == 0).all()
    counts = np.bincount(df["edge_id"], minlength=40)[10:][::2]
    assert np.bincount(df["edge_id"], minlength=40)[:10].sum() == 0
    exp = 3000 / 15
    assert ((counts - exp) ** 2 / exp).sum() < 36.1


@pytest.mark.parametrize("threshold", [0, None])
def test_biased_within_type_chi_square(threshold, monkeypatch):
    """Weights 1..20 on type-1 edges of a 40-leaf star, fanout 1, 4,000
    batches: picks ∝ weight, χ² (18 dof, one zero weight) below 42.3, the
    0.999 quantile."""
    w = np.arange(40) // 2 + 1.0
    w[1] = 0.0
    G = _star(w, np.arange(40) % 2, np.zeros(40))
    if threshold is not None:
        monkeypatch.setattr(tS, "_TILE_FALLBACK_ENTRIES", threshold)
    df = ct.heterogeneous_biased_neighbor_sample(
        G, np.zeros(4000, np.int64), [0, 1], random_state=12)
    assert len(df) == 4000 and (df["edge_type"] == 1).all()
    counts = np.bincount(df["edge_id"], minlength=40)[3::2]
    p = w[3::2] / w[3::2].sum()
    assert np.bincount(df["edge_id"], minlength=40)[1] == 0
    assert ((counts - 4000 * p) ** 2 / (4000 * p)).sum() < 42.3


# -- errors -------------------------------------------------------------------

def test_errors_match_jax():
    src, dst, w, props, _, _ = _typed("karate")
    plain = ct.Graph(device="cpu").from_edgelist(src, dst, w)
    typed_only = ct.Graph(device="cpu").from_edgelist(
        src, dst, w, edge_type=props["edge_type"])
    unweighted = ct.Graph(device="cpu").from_edgelist(src, dst, **props)
    with pytest.raises(ValueError, match="edge_type"):
        ct.heterogeneous_uniform_neighbor_sample(plain, [0], [1, 1])
    for fn in (ct.homogeneous_uniform_temporal_neighbor_sample,
               ct.heterogeneous_uniform_temporal_neighbor_sample):
        with pytest.raises(ValueError, match="edge_time"):
            fn(typed_only, [0], [1, 1, 1])
    for fn in (ct.heterogeneous_biased_neighbor_sample,
               ct.homogeneous_biased_temporal_neighbor_sample,
               ct.heterogeneous_biased_temporal_neighbor_sample):
        with pytest.raises(ValueError, match="edge weights"):
            fn(unweighted, [0], [1, 1, 1])
    _, gt = _pair("karate")
    for fn in (ct.homogeneous_uniform_temporal_neighbor_sample,
               ct.homogeneous_biased_temporal_neighbor_sample,
               ct.heterogeneous_uniform_temporal_neighbor_sample,
               ct.heterogeneous_biased_temporal_neighbor_sample):
        with pytest.raises(ValueError, match="disjoint"):
            fn(gt, [0], [1, 1, 1], disjoint_sampling=False)
    with pytest.raises(ValueError, match="multiple|num_edge_types"):
        ct.heterogeneous_uniform_neighbor_sample(gt, [0], [1, 1])
    with pytest.raises(ValueError, match="temporal_sampling_comparison"):
        ct.homogeneous_uniform_temporal_neighbor_sample(
            gt, [0], [1], temporal_sampling_comparison="sideways")
    empty = ct.heterogeneous_uniform_neighbor_sample(gt, [0], [0, 0, 0],
                                                     return_hops=False)
    assert list(empty.columns) == ["sources", "destinations", "weight",
                                   "batch_id"]


# -- homogeneous samplers' edge properties ---------------------------------

@pytest.mark.parametrize("biased,wr,threshold", [
    (False, True, None), (False, False, None), (True, True, None),
    (True, False, None), (False, False, 0), (True, False, 0)])
def test_with_edge_properties_on_a_multigraph(biased, wr, threshold,
                                              jax_draws, monkeypatch):
    """Parallel edges with distinct weights: each row carries the id, type
    and time of the very edge it sampled.  On the tile routes the frames
    are the JAX package's bit for bit; on the per-edge route (threshold
    0, the port's own keys) every row's weight and properties are its
    edge's."""
    gj, gt = _pair("multi")
    seeds = _seeds(gt, 12, 8)
    fn = "homogeneous_biased_neighbor_sample" if biased else \
        "uniform_neighbor_sample"
    kw = dict(with_replacement=wr, with_edge_properties=True, random_state=5)
    if threshold is None:
        want = getattr(jS, fn)(gj, seeds, [4, 3], **kw)
        got = getattr(ct, fn)(gt, seeds, [4, 3], **kw)
        pd.testing.assert_frame_equal(got, want)
    else:
        monkeypatch.setattr(tS, "Draws", lambda r, d: CpuDraws(r, d))
        monkeypatch.setattr(tS, "_TILE_FALLBACK_ENTRIES", threshold)
        got = getattr(ct, fn)(gt, seeds, [4, 3], **kw)
    assert list(got.columns)[-3:] == ["edge_id", "edge_type", "edge_time"]
    _rows_are_their_edges(gt, got)
    assert ct.count_multi_edges(gt) > 0


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_masked_frames_on_the_card_match_the_cpu():
    """The same draws give the same frames on the card as on the CPU, on
    the tile route and (threshold 0) the per-edge route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, props, directed, _ = _typed("rmat10")
    seeds = np.unique(src)[:40]
    for name, kw in (
            ("heterogeneous_biased_temporal_neighbor_sample",
             dict(seed_time=10.0)),
            ("heterogeneous_uniform_neighbor_sample", {}),
            ("homogeneous_uniform_temporal_neighbor_sample",
             dict(seed_time=60.0, temporal_sampling_comparison="last"))):
        for threshold in (None, 0):
            frames = []
            for dev in ("cpu", "cuda"):
                G = ct.Graph(directed=directed, device=dev).from_edgelist(
                    src, dst, w, **props)
                fanouts = ([4, 3] if name.startswith("homogeneous")
                           else HET)
                types = (None if name.startswith("homogeneous")
                         else tS._het_fanouts(G, fanouts, None))
                saved = tS._TILE_FALLBACK_ENTRIES
                if threshold is not None:
                    tS._TILE_FALLBACK_ENTRIES = threshold
                try:
                    frames.append(tS._masked_neighbor_sample(
                        G, seeds, types[1] if types else [[(0, k)]
                                                          for k in fanouts],
                        types=types[0] if types else None,
                        seed_time=kw.get("seed_time"),
                        biased="biased" in name,
                        temporal_sampling_comparison=kw.get(
                            "temporal_sampling_comparison"),
                        draws=CpuDraws(3, dev)))
                finally:
                    tS._TILE_FALLBACK_ENTRIES = saved
            pd.testing.assert_frame_equal(frames[1], frames[0])
