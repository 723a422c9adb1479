"""The port's plc walks, samplers, negatives, random vertices and R-MAT
generators against ``cugraph_tpu.plc`` on the CPU.

The port draws from torch generators; fed the JAX package's own draws
(``tests/torch_port_draws.py``: ``JaxDraws`` for the samplers and
negatives, ``walk_uniforms`` for the walks) and with the JAX package's
neighbour tables off (``_fetch_tables`` -> None, so both walk the CSR),
every frame and output dict is the JAX package's bit for bit: the plain
frames, the full matrix of output options (renumber with each
compression × ``compress_per_hop`` × ``retain_seeds``, and the
heterogeneous sort), and both positional orders of every shim.
node2vec runs on unit weights with p = 0.5, q = 2, where every score and
partial sum is exact in float32 and the two packages' summation orders
agree.  The R-MAT generators share the native counter-RNG engine and
NumPy's type stream: bit for bit with no draws fed.

Two faults of the JAX wrappers are held here: with a
``CuGraphRandomState`` its single-device walks, samplers and
``select_random_vertices`` raise ``TypeError``, where the port resolves
the state to an int and equals the JAX package called with that int; and
its temporal samplers drop ``starting_vertex_label_offsets`` in the
reference positional order, where the port equals the JAX package called
with the same labels as ``batch_id_list``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu.plc as jp
from cugraph_tpu.algos import sampling as jS

import cugraph_tpu_torch.plc as tp
from cugraph_tpu_torch.algos import sampling as tS
from torch_port_draws import JaxDraws, walk_uniforms

torch.set_num_threads(1)

N, M, TYPES = 48, 420, 3


class PlcDraws(JaxDraws):
    """The samplers' and negatives' JAX draws, and the walks' per-step
    uniforms (the walks take one [depth, W] block)."""

    def __init__(self, random_state):
        super().__init__(random_state)
        self.random_state = random_state

    def uniform(self, shape, low=0.0, high=1.0):
        depth, walkers = shape
        return walk_uniforms(self.random_state, depth, walkers)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)
    monkeypatch.setattr(tS, "Draws",
                        lambda random_state, device: PlcDraws(random_state))


def _edges():
    rng = np.random.default_rng(31)
    src, dst = rng.integers(0, N, M), rng.integers(0, N, M)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return dict(
        src=src * 3 + 7, dst=dst * 3 + 7,      # sparse external ids
        w=rng.uniform(0.1, 3.0, len(src)).astype(np.float32),
        eid=np.arange(len(src), dtype=np.int64) + 500,
        etype=rng.integers(0, TYPES, len(src)).astype(np.int32),
        etime=rng.integers(0, 32, len(src)).astype(np.float32))


E = _edges()
SEEDS = np.unique(E["src"])[:12]
OFFSETS = np.array([0, 3, 7, 12])


def _build(P, h):
    props = dict(edge_id_array=E["eid"], edge_type_array=E["etype"],
                 edge_start_time_array=E["etime"])
    return {
        "weighted": P.SGGraph(h, P.GraphProperties(), E["src"], E["dst"],
                              E["w"], **props),
        "unweighted": P.SGGraph(h, P.GraphProperties(), E["src"], E["dst"],
                                None),
    }


@pytest.fixture(scope="module")
def graphs():
    ht = tp.ResourceHandle(device="cpu")
    hj = jp.ResourceHandle()
    return {tp: (ht, _build(tp, ht)), jp: (hj, _build(jp, hj))}


def _same(got, want):
    """Frames, output dicts, walk tuples and arrays: equal, dtypes too."""
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                      want.reset_index(drop=True))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want)
    elif want is None or isinstance(want, (int, float)):
        assert got == want
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _both(graphs, call):
    ht, gt = graphs[tp]
    hj, gj = graphs[jp]
    return call(tp, ht, gt), call(jp, hj, gj)


# -- walks, samplers, negatives, random vertices on the JAX draws ------------

HET = [2, 1, 1, 1, 0, 2]     # two hops, three types
SAMPLERS = {
    "uniform_random_walks": lambda P, h, g: P.uniform_random_walks(
        h, g["weighted"], SEEDS, 6, 11),
    "biased_random_walks": lambda P, h, g: P.biased_random_walks(
        h, g["weighted"], SEEDS, 6, 12),
    "node2vec_random_walks": lambda P, h, g: P.node2vec_random_walks(
        h, g["unweighted"], SEEDS, 6, 0.5, 2.0, 13),
    "uniform_neighbor_sample": lambda P, h, g: P.uniform_neighbor_sample(
        h, g["weighted"], SEEDS, [3, 2], False, 14),
    "uniform_neighbor_sample_replacement": lambda P, h, g:
        P.uniform_neighbor_sample(h, g["weighted"], SEEDS, [3, 2], True, 15),
    "homogeneous_uniform_neighbor_sample": lambda P, h, g:
        P.homogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, OFFSETS, np.array([3, 2]),
            random_state=16, with_edge_properties=True),
    "homogeneous_biased_neighbor_sample": lambda P, h, g:
        P.homogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, None, np.array([2, 2, 1]),
            random_state=17, with_replacement=True,
            prior_sources_behavior="exclude", deduplicate_sources=True),
    "heterogeneous_uniform_neighbor_sample": lambda P, h, g:
        P.heterogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, OFFSETS, None, np.array(HET),
            num_edge_types=TYPES, random_state=18),
    "heterogeneous_biased_neighbor_sample": lambda P, h, g:
        P.heterogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, None, None, np.array(HET),
            num_edge_types=TYPES, random_state=19, return_hops=False),
    "homogeneous_uniform_temporal_neighbor_sample": lambda P, h, g:
        P.homogeneous_uniform_temporal_neighbor_sample(
            h, g["weighted"], "edge_time", SEEDS,
            np.linspace(0, 10, len(SEEDS)).astype(np.float32), None,
            np.array([3, 2]), random_state=20),
    "homogeneous_biased_temporal_neighbor_sample": lambda P, h, g:
        P.homogeneous_biased_temporal_neighbor_sample(
            h, g["weighted"], SEEDS, np.array([3, 2]), seed_time=4.0,
            random_state=21, temporal_sampling_comparison="last"),
    "heterogeneous_uniform_temporal_neighbor_sample": lambda P, h, g:
        P.heterogeneous_uniform_temporal_neighbor_sample(
            h, g["weighted"], SEEDS, np.array(HET), TYPES, seed_time=2.0,
            random_state=22, strict=False),
    "heterogeneous_biased_temporal_neighbor_sample": lambda P, h, g:
        P.heterogeneous_biased_temporal_neighbor_sample(
            h, g["weighted"], "edge_time", SEEDS, np.float32(1.0), None,
            np.array(HET), num_edge_types=TYPES, random_state=23,
            temporal_sampling_comparison="monotonically_increasing"),
    "negative_sampling": lambda P, h, g: P.negative_sampling(
        h, g["weighted"], 40, 24),
    "negative_sampling_biased": lambda P, h, g: P.negative_sampling(
        h, g["unweighted"], 30, 25, SEEDS, np.arange(1, 13.0),
        np.arange(12, 0.0, -1), exact_number_of_samples=True),
    "select_random_vertices": lambda P, h, g: P.select_random_vertices(
        h, g["weighted"], 26, 10),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_matches_jax(name, graphs, jax_draws):
    got, want = _both(graphs, SAMPLERS[name])
    _same(got, want)
    if isinstance(want, pd.DataFrame):
        assert len(want) > 0


# -- the output options --------------------------------------------------------

COMPRESSIONS = ["COO", "CSR", "CSC", "DCSR", "DCSC"]


@pytest.mark.parametrize("retain_seeds", [False, True])
@pytest.mark.parametrize("compress_per_hop", [False, True])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_output_options_match_jax(compression, compress_per_hop,
                                  retain_seeds, graphs, jax_draws):
    def call(P, h, g):
        return P.homogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, OFFSETS, np.array([3, 2]),
            random_state=27, renumber=True, compression=compression,
            compress_per_hop=compress_per_hop, retain_seeds=retain_seeds,
            with_edge_properties=True)

    if compress_per_hop and compression.startswith("D"):
        # the reference contract: no per-hop doubly compressed output
        for P, (h, g) in graphs.items():
            with pytest.raises(ValueError, match="compress_per_hop"):
                call(P, h, g)
        return
    got, want = _both(graphs, call)
    _same(got, want)
    assert len(want["minors"]) > 0
    res = tp.SamplingResult(got)
    np.testing.assert_array_equal(res.get_minors(), want["minors"])


VTO = np.array([0, 60, 3 * N + 7])     # two vertex types over the id range


@pytest.mark.parametrize("compression", ["COO", "CSC"])
@pytest.mark.parametrize("retain_seeds", [False, True])
def test_heterogeneous_sort_matches_jax(compression, retain_seeds, graphs,
                                        jax_draws):
    got, want = _both(graphs, lambda P, h, g:
                      P.heterogeneous_uniform_neighbor_sample(
                          h, g["weighted"], SEEDS, OFFSETS, VTO,
                          np.array(HET), num_edge_types=TYPES,
                          random_state=28, renumber=True,
                          compression=compression,
                          retain_seeds=retain_seeds))
    _same(got, want)
    assert "label_type_hop_offsets" in want


def test_heterogeneous_sort_refuses_compression(graphs):
    for P, (h, g) in graphs.items():
        with pytest.raises(ValueError, match="sorted COO only"):
            P.heterogeneous_biased_neighbor_sample(
                h, g["weighted"], SEEDS, None, VTO, np.array(HET),
                num_edge_types=TYPES, renumber=True, compression="CSR")
        with pytest.raises(ValueError, match="unknown compression"):
            P.homogeneous_uniform_neighbor_sample(
                h, g["weighted"], SEEDS, None, np.array([2]),
                renumber=True, compression="ELL")


# -- both positional orders of every shim ---------------------------------------

SHIMS = {
    # the legacy 4-positional call: the fanout in the offsets slot
    "homogeneous_uniform_legacy": lambda P, h, g:
        P.homogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, np.array([2, 2]), random_state=29),
    "homogeneous_biased_legacy": lambda P, h, g:
        P.homogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, np.array([2, 1]), random_state=30),
    "homogeneous_uniform_batch_ids_win": lambda P, h, g:
        P.homogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, OFFSETS, np.array([2]),
            batch_id_list=np.arange(len(SEEDS)) % 2, random_state=31),
    # legacy heterogeneous: (start, fanout, num_edge_types) positionally
    "heterogeneous_uniform_legacy": lambda P, h, g:
        P.heterogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, np.array(HET), TYPES, random_state=32),
    "heterogeneous_biased_legacy": lambda P, h, g:
        P.heterogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, np.array(HET), TYPES, random_state=33),
    # legacy temporal: (start, fanout[, num_edge_types], seed_time=)
    "homogeneous_uniform_temporal_legacy": lambda P, h, g:
        P.homogeneous_uniform_temporal_neighbor_sample(
            h, g["weighted"], SEEDS, np.array([2, 2]), seed_time=3.0,
            random_state=34),
    "heterogeneous_biased_temporal_legacy": lambda P, h, g:
        P.heterogeneous_biased_temporal_neighbor_sample(
            h, g["weighted"], SEEDS, np.array(HET), TYPES, seed_time=1.0,
            random_state=35),
    # reference temporal order with the fanout as a keyword
    "homogeneous_biased_temporal_reference_kw_fanout": lambda P, h, g:
        P.homogeneous_biased_temporal_neighbor_sample(
            h, g["weighted"], "edge_time", SEEDS, np.float32(5.0),
            h_fan_out=np.array([2, 3]), random_state=36),
    "heterogeneous_uniform_temporal_reference": lambda P, h, g:
        P.heterogeneous_uniform_temporal_neighbor_sample(
            h, g["weighted"], "edge_time", SEEDS, None, None, np.array(HET),
            num_edge_types=TYPES, random_state=37),
}


@pytest.mark.parametrize("name", list(SHIMS))
def test_positional_orders_match_jax(name, graphs, jax_draws):
    got, want = _both(graphs, SHIMS[name])
    _same(got, want)
    assert len(want) > 0


def test_label_offsets_must_be_a_csr(graphs):
    for P, (h, g) in graphs.items():
        with pytest.raises(ValueError, match="label_offsets"):
            P.homogeneous_uniform_neighbor_sample(
                h, g["weighted"], SEEDS, np.array([0, 5]), np.array([2]))


# -- the R-MAT generators, bit for bit -------------------------------------------

RMAT = {
    "plain": dict(scale=9, num_edges=3000),
    "weights_ids_types": dict(scale=8, num_edges=2000,
                              include_edge_weights=True,
                              minimum_weight=0.5, maximum_weight=2.0,
                              dtype=np.float64, include_edge_ids=True,
                              include_edge_types=True, min_edge_type_value=2,
                              max_edge_type_value=5),
    "clip_scramble": dict(scale=10, num_edges=4000, a=0.45, b=0.25, c=0.15,
                          clip_and_flip=True, scramble_vertex_ids=True),
}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("name", list(RMAT))
def test_generate_rmat_edgelist_bit_for_bit(name, seed):
    _same(tp.generate_rmat_edgelist(None, seed, **RMAT[name]),
          jp.generate_rmat_edgelist(None, seed, **RMAT[name]))


def test_generate_rmat_edgelists_bit_for_bit():
    got = tp.generate_rmat_edgelists(None, 5, 3, 6, 9, edge_factor=8)
    want = jp.generate_rmat_edgelists(None, 5, 3, 6, 9, edge_factor=8)
    _same(got, want)


def test_rmat_state_resolves_once():
    """A state gives the edges and the type column one seed: the port's
    call equals the JAX package's with that int (the JAX wrapper draws a
    second seed from a state for the types)."""
    kw = dict(scale=7, num_edges=500, include_edge_types=True,
              max_edge_type_value=9)
    got = tp.generate_rmat_edgelist(None, tp.CuGraphRandomState(None, 4),
                                    **kw)
    seed = tp.CuGraphRandomState(None, 4).next_seed()
    _same(got, jp.generate_rmat_edgelist(None, seed, **kw))


# -- the JAX wrappers' faults, and the port's contract ----------------------------

STATEFUL = {
    "uniform_random_walks": lambda P, h, g, rs: P.uniform_random_walks(
        h, g["weighted"], SEEDS, 5, rs),
    "biased_random_walks": lambda P, h, g, rs: P.biased_random_walks(
        h, g["weighted"], SEEDS, 5, rs),
    "node2vec_random_walks": lambda P, h, g, rs: P.node2vec_random_walks(
        h, g["unweighted"], SEEDS, 5, 0.5, 2.0, rs),
    "uniform_neighbor_sample": lambda P, h, g, rs: P.uniform_neighbor_sample(
        h, g["weighted"], SEEDS, [2, 2], True, rs),
    "homogeneous_uniform_neighbor_sample": lambda P, h, g, rs:
        P.homogeneous_uniform_neighbor_sample(
            h, g["weighted"], SEEDS, OFFSETS, np.array([3, 2]),
            random_state=rs),
    "homogeneous_biased_neighbor_sample": lambda P, h, g, rs:
        P.homogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, None, np.array([3]), random_state=rs),
    "heterogeneous_biased_neighbor_sample": lambda P, h, g, rs:
        P.heterogeneous_biased_neighbor_sample(
            h, g["weighted"], SEEDS, None, None, np.array(HET),
            num_edge_types=TYPES, random_state=rs),
    "homogeneous_uniform_temporal_neighbor_sample": lambda P, h, g, rs:
        P.homogeneous_uniform_temporal_neighbor_sample(
            h, g["weighted"], SEEDS, np.array([2, 2]), random_state=rs),
    "select_random_vertices": lambda P, h, g, rs: P.select_random_vertices(
        h, g["weighted"], rs, 9),
}


@pytest.mark.parametrize("name", list(STATEFUL))
def test_random_state_is_resolved(name, graphs, jax_draws):
    call = STATEFUL[name]
    ht, gt = graphs[tp]
    hj, gj = graphs[jp]
    with pytest.raises(TypeError):
        call(jp, hj, gj, jp.CuGraphRandomState(hj, 5))
    state = tp.CuGraphRandomState(ht, 5)
    got = call(tp, ht, gt, state)
    resolved = tp.CuGraphRandomState(None, 5).next_seed()
    _same(got, call(jp, hj, gj, resolved))
    # each use advances the state: the second call takes the next seed
    again = call(tp, ht, gt, state)
    _same(again, call(jp, hj, gj, (5 * 1_000_003 + 2) % 2**31))


TEMPORAL = ["homogeneous_uniform_temporal_neighbor_sample",
            "homogeneous_biased_temporal_neighbor_sample",
            "heterogeneous_uniform_temporal_neighbor_sample",
            "heterogeneous_biased_temporal_neighbor_sample"]


@pytest.mark.parametrize("name", TEMPORAL)
def test_temporal_keeps_label_offsets(name, graphs, jax_draws):
    het = name.startswith("heterogeneous")
    fanout = np.array(HET) if het else np.array([3, 2])
    extra = dict(num_edge_types=TYPES) if het else {}
    ht, gt = graphs[tp]
    hj, gj = graphs[jp]
    times = np.linspace(0, 6, len(SEEDS)).astype(np.float32)
    args = ("edge_time", SEEDS, times, OFFSETS, fanout)
    got = getattr(tp, name)(ht, gt["weighted"], *args, random_state=3,
                            **extra)
    labels = np.repeat(np.arange(3, dtype=np.int32), np.diff(OFFSETS))
    want = getattr(jp, name)(hj, gj["weighted"], *args, random_state=3,
                             batch_id_list=labels, **extra)
    _same(got, want)
    assert set(got["batch_id"]) == {0, 1, 2}
    # the JAX wrapper, without the keyword, loses the labels
    dropped = getattr(jp, name)(hj, gj["weighted"], *args, random_state=3,
                                **extra)
    assert set(dropped["batch_id"]) != {0, 1, 2}
