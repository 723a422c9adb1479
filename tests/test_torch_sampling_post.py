"""The port's sampling post-processing (a copy of the JAX package's NumPy
and pandas module) against cugraph_tpu's on the JAX package's own sampled
frames: every output equal, arrays bit for bit and frames with their
dtypes, for every function and option.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest

import cugraph_tpu as ctpu
from cugraph_tpu.algos import sampling_post as jP

from cugraph_tpu_torch.algos import sampling_post as tP


def _assert_same(got, want, where="out"):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _sampled_frame(kind, **kw):
    """A frame from cugraph_tpu's sampler: 12 seeds in 3 batches."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        G = ctpu.Graph().from_edgelist(e[:, 0], e[:, 1], None)
    else:
        rng = np.random.default_rng(4)
        src, dst = rng.integers(0, 400, 3000), rng.integers(0, 400, 3000)
        w = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
        G = ctpu.Graph(directed=True).from_edgelist(src * 2, dst * 2, w)
    seeds = G.nodes()[np.random.default_rng(1).integers(
        0, G.number_of_vertices(), 12)]
    return ctpu.uniform_neighbor_sample(
        G, seeds, [4, 3], random_state=9,
        batch_id_list=np.arange(12) % 3, **kw), G


FRAMES = ["karate", "random", "karate_no_hops"]


def _frame(name):
    if name == "karate_no_hops":
        return _sampled_frame("karate", return_hops=False)
    return _sampled_frame(name)


@pytest.mark.parametrize("name", FRAMES)
def test_renumber_compress_and_batches_match_jax(name):
    df, _ = _frame(name)
    got, want = tP.renumber_sampled_edgelist(df), \
        jP.renumber_sampled_edgelist(df)
    _assert_same(got, want)
    _assert_same(tP.compress_per_hop_csr(*got), jP.compress_per_hop_csr(*want))
    _assert_same(tP.sampling_results_to_batches(df),
                 jP.sampling_results_to_batches(df))


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("opts", [
    dict(),
    dict(src_is_major=False),
    dict(compress_per_hop=True),
    dict(doubly_compress=True),
    dict(doubly_compress=True, src_is_major=False),
    dict(seed_vertices_per_label="seeds"),
])
def test_renumber_and_compress_matches_jax(name, opts):
    df, G = _frame(name)
    opts = dict(opts)
    if opts.get("seed_vertices_per_label") == "seeds":
        opts["seed_vertices_per_label"] = {
            b: grp["sources"].to_numpy()[:2]
            for b, grp in df.groupby("batch_id")}
    if opts.get("compress_per_hop") and "hop_id" not in df:
        for mod in (tP, jP):
            with pytest.raises(ValueError, match="hop ids"):
                mod.renumber_and_compress_sampled_edgelist(df, **opts)
        return
    _assert_same(tP.renumber_and_compress_sampled_edgelist(df, **opts),
                 jP.renumber_and_compress_sampled_edgelist(df, **opts))


def test_renumber_and_compress_rejects_both_compressions():
    df, _ = _frame("karate")
    for mod in (tP, jP):
        with pytest.raises(ValueError, match="doubly_compress"):
            mod.renumber_and_compress_sampled_edgelist(
                df, compress_per_hop=True, doubly_compress=True)


@pytest.mark.parametrize("name", ["karate", "random"])
@pytest.mark.parametrize("src_is_major", [True, False])
def test_heterogeneous_renumber_and_sort_matches_jax(name, src_is_major):
    """On the sampled frame with two edge types and edge ids added, and two
    vertex types splitting the id range."""
    df, G = _frame(name)
    df = df.assign(edge_type=((df["sources"] + df["destinations"]) % 2)
                   .astype(np.int32),
                   edge_id=np.arange(len(df), dtype=np.int64) * 7)
    top = int(max(df["sources"].max(), df["destinations"].max())) + 1
    vto = np.array([0, top // 2, top])
    kw = dict(vertex_type_offsets=vto, num_edge_types=2,
              src_is_major=src_is_major)
    _assert_same(
        tP.heterogeneous_renumber_and_sort_sampled_edgelist(df, **kw),
        jP.heterogeneous_renumber_and_sort_sampled_edgelist(df, **kw))
