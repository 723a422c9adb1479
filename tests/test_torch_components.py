"""The port's weakly connected components against cugraph_tpu on the CPU.

Labels are the smallest internal vertex id of each component, mapped to
external ids, so the frames must be identical: on the JAX package's XLA
route, and on its Pallas route in interpret mode (graphs of at most 500
vertices).
"""

import os

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
    _, Gt = _pair("sparse200")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.connected_components(Gt, connection="strong")
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
