"""The port's first slice end to end: pagerank and hits in cugraph_tpu_torch
against cugraph_tpu, on the same graphs, on the CPU.

The JAX side runs its XLA path, and its Pallas path in interpret mode
(``CUGRAPH_TPU_PALLAS_INTERPRET``), as its own tests do.  Tolerance atol
1e-6 on the scores: both iterate in float32 and sum in different orders.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.kernels import spmv

torch.set_num_threads(1)
ATOL = 1e-6
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, weights or None, directed) from a numpy seed or a bundled
    dataset."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None, False
    if kind in ("netscience", "email-Eu-core"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return (a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                a[:, 2].astype(np.float32), kind == "email-Eu-core")
    if kind == "rmat12":
        e = ctpu.rmat(12, 16 << 12, seed=12)
        return e["src"].to_numpy(), e["dst"].to_numpy(), None, True
    rng = np.random.default_rng(0)   # "directed60": dangling vertices too
    return rng.integers(0, 60, 500), rng.integers(0, 50, 500), None, True


def _pair(kind):
    src, dst, w, directed = _edges(kind)
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    return Gj, Gt


def _assert_frames_close(got, want, cols):
    got = got.sort_values("vertex").reset_index(drop=True)
    want = want.sort_values("vertex").reset_index(drop=True)
    np.testing.assert_array_equal(got["vertex"].to_numpy(),
                                  want["vertex"].to_numpy())
    for col in cols:
        assert got[col].dtype == np.float32
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["karate", "netscience", "email-Eu-core",
                                  "rmat12"])
def test_pagerank_and_hits_match_jax_xla_path(kind):
    Gj, Gt = _pair(kind)
    want, conv_j = ctpu.pagerank(Gj, fail_on_nonconvergence=False)
    got, conv_t = ct.pagerank(Gt, fail_on_nonconvergence=False)
    assert conv_t == conv_j
    _assert_frames_close(got, want, ["pagerank"])
    _assert_frames_close(ct.hits(Gt), ctpu.hits(Gj),
                         ["hubs", "authorities"])


@pytest.mark.parametrize("kind", ["karate", "directed60"])
def test_pagerank_and_hits_match_jax_pallas_interpret(kind, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    Gj, Gt = _pair(kind)
    # 1e-6: the JAX kernel's split-bf16 products leave an L1 floor ~3e-7
    _assert_frames_close(ct.pagerank(Gt, tol=1e-6, max_iter=200),
                         ctpu.pagerank(Gj, tol=1e-6, max_iter=200),
                         ["pagerank"])
    _assert_frames_close(ct.hits(Gt, max_iter=30, tol=0.0),
                         ctpu.hits(Gj, max_iter=30, tol=0.0),
                         ["hubs", "authorities"])


def test_pagerank_options_match_jax():
    Gj, Gt = _pair("directed60")
    rng = np.random.default_rng(2)
    verts = np.arange(60)
    pers = pd.DataFrame({"vertex": verts[:10],
                         "values": rng.random(10).astype(np.float32)})
    nstart = {int(v): float(rng.random()) for v in verts}
    dangling = {0: 1.0, 7: 3.0}
    # at least the true out-weight (so the iteration stays bounded), and
    # zero for a few vertices, which then count as dangling
    deg = Gt.degrees()
    sums = deg["out_degree"].to_numpy() + rng.integers(0, 2, len(deg))
    sums[:5] = 0
    ow = pd.DataFrame({"vertex": deg["vertex"].to_numpy(),
                       "sums": sums.astype(np.float32)})
    for kw in (dict(personalization=pers), dict(nstart=nstart),
               dict(dangling=dangling),
               dict(precomputed_vertex_out_weight=ow),
               dict(alpha=0.6, personalization={3: 1.0, 5: 1.0},
                    dangling=dangling, nstart=nstart)):
        _assert_frames_close(ct.pagerank(Gt, max_iter=300, **kw),
                             ctpu.pagerank(Gj, max_iter=300, **kw),
                             ["pagerank"])
    hub0 = pd.DataFrame({"vertex": verts,
                         "values": rng.random(60).astype(np.float32)})
    _assert_frames_close(
        ct.hits(Gt, nstart=hub0, normalized=False, max_iter=40, tol=0.0),
        ctpu.hits(Gj, nstart=hub0, normalized=False, max_iter=40, tol=0.0),
        ["hubs", "authorities"])


def test_nonconvergence_and_precision():
    Gj, Gt = _pair("karate")
    with pytest.raises(ct.FailedToConvergeError):
        ct.pagerank(Gt, max_iter=1)
    with pytest.raises(ctpu.FailedToConvergeError):
        ctpu.pagerank(Gj, max_iter=1)
    got, conv = ct.pagerank(Gt, max_iter=1, fail_on_nonconvergence=False)
    want, conv_j = ctpu.pagerank(Gj, max_iter=1,
                                 fail_on_nonconvergence=False)
    assert conv is False and conv_j is False
    _assert_frames_close(got, want, ["pagerank"])
    assert issubclass(ct.FailedToConvergeError, ct.exceptions.CugraphTpuError)
    for fn in (ct.pagerank, ct.hits):
        with pytest.raises(ValueError, match="precision"):
            fn(Gt, precision="bogus")
    # on the card both precisions run the same fp32 kernel
    pd.testing.assert_frame_equal(ct.pagerank(Gt, precision="fast"),
                                  ct.pagerank(Gt, precision="exact"))
    with pytest.raises(ValueError, match="sums to zero"):
        ct.pagerank(Gt, personalization={0: 0.0})


def test_rmat_graph_entry_point_on_the_cpu():
    G = ct.rmat(9, 16 << 9, seed=3, create_using=ct.DiGraph(device="cpu"))
    want = ctpu.pagerank(ctpu.rmat(9, 16 << 9, seed=3,
                                   create_using=ctpu.DiGraph))
    _assert_frames_close(ct.pagerank(G), want, ["pagerank"])


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _edges("rmat12")
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst, w)
    before = spmv.LAUNCHES
    got, _ = ct.pagerank(Gg, max_iter=40, tol=0.0,
                         fail_on_nonconvergence=False)
    assert spmv.LAUNCHES == before + 40
    want, _ = ct.pagerank(Gc, max_iter=40, tol=0.0,
                          fail_on_nonconvergence=False)
    _assert_frames_close(got, want, ["pagerank"])
    before = spmv.LAUNCHES
    got = ct.hits(Gg, max_iter=15, tol=0.0)
    assert spmv.LAUNCHES == before + 30
    _assert_frames_close(got, ct.hits(Gc, max_iter=15, tol=0.0),
                         ["hubs", "authorities"])
