"""The plc parameter audit (``tests/test_plc_param_audit.py``: every
keyword of the reference .pyx signatures is plumbed) for the port: each of
its 14 cases runs on ``cugraph_tpu_torch.plc`` on the CPU with the same
arguments as on ``cugraph_tpu.plc``, keeps that test's assertions, and
compares the two packages' results: exactly, but for Katz within 1e-6
(float32 power iterations in two summation orders), the weighted Jaccard
within rtol 1e-6 (the port sums in float64) and the temporal sampler on
the JAX package's draws.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu.plc as jplc
from cugraph_tpu.algos import sampling as jS
from cugraph_tpu.plc import algorithms as ja

import cugraph_tpu_torch.plc as tplc
from cugraph_tpu_torch.algos import sampling as tS
from cugraph_tpu_torch.plc import algorithms as ta
from torch_port_draws import JaxDraws

torch.set_num_threads(1)

KATZ_ATOL = 1e-6
SIM_RTOL = 1e-6
PACKAGES = [(tplc, ta), (jplc, ja)]


def _handle(P):
    return P.ResourceHandle(device="cpu") if P is tplc else P.ResourceHandle()


def _graph(P, n=40, m=240, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    k = np.unique(src * n + dst)
    src, dst = k // n, k % n
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if weighted \
        else None
    g = P.SGGraph(_handle(P), None, src, dst, w)
    return g, src, dst, w


def _exact(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bfs_compute_predecessors_false():
    outs = []
    for P, plc in PACKAGES:
        g, src, *_ = _graph(P)
        d, p, v = plc.bfs(None, g, np.array([int(src[0])]),
                          compute_predecessors=False)
        assert (p == -1).all()
        d2, p2, _ = plc.bfs(None, g, np.array([int(src[0])]))
        np.testing.assert_array_equal(d, d2)
        assert (p2 >= 0).any()
        outs.append((d, p, v, d2, p2))
    _exact(*outs)


def test_sssp_compute_predecessors_false():
    outs = []
    for P, plc in PACKAGES:
        g, src, *_ = _graph(P)
        v, d, p = plc.sssp(None, g, int(src[0]), compute_predecessors=False)
        assert (p == -1).all()
        outs.append((v, p))
    _exact(*outs)


def test_katz_betas_vector():
    outs = []
    for P, plc in PACKAGES:
        g, *_ = _graph(P, weighted=False)
        n = g.number_of_vertices()
        betas = np.full(n, 2.0, np.float32)
        v1, c1 = plc.katz_centrality(None, g, betas=betas, alpha=0.02,
                                     max_iterations=500)
        v2, c2 = plc.katz_centrality(None, g, beta=2.0, alpha=0.02,
                                     max_iterations=500)
        np.testing.assert_allclose(c1, c2, rtol=1e-5)
        betas[0] = 50.0
        _, c3 = plc.katz_centrality(None, g, betas=betas, alpha=0.02,
                                    max_iterations=500)
        assert not np.allclose(c1, c3)
        outs.append((v1, c1, c3))
    (vt, c1t, c3t), (vj, c1j, c3j) = outs
    _exact(vt, vj)
    np.testing.assert_allclose(c1t, c1j, rtol=0, atol=KATZ_ATOL)
    np.testing.assert_allclose(c3t, c3j, rtol=0, atol=KATZ_ATOL)


def test_k_core_core_result_reused():
    outs = []
    for P, plc in PACKAGES:
        g, *_ = _graph(P, seed=3)
        v, core = plc.core_number(None, g)
        s1, d1, w1 = plc.k_core(None, g, k=2, core_result=(v, core))
        s2, d2, w2 = plc.k_core(None, g, k=2)
        key = lambda a, b: np.sort(a * 10**6 + b)
        np.testing.assert_array_equal(key(s1, d1), key(s2, d2))
        s3, d3, _ = plc.k_core(None, g, k=2,
                               core_result=(v, np.zeros_like(core)))
        assert len(s3) == 0
        outs.append((v, core, s1, d1, w1))
    _exact(*outs)


def test_wcc_legacy_csr_input():
    outs = []
    for P, plc in PACKAGES:
        offsets = np.array([0, 1, 2, 2, 3, 3])
        indices = np.array([1, 2, 4])
        v, labels = plc.weakly_connected_components(
            _handle(P), None, offsets=offsets, indices=indices, weights=None,
            labels=None)
        assert labels[0] == labels[1] == labels[2]
        assert labels[3] == labels[4]
        assert labels[0] != labels[3]
        outs.append((v, labels))
    _exact(*outs)


def test_similarity_use_weight():
    outs = []
    for P, plc in PACKAGES:
        g, src, dst, w = _graph(P, seed=5)
        pairs = (np.array([int(src[0])]), np.array([int(dst[0])]))
        f1, s1, c_unw = plc.jaccard_coefficients(None, g, *pairs)
        f2, s2, c_w = plc.jaccard_coefficients(None, g, *pairs,
                                               use_weight=True)
        assert c_unw.shape == c_w.shape
        outs.append((f1, s1, c_unw, c_w))
    (ft, st, ut, wt), (fj, sj, uj, wj) = outs
    _exact((ft, st, ut), (fj, sj, uj))
    np.testing.assert_allclose(wt, wj, rtol=SIM_RTOL, atol=0)


def test_negative_sampling_exact_count():
    for P, plc in PACKAGES:
        g, *_ = _graph(P, n=30, m=120, seed=7)
        s, d = plc.negative_sampling(None, g, 57, random_state=1,
                                     exact_number_of_samples=True)
        assert len(s) == 57


def test_negative_sampling_exact_count_on_jax_draws(monkeypatch):
    monkeypatch.setattr(tS, "Draws", lambda rs, device: JaxDraws(rs))
    outs = []
    for P, plc in PACKAGES:
        g, *_ = _graph(P, n=30, m=120, seed=7)
        outs.append(plc.negative_sampling(None, g, 57, random_state=1,
                                          exact_number_of_samples=True))
    _exact(*outs)


def test_rmat_edge_ids_and_types():
    outs = []
    for P, plc in PACKAGES:
        out = plc.generate_rmat_edgelist(None, 0, 8, 1000,
                                         include_edge_weights=True,
                                         include_edge_ids=True,
                                         include_edge_types=True,
                                         min_edge_type_value=2,
                                         max_edge_type_value=5)
        src, dst, w, eid, et = out
        assert len(eid) == 1000 and (eid == np.arange(1000)).all()
        assert et.min() >= 2 and et.max() <= 5
        outs.append(out)
    _exact(*outs)


def test_rmat_edgelists_random_state_varies():
    outs = []
    for P, plc in PACKAGES:
        a = plc.generate_rmat_edgelists(None, 0, 2, 6, 7)
        b = plc.generate_rmat_edgelists(None, 123, 2, 6, 7)
        assert len(a) == len(b) == 2
        same = all(len(x) == len(y) and (x["src"].to_numpy()
                                         == y["src"].to_numpy()).all()
                   for x, y in zip(a, b) if len(x) == len(y))
        assert not same
        outs.append(a + b)
    for x, y in zip(*outs):
        pd.testing.assert_frame_equal(x, y)


def test_replicate_edgelist_weight_passthrough():
    outs = []
    for P, plc in PACKAGES:
        src = np.array([0, 1])
        dst = np.array([1, 2])
        w = np.array([0.5, 2.5], np.float32)
        out = plc.replicate_edgelist(None, src_array=src, dst_array=dst,
                                     weight_array=w)
        assert len(out) == 3
        np.testing.assert_array_equal(out[2], w)
        outs.append(out)
    _exact(*outs)


def test_induced_subgraph_offsets_multiple():
    outs = []
    for P, plc in PACKAGES:
        g, src, dst, w = _graph(P, seed=9)
        verts = np.concatenate([np.arange(10), np.arange(10, 25)])
        offs = np.array([0, 10, 25])
        s, d, ww, eoff = plc.induced_subgraph(None, g, verts,
                                              subgraph_offsets=offs)
        assert len(eoff) == 3 and eoff[-1] == len(s)
        assert (s[: eoff[1]] < 10).all() and (d[: eoff[1]] < 10).all()
        assert (s[eoff[1]:] >= 10).all() and (s[eoff[1]:] < 25).all()
        outs.append((s, d, ww, eoff))
    _exact(*outs)


def test_sg_degrees_and_two_hop_honor_subsets():
    outs = []
    for P, plc in PACKAGES:
        h = _handle(P)
        src = np.array([0, 0, 1, 2, 3])
        dst = np.array([1, 2, 2, 3, 0])
        g = P.SGGraph(h, P.GraphProperties(is_symmetric=False), src, dst,
                      None, renumber=False, vertices_array=np.arange(5))
        v, din, dout = plc.degrees(h, g, source_vertices=[1, 3])
        assert list(v) == [1, 3] and len(din) == 2 == len(dout)
        v2, d2 = plc.in_degrees(h, g, source_vertices=[2])
        assert list(v2) == [2] and d2[0] == 2
        f, s = plc.two_hop_neighbors(h, g, start_vertices=[0])
        assert set(f.tolist()) <= {0}
        outs.append((v, din, dout, v2, d2, f, s))
    _exact(*outs)


def test_label_offsets_become_batches(monkeypatch):
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)
    monkeypatch.setattr(tS, "Draws", lambda rs, device: JaxDraws(rs))
    outs = []
    for P, plc in PACKAGES:
        h = _handle(P)
        src = np.array([0, 0, 1, 1, 2, 2, 3, 3])
        dst = np.array([1, 2, 2, 3, 3, 0, 0, 1])
        g = P.SGGraph(h, P.GraphProperties(is_symmetric=False), src, dst,
                      None, renumber=False, vertices_array=np.arange(4))
        df = plc.homogeneous_uniform_neighbor_sample(
            h, g, np.array([0, 1, 2, 3]),
            starting_vertex_label_offsets=np.array([0, 2, 4]),
            h_fan_out=np.array([2]), random_state=0)
        bids = set(np.asarray(df["batch_id"]).tolist())
        assert bids == {0, 1}, bids
        with pytest.raises(ValueError, match="label_offsets"):
            plc.homogeneous_uniform_neighbor_sample(
                h, g, np.array([0, 1]),
                starting_vertex_label_offsets=np.array([0, 5]),
                h_fan_out=np.array([2]))
        outs.append(df)
    pd.testing.assert_frame_equal(*outs)


def test_temporal_per_seed_start_times(monkeypatch):
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)
    monkeypatch.setattr(tS, "Draws", lambda rs, device: JaxDraws(rs))
    outs = []
    for P, plc in PACKAGES:
        h = _handle(P)
        src = np.array([0, 1])
        dst = np.array([1, 2])
        tm = np.array([5.0, 6.0], np.float32)
        g = P.SGGraph(h, P.GraphProperties(is_symmetric=False), src, dst,
                      None, renumber=False, vertices_array=np.arange(3),
                      edge_start_time_array=tm)
        df = plc.homogeneous_uniform_temporal_neighbor_sample(
            h, g, "t", np.array([0, 1]), np.array([0.0, 99.0]), None,
            np.array([2]), random_state=0)
        rows = list(zip(np.asarray(df["sources"]).tolist(),
                        np.asarray(df["destinations"]).tolist()))
        assert (0, 1) in rows
        assert (1, 2) not in rows
        outs.append(df)
    pd.testing.assert_frame_equal(*outs)
