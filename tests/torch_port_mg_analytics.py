"""World bodies for the multi-device port's analytics tests.

``community_body`` and ``analytics_body`` run on every rank of a gloo
world (``torch_port_mg.run_worlds``) and return the arrays that
``tests/test_torch_parallel_community.py`` and
``tests/test_torch_parallel_analytics.py`` hold against
``cugraph_tpu.parallel``.  Every function under test returns host
results, the same on every rank, except ``mg_core_number`` (owned
slices, gathered here).  The inputs (graphs, pairs, seeds) are defined
here once, so that the JAX side of each test reads the same ones.  This
module imports only torch, NumPy, pandas and the port.
"""

from __future__ import annotations

import numpy as np

from torch_port_mg import GRAPHS, symmetric

# the three-blob graph of tests/test_parallel_kernels.py:200-235 (48
# vertices, three blobs of 16 and noise), symmetrized at the build
_rng = np.random.default_rng(17)
_blocks = [_rng.integers(0, 16, (2, 220)) + 16 * c for c in range(3)]
_noise = _rng.integers(0, 48, (2, 30))
_bs = np.concatenate([b[0] for b in _blocks] + [_noise[0]])
_bd = np.concatenate([b[1] for b in _blocks] + [_noise[1]])
_keep = _bs != _bd
_uniq = np.unique(_bs[_keep] * 48 + _bd[_keep])
BLOBS = ((_uniq // 48).astype(np.int64), (_uniq % 48).astype(np.int64), None,
         48)

# community graphs, each built with symmetrize=True in both packages
COMMUNITY = {"blobs": BLOBS, "weighted": GRAPHS["weighted"],
             "skew": GRAPHS["skew"], "star": GRAPHS["star"]}
ECG_SIZE = 4
ANALYTIC_NAMES = ("weighted", "unweighted", "star", "skew")


def sym_graph(name):
    """The symmetric simple graph of ``GRAPHS[name]`` (triangles, k-truss)."""
    src, dst, w, n = GRAPHS[name]
    s, d = symmetric(src, dst, n)
    return s, d, None, n


def pairs(name):
    """The similarity pairs of a graph: its first 60 edges, 40 reversed,
    and 40 random pairs (self-pairs included)."""
    src, dst, _, n = GRAPHS[name]
    rng = np.random.default_rng(5)
    a = rng.integers(0, n, 40)
    b = rng.integers(0, n, 40)
    return (np.concatenate([src[:60], dst[:40], a]).astype(np.int64),
            np.concatenate([dst[:60], src[:40], b]).astype(np.int64))


def seeds(name):
    """Egonet seeds and the k-hop start: endpoints of the first edges."""
    src, dst, _, n = GRAPHS[name]
    return np.array([src[0], dst[1], src[2]], np.int64)


def induced(name):
    n = GRAPHS[name][3]
    return np.arange(0, n, 3, dtype=np.int64)


def two_hop_starts(name):
    n = GRAPHS[name][3]
    return np.array([0, 1, n // 2, n - 1], np.int64)


def bc_sources(name):
    n = GRAPHS[name][3]
    return np.random.default_rng(11).choice(n, size=min(40, n),
                                            replace=False)


def _frame(out, key, df, cols):
    for c in cols:
        a = df[c].to_numpy()
        out[f"{key}/{c}"] = a.astype(np.float64) if a.dtype == object else a


def community_body(mesh, graphs):
    """Both move-phase engines, both contractions (of the host engine's
    partition), Louvain (with and without the distributed cascade),
    Leiden and ECG on every community graph."""
    from cugraph_tpu_torch.parallel import build_dist_graph, mg_ecg, prims
    from cugraph_tpu_torch.parallel.algos import LAST_RUN
    from cugraph_tpu_torch.parallel.louvain import (mg_coarsen, mg_leiden,
                                                    mg_louvain,
                                                    mg_louvain_move_phase)
    from cugraph_tpu_torch.parallel.partition import local_push_coo

    out = {}
    for name, (src, dst, w, n) in graphs.items():
        g = build_dist_graph(src, dst, w, n, mesh, store_push=True,
                             symmetrize=True)
        for engine in ("host", "device"):
            cl, q = mg_louvain_move_phase(g, mesh, engine=engine)
            out[f"{name}/move_{engine}/cluster"] = cl
            out[f"{name}/move_{engine}/q"] = np.array(q)
        lab_full = np.zeros(g.pad_v, np.int32)
        _, lab_full[:n] = np.unique(out[f"{name}/move_host/cluster"][:n],
                                    return_inverse=True)
        for engine in ("host", "device"):
            for k, a in enumerate(mg_coarsen(g, mesh, lab_full,
                                             engine=engine)):
                out[f"{name}/coarsen_{engine}/{k}"] = np.asarray(a)
        for label, kw in (("louvain", {}),
                          ("louvain_mg", {"sg_threshold_edges": 0})):
            lab, q = mg_louvain(g, mesh, **kw)
            out[f"{name}/{label}/labels"] = lab
            out[f"{name}/{label}/q"] = np.array(q)
            out[f"{name}/{label}/coarse_edges"] = np.array(
                LAST_RUN["coarse_edges"], np.int64)
            out[f"{name}/{label}/single_device_levels"] = np.array(
                LAST_RUN["single_device_levels"])
        lab, q = mg_leiden(g, mesh)
        out[f"{name}/leiden/labels"] = lab
        out[f"{name}/leiden/q"] = np.array(q)
        lab, q = mg_ecg(g, mesh, ensemble_size=ECG_SIZE, seed=3)
        out[f"{name}/ecg/labels"] = lab
        out[f"{name}/ecg/q"] = np.array(q)
        # the reweighted graph: every rank's push edges and weights
        for key, t in zip(("src", "dst", "w0", "w"),
                          (*local_push_coo(g), g.push.weights,
                           LAST_RUN["push_weights"])):
            out[f"{name}/ecg/{key}"] = prims.all_gather_rows(
                mesh, t).cpu().numpy()
    return out


def analytics_body(mesh, names):
    """Every analytics entry point but the community ones on each graph of
    ``names``; core numbers with each sweep's iterate."""
    import torch

    from cugraph_tpu_torch import parallel as mg
    from cugraph_tpu_torch.parallel import algos

    out = {}
    for name in names:
        src, dst, w, n = GRAPHS[name]
        g = mg.build_dist_graph(src, dst, w, n, mesh, store_push=True)
        f, s = pairs(name)
        out[f"{name}/cn"] = algos._mg_common_neighbors(g, mesh, f, s)
        # the alive mask: drop the shard edges (u, k) with 3 | u + k
        adj = algos._mg_intersect_ctx(g, mesh)
        alive = (adj.row_ids().long() + adj.indices.long()) % 3 != 0
        out[f"{name}/cn_alive"] = algos._mg_common_neighbors(
            g, mesh, f, s, alive=alive)
        out[f"{name}/out_counts"] = algos._mg_out_degree_counts(g, mesh)
        for kind in ("jaccard", "sorensen", "overlap", "cosine"):
            out[f"{name}/{kind}"] = getattr(
                mg, f"mg_{kind}_coefficients")(g, mesh, f, s)
            df = mg.mg_all_pairs_similarity(g, mesh, kind,
                                            vertices=np.arange(12))
            _frame(out, f"{name}/all_pairs_{kind}", df,
                   ["first", "second", f"{kind}_coeff"])
        df = mg.all_pairs_jaccard(g, mesh, topk=7, batch=50)
        _frame(out, f"{name}/all_pairs_top", df,
               ["first", "second", "jaccard_coeff"])
        out[f"{name}/cn_rows"] = algos._mg_cn_rows(g, mesh, [0, 3, 5])
        for label, kw in (("neg", {}),
                          ("neg_exact", {"exact_number_of_samples": True,
                                         "remove_duplicates": True}),
                          ("neg_cand", {"vertices": np.arange(0, n, 2)})):
            df = mg.mg_negative_sampling(g, mesh, 60, seed=4, **kw)
            _frame(out, f"{name}/{label}", df, ["src", "dst"])
        for dt in ("incoming", "outgoing", "bidirectional"):
            core = mg.mg_core_number(g, mesh, degree_type=dt)
            run = dict(algos.LAST_RUN)
            out[f"{name}/core_{dt}"] = mg.all_gather_vertex(mesh, core) \
                .numpy()
            out[f"{name}/core_{dt}/max_core"] = np.array(run["max_core"])
            out[f"{name}/core_{dt}/sweeps"] = np.array(run["sweeps"])
            # the sweeps' iterates, from the same start and the same sweep
            blocks = algos._core_blocks(g, dt)
            core = torch.where(algos._real(mesh, g)[1], run["max_core"],
                               0).to(torch.int32)
            trace = []
            for _ in range(run["sweeps"]):
                core = algos._core_sweep(mesh, blocks, core, run["max_core"])
                trace.append(mg.all_gather_vertex(mesh, core).numpy())
            out[f"{name}/core_{dt}/trace"] = np.stack(trace)
        for k, a in enumerate(mg.mg_k_core(g, mesh)):
            out[f"{name}/k_core/{k}"] = a
        for k, a in enumerate(mg.mg_k_core(g, mesh, k=2,
                                           degree_type="bidirectional")):
            out[f"{name}/k_core2/{k}"] = a
        srcs = bc_sources(name)
        out[f"{name}/bc"] = mg.mg_betweenness_centrality(g, mesh,
                                                         sources=srcs)
        out[f"{name}/bc_all_ends"] = mg.mg_betweenness_centrality(
            g, mesh, endpoints=True, normalized=False)
        out[f"{name}/bc_k"] = mg.mg_betweenness_centrality(
            g, mesh, k=25, seed=2, directed=False, normalized=False)
        for label, kw in (("ebc", {"sources": srcs}),
                          ("ebc_u", {"k": 30, "seed": 1,
                                     "directed": False})):
            df = mg.mg_edge_betweenness_centrality(g, mesh, **kw)
            _frame(out, f"{name}/{label}", df,
                   ["src", "dst", "betweenness_centrality"])
        out[f"{name}/scc"] = mg.mg_strongly_connected_components(g, mesh)
        out[f"{name}/k_hop"] = mg.mg_k_hop_nbrs(g, mesh, seeds(name)[0], 2)
        for k, a in enumerate(mg.mg_egonet(g, mesh, seeds(name), radius=2)):
            out[f"{name}/egonet/{k}"] = a
        for k, a in enumerate(mg.mg_induced_subgraph(g, mesh,
                                                     induced(name))):
            out[f"{name}/induced/{k}"] = a
        for label, sv in (("two_hop", two_hop_starts(name)),
                          ("two_hop_all", None)):
            for k, a in enumerate(mg.mg_two_hop_neighbors(g, mesh, sv)):
                out[f"{name}/{label}/{k}"] = a
        ss, sd, _, _ = sym_graph(name)
        gs = mg.build_dist_graph(ss, sd, None, n, mesh, store_push=True)
        out[f"{name}/triangles"] = mg.mg_triangle_count(gs, mesh)
        for k, a in enumerate(mg.mg_k_truss(gs, mesh, 4)):
            out[f"{name}/k_truss/{k}"] = a
    return out
