"""The MG plc layer's cases and the body the gloo worlds run.

``CALLS`` lists every call of an MG branch of the plc wrappers, each as a
function of the plc module, the handle and the two ``MGGraph``s of
``build_graphs`` (``tests/test_plc_surface_smoke_mg.py``'s graph: 40
vertices with ids, types and times, and its symmetric twin), so the port
and the JAX package run one list; ``flatten`` turns a result into named
arrays.  ``plc_body`` runs the calls named on every rank of a gloo world
and, for the random wrappers, the port's direct ``parallel.mg_*`` call on
the same seed, and holds the builds against ``build_dist_graph`` and
``build_dist_graph_from_chunks``.  This module imports only torch, NumPy,
pandas and the port.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

N = 40


def coo():
    """``test_plc_surface_smoke_mg.py::setup``'s edges."""
    rng = np.random.default_rng(6)
    src = rng.integers(0, N, 260)
    dst = rng.integers(0, N, 260)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    et = rng.uniform(0, 10, len(src)).astype(np.float32)
    types = (np.arange(len(src)) % 3).astype(np.int32)
    return src, dst, w, et, types


def build_graphs(plc, h):
    """(g, gu): the directed graph with ids, types (3 of them) and
    times, and the symmetric one (both directions given, duplicates
    dropped at the build)."""
    src, dst, w, et, types = coo()
    g = plc.MGGraph(
        h, plc.GraphProperties(is_symmetric=False, is_multigraph=False),
        src, dst, w, edge_id_array=np.arange(len(src)),
        edge_type_array=types, edge_start_time_array=et)
    gu = plc.MGGraph(
        h, plc.GraphProperties(is_symmetric=True, is_multigraph=False),
        np.concatenate([src, dst]), np.concatenate([dst, src]),
        np.concatenate([w, w]), drop_multi_edges=True)
    return g, gu


PAIRS = (np.array([0, 1, 5, 7, 11]), np.array([2, 3, 9, 30, 12]))
SEEDS = np.array([0, 1, 4, 9])
TIME = 2.5


def _fanout(name):
    """[2, 2] for a homogeneous sampler, one hop of [1, 2, 1] per edge
    type for a heterogeneous one."""
    return (np.array([1, 2, 1], np.int32) if name.startswith("heterogeneous")
            else np.array([2, 2], np.int32))


def _temporal(name, times):
    """A temporal wrapper in the reference positional order, start times
    ``times``."""
    def call(plc, h, g, gu):
        het = name.startswith("heterogeneous")
        return getattr(plc, name)(h, g, "edge_time", SEEDS, times, None,
                                  _fanout(name),
                                  num_edge_types=3 if het else None,
                                  random_state=3)
    return call


# name → (call, how the test holds it against the JAX package)
CALLS = {
    "pagerank": (lambda plc, h, g, gu: plc.pagerank(
        h, g, epsilon=1e-6, max_iterations=200), "power"),
    "personalized_pagerank": (lambda plc, h, g, gu: plc.personalized_pagerank(
        h, g, np.array([0, 3]), np.array([1.0, 2.0]), epsilon=1e-6,
        max_iterations=200), "power"),
    "hits": (lambda plc, h, g, gu: plc.hits(
        h, g, 1e-6, 300, np.arange(N), np.linspace(1.0, 2.0, N)), "power"),
    "katz_centrality": (lambda plc, h, g, gu: plc.katz_centrality(
        h, g, None, alpha=0.005, beta=1.0, epsilon=1e-6,
        max_iterations=300), "power"),
    "eigenvector_centrality": (lambda plc, h, g, gu:
                               plc.eigenvector_centrality(h, gu, 1e-6, 500),
                               "power"),
    "betweenness_centrality": (lambda plc, h, g, gu:
                               plc.betweenness_centrality(
                                   h, g, 8, 5, True, False), "bc"),
    "edge_betweenness_centrality": (lambda plc, h, g, gu:
                                    plc.edge_betweenness_centrality(
                                        h, g, 8, 5, True), "edge_bc"),
    "bfs": (lambda plc, h, g, gu: plc.bfs(h, g, np.array([0])), "exact"),
    "bfs_multisource": (lambda plc, h, g, gu: plc.bfs(
        h, gu, np.array([0, 3, 5]), depth_limit=2), "exact"),
    "sssp": (lambda plc, h, g, gu: plc.sssp(h, g, 0, 1e9, True, False),
             "exact"),
    "core_number": (lambda plc, h, g, gu: plc.core_number(
        h, gu, "bidirectional"), "exact"),
    "k_core": (lambda plc, h, g, gu: plc.k_core(h, gu, 2), "edges"),
    "louvain": (lambda plc, h, g, gu: plc.louvain(h, gu, 10, 1e-7, 1.0),
                "community"),
    "leiden": (lambda plc, h, g, gu: plc.leiden(h, None, gu, 10, 1e-7, 1.0,
                                                1.0), "community"),
    "ecg": (lambda plc, h, g, gu: plc.ecg(h, 2, gu, ensemble_size=4),
            "exact"),
    "triangle_count": (lambda plc, h, g, gu: plc.triangle_count(
        h, gu, start_list=np.array([0, 1, 7])), "exact"),
    "k_truss_subgraph": (lambda plc, h, g, gu: plc.k_truss_subgraph(h, gu, 3),
                         "edges"),
    "egonet": (lambda plc, h, g, gu: plc.egonet(h, gu, np.array([0, 5]), 1),
               "exact"),
    "ego_graph": (lambda plc, h, g, gu: plc.ego_graph(h, gu, np.array([3]),
                                                      2), "exact"),
    "weakly_connected_components": (
        lambda plc, h, g, gu: plc.weakly_connected_components(
            h, g, None, None, None, False), "exact"),
    "strongly_connected_components": (
        lambda plc, h, g, gu: plc.strongly_connected_components(h, g),
        "exact"),
    "jaccard_coefficients": (lambda plc, h, g, gu: plc.jaccard_coefficients(
        h, gu, *PAIRS, False, False), "exact"),
    "sorensen_coefficients": (lambda plc, h, g, gu:
                              plc.sorensen_coefficients(
                                  h, gu, *PAIRS, False, False), "exact"),
    "overlap_coefficients": (lambda plc, h, g, gu: plc.overlap_coefficients(
        h, gu, *PAIRS, False, False), "exact"),
    "cosine_coefficients": (lambda plc, h, g, gu: plc.cosine_coefficients(
        h, gu, *PAIRS, False, False), "exact"),
    "all_pairs_jaccard_coefficients": (
        lambda plc, h, g, gu: plc.all_pairs_jaccard_coefficients(
            h, gu, topk=5), "exact"),
    "all_pairs_sorensen_coefficients": (
        lambda plc, h, g, gu: plc.all_pairs_sorensen_coefficients(
            h, gu, vertices=np.array([0, 1, 2])), "exact"),
    "all_pairs_overlap_coefficients": (
        lambda plc, h, g, gu: plc.all_pairs_overlap_coefficients(
            h, gu, topk=5), "exact"),
    "all_pairs_cosine_coefficients": (
        lambda plc, h, g, gu: plc.all_pairs_cosine_coefficients(
            h, gu, topk=5), "exact"),
    "negative_sampling": (lambda plc, h, g, gu: plc.negative_sampling(
        h, g, 10, plc.CuGraphRandomState(h, 3)), "exact"),
    "induced_subgraph": (lambda plc, h, g, gu: plc.induced_subgraph(
        h, g, np.arange(10)), "edges"),
    "decompress_to_edgelist": (lambda plc, h, g, gu:
                               plc.decompress_to_edgelist(h, g), "edges"),
    "replicate_edgelist": (lambda plc, h, g, gu: plc.replicate_edgelist(
        h, graph=g), "edges"),
    "extract_vertex_list": (lambda plc, h, g, gu: plc.extract_vertex_list(
        h, g), "exact"),
    "select_random_vertices": (lambda plc, h, g, gu:
                               plc.select_random_vertices(h, g, 7, 5),
                               "exact"),
    "two_hop_neighbors": (lambda plc, h, g, gu: plc.two_hop_neighbors(
        h, g, None), "exact"),
    "get_two_hop_neighbors": (lambda plc, h, g, gu:
                              plc.get_two_hop_neighbors(
                                  h, g, np.array([0, 1])), "exact"),
    "degrees": (lambda plc, h, g, gu: plc.degrees(h, g, None, False),
                "exact"),
    "degrees_subset": (lambda plc, h, g, gu: plc.degrees(
        h, g, np.array([3, 1])), "exact"),
    "in_degrees": (lambda plc, h, g, gu: plc.in_degrees(h, g, None),
                   "exact"),
    "out_degrees": (lambda plc, h, g, gu: plc.out_degrees(h, g, None),
                    "exact"),
    "has_vertex": (lambda plc, h, g, gu: plc.has_vertex(
        h, g, np.array([0, 39, 40, 10**6])), "exact"),
    "count_multi_edges": (lambda plc, h, g, gu: plc.count_multi_edges(h, g),
                          "exact"),
    "edge_id_lookup_table": (lambda plc, h, g, gu: plc.edge_id_lookup_table(
        h, g).lookup_vertex_ids(np.array([0, 5, 17, -3, 10**6]), 2),
        "exact"),
    # the random wrappers: held against the port's direct call in the
    # body, and against the JAX frame's columns and dtypes
    "uniform_neighbor_sample": (lambda plc, h, g, gu:
                                plc.uniform_neighbor_sample(
                                    h, g, SEEDS, [3, 2], random_state=4),
                                "random"),
    "homogeneous_uniform_neighbor_sample": (
        lambda plc, h, g, gu: plc.homogeneous_uniform_neighbor_sample(
            h, g, SEEDS, np.array([0, 2, 4]), np.array([2, 2], np.int32),
            random_state=5, with_edge_properties=True), "random"),
    "homogeneous_biased_neighbor_sample": (
        lambda plc, h, g, gu: plc.homogeneous_biased_neighbor_sample(
            h, g, SEEDS, None, np.array([2], np.int32), random_state=6),
        "random"),
    "heterogeneous_uniform_neighbor_sample": (
        lambda plc, h, g, gu: plc.heterogeneous_uniform_neighbor_sample(
            h, g, SEEDS, None, None, np.array([1, 2, 1], np.int32),
            num_edge_types=3, random_state=7), "random"),
    "heterogeneous_biased_neighbor_sample": (
        lambda plc, h, g, gu: plc.heterogeneous_biased_neighbor_sample(
            h, g, SEEDS, None, None, np.array([1, 2, 1], np.int32),
            num_edge_types=3, random_state=8), "random"),
    "uniform_random_walks": (lambda plc, h, g, gu: plc.uniform_random_walks(
        h, g, SEEDS, 3, 9), "random"),
    "biased_random_walks": (lambda plc, h, g, gu: plc.biased_random_walks(
        h, g, SEEDS, 3, 10), "random"),
    "node2vec_random_walks": (lambda plc, h, g, gu:
                              plc.node2vec_random_walks(
                                  h, g, SEEDS, 3, 0.5, 2.0, 11), "random"),
}
for _name in ("homogeneous_uniform_temporal_neighbor_sample",
              "homogeneous_biased_temporal_neighbor_sample",
              "heterogeneous_uniform_temporal_neighbor_sample",
              "heterogeneous_biased_temporal_neighbor_sample"):
    # the JAX MG branches take a scalar start time only
    CALLS[_name] = (_temporal(_name, np.array([TIME])), "random")

# the direct ``parallel`` call each random wrapper must equal, on the
# wrapper's seed (``_seed``: an int passes through)
DIRECT = {
    "uniform_neighbor_sample": lambda mg, g, m: mg.mg_uniform_neighbor_sample(
        g, m, SEEDS, [3, 2], with_replacement=True, seed=4),
    "homogeneous_uniform_neighbor_sample":
        lambda mg, g, m: mg.mg_uniform_neighbor_sample(
            g, m, SEEDS, np.array([2, 2]), seed=5,
            with_edge_properties=True,
            batch_id_list=np.array([0, 0, 1, 1], np.int32)),
    "homogeneous_biased_neighbor_sample":
        lambda mg, g, m: mg.mg_biased_neighbor_sample(
            g, m, SEEDS, np.array([2]), seed=6),
    "heterogeneous_uniform_neighbor_sample":
        lambda mg, g, m: mg.mg_heterogeneous_neighbor_sample(
            g, m, SEEDS, np.array([1, 2, 1]), num_edge_types=3, seed=7),
    "heterogeneous_biased_neighbor_sample":
        lambda mg, g, m: mg.mg_heterogeneous_neighbor_sample(
            g, m, SEEDS, np.array([1, 2, 1]), num_edge_types=3, seed=8,
            biased=True),
    "uniform_random_walks": lambda mg, g, m: mg.mg_uniform_random_walks(
        g, m, SEEDS, 3, seed=9),
    "biased_random_walks": lambda mg, g, m: mg.mg_biased_random_walks(
        g, m, SEEDS, 3, seed=10),
    "node2vec_random_walks": lambda mg, g, m: mg.mg_node2vec_random_walks(
        g, m, SEEDS, 3, p=0.5, q=2.0, seed=11),
    "homogeneous_uniform_temporal_neighbor_sample":
        lambda mg, g, m: mg.mg_temporal_neighbor_sample(
            g, m, SEEDS, np.array([2, 2]), seed_time=TIME, seed=3),
    "homogeneous_biased_temporal_neighbor_sample":
        lambda mg, g, m: mg.mg_temporal_neighbor_sample(
            g, m, SEEDS, np.array([2, 2]), seed_time=TIME, seed=3,
            biased=True),
    "heterogeneous_uniform_temporal_neighbor_sample":
        lambda mg, g, m: mg.mg_heterogeneous_temporal_neighbor_sample(
            g, m, SEEDS, np.array([1, 2, 1]), num_edge_types=3,
            seed_time=TIME, seed=3),
    "heterogeneous_biased_temporal_neighbor_sample":
        lambda mg, g, m: mg.mg_heterogeneous_temporal_neighbor_sample(
            g, m, SEEDS, np.array([1, 2, 1]), num_edge_types=3,
            seed_time=TIME, seed=3, biased=True),
}

# the wrappers with no MG path: they raise NotImplementedError
SG_ONLY = {
    "balanced_cut_clustering": lambda plc, h, gu:
        plc.balanced_cut_clustering(h, gu, 3),
    "spectral_modularity_maximization": lambda plc, h, gu:
        plc.spectral_modularity_maximization(h, gu, 3),
    "analyze_clustering_modularity": lambda plc, h, gu:
        plc.analyze_clustering_modularity(h, gu, 2, np.arange(N),
                                          np.arange(N) % 2),
    "analyze_clustering_edge_cut": lambda plc, h, gu:
        plc.analyze_clustering_edge_cut(h, gu, 2, np.arange(N),
                                        np.arange(N) % 2),
    "analyze_clustering_ratio_cut": lambda plc, h, gu:
        plc.analyze_clustering_ratio_cut(h, gu, 2, np.arange(N),
                                         np.arange(N) % 2),
    "minimum_spanning_tree": lambda plc, h, gu:
        plc.minimum_spanning_tree(h, gu),
    "force_atlas2": lambda plc, h, gu: plc.force_atlas2(h, gu, max_iter=3),
}


def flatten(out) -> dict:
    """A wrapper's result as named arrays: a tuple's entries by position,
    a frame's columns by name, a scalar as a 0-d array."""
    if isinstance(out, pd.DataFrame):
        return {str(c): out[c].to_numpy() for c in out.columns}
    if isinstance(out, tuple):
        res = {}
        for k, v in enumerate(out):
            res.update({f"{k}/{kk}" if kk else str(k): vv
                        for kk, vv in flatten(v).items()})
        return res
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items() if v is not None}
    return {"": np.asarray(out)}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        x.dtype == b[k].dtype and np.array_equal(x, b[k], equal_nan=True)
        for k, x in a.items())


def _same_blocks(a, b) -> bool:
    """Two EdgeBlocks hold equal tensors."""
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        return x.dtype == y.dtype and torch.equal(x, y)

    return all(eq(getattr(a, f), getattr(b, f)) for f in (
        "offsets", "indices", "weights", "etype", "etime", "eid"))


def _same_graph(a, b) -> bool:
    return (_same_blocks(a.pull, b.pull) and _same_blocks(a.push, b.push)
            and torch.equal(a.out_degree, b.out_degree)
            and torch.equal(a.in_degree, b.in_degree)
            and (a.num_vertices, a.num_edges, a.chunk)
            == (b.num_vertices, b.num_edges, b.chunk))


def _all_ranks(mesh, ok: bool) -> bool:
    from cugraph_tpu_torch.parallel.prims import all_reduce

    return bool(all_reduce(torch.tensor([int(ok)], dtype=torch.int64),
                           mesh.world, "min").item())


def plc_body(mesh, names):
    """Every call of ``names`` through the port's plc on this world's
    mesh (``call/<name>/<key>``), the random ones' agreement with their
    direct call (``direct/<name>``, every rank), each SG-only wrapper's
    refusal (``raises/<name>``), the builds against the direct ones
    (``build/host``, ``build/sharded``) and the temporal wrappers on an
    all-equal per-seed time array against the scalar
    (``temporal_array/<name>``)."""
    from cugraph_tpu_torch import parallel as mg
    from cugraph_tpu_torch import plc

    h = plc.ResourceHandle(mesh=mesh)
    g, gu = build_graphs(plc, h)
    out = {}
    for name in names:
        call, how = CALLS[name]
        res = flatten(call(plc, h, g, gu))
        for k, v in res.items():
            out[f"call/{name}/{k}"] = v
        if name in DIRECT:
            want = flatten(DIRECT[name](mg, g.graph(), mesh))
            if name == "homogeneous_uniform_neighbor_sample":
                want["edge_id"] = g.lookup_edge_ids(want["sources"],
                                                    want["destinations"])
            out[f"direct/{name}"] = np.array(_all_ranks(mesh,
                                                        _same(res, want)))
    for name, call in SG_ONLY.items():
        try:
            call(plc, h, gu)
            raised = False
        except NotImplementedError:
            raised = True
        out[f"raises/{name}"] = np.array(raised)

    src, dst, w, et, types = coo()
    direct = mg.build_dist_graph(src, dst, w, N, mesh, store_push=True,
                                 edge_type=types, edge_time=et)
    out["build/host"] = np.array(_all_ranks(mesh, _same_graph(g.graph(),
                                                              direct)))
    ext = src * 1000 + 7, dst * 1000 + 7   # a sparse external id space
    chunks = [np.array_split(a, mesh.size) for a in (*ext, w)]
    gs = plc.MGGraph(h, None, *chunks, build="sharded",
                     edge_id_array=np.arange(len(src)))
    direct, nmap, stats = mg.build_dist_graph_from_chunks(
        mesh, *chunks, store_push=True)
    gp = plc.MGGraph(h, None, *ext, w, build="sharded")
    out["build/sharded"] = np.array(_all_ranks(
        mesh, _same_graph(gs.graph(), direct) and _same_graph(
            gp.graph(), direct) and gs.build_stats == stats
        and np.array_equal(gs.number_map.to_internal(ext[0]),
                           nmap.to_internal(ext[0]))))
    out["sharded/lookup"] = plc.edge_id_lookup_table(
        h, gs).lookup_vertex_ids(np.array([0, 3, 99, 10**6]))[
        ["src", "dst"]].to_numpy()
    out["sharded/has_vertex"] = plc.has_vertex(h, gs, [7, 8, 1007, 10**9])
    out["sharded/edge_ids"] = gs.lookup_edge_ids(
        gs.number_map.to_internal(ext[0][:9]),
        gs.number_map.to_internal(ext[1][:9]))

    for name in names:
        if "temporal" not in name:
            continue
        scalar = flatten(_temporal(name, TIME)(plc, h, g, gu))
        array = flatten(_temporal(name, np.full(len(SEEDS), TIME))(
            plc, h, g, gu))
        out[f"temporal_array/{name}"] = np.array(_all_ranks(
            mesh, _same_rows(scalar, array)))
    return out


def _same_rows(a: dict, b: dict) -> bool:
    """Two frames (as named arrays) hold the same rows, in any order."""
    if a.keys() != b.keys():
        return False
    cols = sorted(a)
    ka = np.lexsort([a[c] for c in cols]) if cols else []
    kb = np.lexsort([b[c] for c in cols]) if cols else []
    return all(np.array_equal(a[c][ka], b[c][kb]) for c in cols)


# ---------------------------------------------------------------------------
# the MG edge-id lookup and the compressed minor cache
# ---------------------------------------------------------------------------

def lookup_graphs():
    """name → (src, dst, edge ids, edge types, build): the 40-vertex
    graph with three types on the host build, and 64-bit external ids
    (≥ 2^33) with edge ids past 2^31 on the sharded build."""
    src, dst, w, _, types = coo()
    rng = np.random.default_rng(9)
    base_v = np.int64(3) << 32
    return {
        "typed": (src, dst, np.arange(len(src)), types, "host"),
        "wide": (base_v + rng.integers(0, 30, 120),
                 base_v + rng.integers(30, 60, 120),
                 (np.int64(5) << 31) + np.arange(120, dtype=np.int64),
                 np.zeros(120, np.int32), "sharded"),
    }


def lookup_queries(ids):
    """Present, missing, negative and past-the-end ids."""
    return np.concatenate([ids[[0, 1, 5, len(ids) - 1]],
                           [ids.max() + 1, -3, 10**9, np.int64(9) << 31]])


def spmv_graphs():
    """name → (src, dst, w, n): ``tests/test_kvcache.py``'s graphs (the
    random one, the hypersparse one with 12 distinct sources, and the
    two-edge one that leaves most blocks empty)."""
    rng = np.random.default_rng(11)
    n, m = 300, 2000
    random = (rng.integers(0, n, m), rng.integers(0, n, m),
              rng.uniform(0.1, 1.0, m).astype(np.float32), n)
    rng = np.random.default_rng(3)
    hyper = (rng.integers(0, 12, 3000), rng.integers(0, 4000, 3000),
             np.ones(3000, np.float32), 4000)
    tiny = (np.array([0, 1]), np.array([1, 0]), np.ones(2, np.float32), 2)
    return {"random": random, "hypersparse": hyper, "empty": tiny}


SPMV_CALLS = 3


def spmv_x(pad_v, k):
    return np.sin(np.arange(pad_v, dtype=np.float32) * (k + 1) * 0.37)


def lookup_kvcache_body(mesh):
    """Each lookup graph's frames for its queries and every type; each
    SpMV graph's cache (every rank's, gathered by position and padded to
    the longest), its compression ratio, and SPMV_CALLS compressed pulls
    gathered, with whether each equals ``prims.pull_spmv`` bit for bit
    on every rank."""
    from cugraph_tpu_torch import plc
    from cugraph_tpu_torch.parallel import (all_gather_vertex,
                                            build_dist_graph, prims)
    from cugraph_tpu_torch.parallel.kvcache import (build_minor_cache,
                                                    pull_spmv_compressed)

    h = plc.ResourceHandle(mesh=mesh)
    out = {}
    for name, (src, dst, ids, types, build) in lookup_graphs().items():
        g = plc.MGGraph(h, None, src, dst, None, edge_id_array=ids,
                        edge_type_array=types, build=build)
        table = plc.edge_id_lookup_table(h, g)
        for t in range(4):
            df = table.lookup_vertex_ids(lookup_queries(ids), t)
            for c in df.columns:
                out[f"lookup/{name}/{t}/{c}"] = df[c].to_numpy()

    def gathered(t, width):
        t = t.reshape(-1) if t.dim() else t.reshape(1)
        row = torch.full((width,), -1, dtype=torch.int64)
        row[:t.numel()] = t.to(torch.int64)
        return prims.all_gather_rows(mesh, row[None]).numpy()

    for name, (src, dst, w, n) in spmv_graphs().items():
        g = build_dist_graph(src, dst, w, n, mesh, store_push=False)
        cache = build_minor_cache(g, mesh)
        width = max(g.pmin * cache.r_max, 8192)
        for field in ("send_idx", "send_valid", "perm_recv", "src_comp"):
            out[f"cache/{name}/{field}"] = gathered(getattr(cache, field),
                                                    width)
        out[f"cache/{name}/dst_loc"] = gathered(g.pull.dst_loc, width)
        out[f"cache/{name}/ratio"] = np.array(cache.compression_ratio)
        out[f"cache/{name}/u_r"] = np.array([cache.u_max, cache.r_max])
        same = True
        for k in range(SPMV_CALLS):
            x = torch.from_numpy(spmv_x(g.pad_v, k)[
                mesh.rank * g.chunk:(mesh.rank + 1) * g.chunk])
            y = pull_spmv_compressed(g, cache, mesh, x)
            same &= bool(torch.equal(y, prims.pull_spmv(mesh, g.pull, x)))
            out[f"spmv/{name}/{k}"] = all_gather_vertex(mesh, y).numpy()
        out[f"spmv/{name}/same"] = np.array(_all_ranks(mesh, same))
    return out


# ---------------------------------------------------------------------------
# plc.comms, the long-tail names
# ---------------------------------------------------------------------------

def comms_rank_main(rank, world, uid, out_dir):
    """One rank of a ``cugraph_comms_init`` world over a ``TCPStore`` at
    ``uid``: the handle's mesh, a second init's refusal, an MGGraph's
    PageRank, the shutdown; rank 0 writes ``result.npz``."""
    import os
    import traceback

    from torch_port_mg import GLOO_TIMEOUT

    try:
        import torch.distributed as dist

        from cugraph_tpu_torch import plc
        from cugraph_tpu_torch.plc import comms

        torch.set_num_threads(1)
        h = comms.cugraph_comms_init(rank, world, uid, device="cpu",
                                     timeout=GLOO_TIMEOUT)
        m = h.get_mesh()
        again = False
        try:
            comms.cugraph_comms_init(rank, world, uid, device="cpu")
        except RuntimeError:
            again = True
        src, dst, w, _, _ = coo()
        g = plc.MGGraph(h, None, src, dst, w)
        _, p = plc.pagerank(h, g, epsilon=1e-6, max_iterations=200)
        same = comms.cugraph_comms_get_raft_handle() is h
        comms.cugraph_comms_shutdown()
        out = {"mesh": np.array([m.pmaj, m.pmin, m.i, m.j]),
               "again": np.array(again), "pagerank": p,
               "handle": np.array(same),
               "down": np.array(not dist.is_initialized()
                                and comms.cugraph_comms_get_raft_handle()
                                is None)}
        np.savez(os.path.join(out_dir, f"result_{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_comms_world(out_dir, world: int) -> list:
    """``comms_rank_main`` on ``world`` spawned processes over one store
    address; each rank's arrays, or the ranks' tracebacks raised."""
    import multiprocessing
    import os

    from cugraph_tpu_torch.plc.comms import cugraph_comms_create_unique_id
    from torch_port_mg import JOIN_SECONDS

    uid = cugraph_comms_create_unique_id(host="127.0.0.1")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=comms_rank_main,
                         args=(r, world, uid, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_SECONDS)
    errors = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join(10)
            errors.append(f"rank {r}: past the deadline")
        path = os.path.join(str(out_dir), f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    out = []
    for r in range(world):
        with np.load(os.path.join(str(out_dir), f"result_{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def longtail_body(mesh):
    """``make_test_mesh`` of this world's shape, a built DistGraph's
    bytes summed over the ranks with the estimate's inputs, and
    ``HostStagingBuffer.to_device(mesh=)``'s chunk on every rank."""
    from cugraph_tpu_torch.parallel import build_dist_graph
    from cugraph_tpu_torch.parallel.prims import all_gather_rows, all_reduce
    from cugraph_tpu_torch.testing import make_test_mesh
    from cugraph_tpu_torch.utils.memory import HostStagingBuffer

    tm = make_test_mesh(mesh.pmaj, mesh.pmin)
    out = {"test_mesh": np.array([tm.pmaj, tm.pmin, tm.i, tm.j,
                                  tm.device.type == "cpu"])}
    rng = np.random.default_rng(5)
    n, m = 5000, 40000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = build_dist_graph(src, dst, None, n, mesh, store_push=True)
    tensors = [g.out_degree, g.in_degree]
    for b in (g.pull, g.push):
        tensors += [t for t in (b.offsets, b.indices, b.weights, b.etype,
                                b.etime, b.eid) if t is not None]
    mine = sum(t.numel() * t.element_size() for t in tensors)
    out["graph_bytes"] = np.array(all_reduce(
        torch.tensor([mine], dtype=torch.int64), mesh.world).item())
    out["graph_shape"] = np.array([n, m])
    rows = np.arange(mesh.size * 6 * 3, dtype=np.float32).reshape(-1, 3)
    buf = HostStagingBuffer(rows)
    out["staged"] = all_gather_rows(mesh, buf.to_device(mesh=mesh)).numpy()
    out["staged_device"] = np.array(buf.to_device().device.type == "cpu")
    return out
