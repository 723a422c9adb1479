"""Stable-layer algorithm functions (pylibcugraph's one-module-per-algorithm
surface) over the port's engine.

Counterpart of ``cugraph_tpu.plc.algorithms``.  Every function takes
``(resource_handle, graph, ...)`` and returns plain NumPy arrays (or the
frames the JAX wrapper returns), exactly as there.  An ``SGGraph`` (or a
port ``Graph``) runs on its device, through the same kernels as the
top-level functions; an ``MGGraph`` runs the multi-device layer's
``parallel.mg_*`` on its ``DistGraph`` and mesh, every rank calling the
wrapper alike and getting the same full host result (an owned slice [Vc]
is all-gathered and cut to the real vertices).  The wrappers with no MG
path raise ``NotImplementedError`` on an ``MGGraph`` (``_sg``).

Three faults of the JAX wrappers are not copied: every random wrapper
resolves ``random_state`` with ``_seed`` (the JAX single-device branches
hand a ``CuGraphRandomState`` through raw, and the engines raise
``TypeError`` on it); the temporal samplers' reference positional order
keeps ``starting_vertex_label_offsets`` (the JAX ``_temporal_compat`` drops
it); and the MG temporal branches pass an array of per-seed start times
through (the JAX ones call ``float`` on it, which raises past one seed).
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.plc.graphs import MGGraph, SGGraph, handle_device


def _sg(graph):
    if isinstance(graph, SGGraph):
        return graph.graph()
    if isinstance(graph, MGGraph):
        raise NotImplementedError("this algorithm has no MG path yet; "
                                  "see cugraph_tpu_torch.parallel for MG "
                                  "coverage")
    return graph  # allow raw Graph


def _mg(graph):
    """(DistGraph, mesh) of an MGGraph."""
    return graph.graph(), graph.mesh


def _full(graph, x):
    """An MG result as a host array over the real vertices: an owned
    slice [Vc] all-gathered to [pad_v] first (every rank joins)."""
    import torch

    if isinstance(x, torch.Tensor):
        from cugraph_tpu_torch.parallel import all_gather_vertex

        x = all_gather_vertex(graph.mesh, x).cpu().numpy()
    return np.asarray(x)[:graph.graph().num_vertices]


def _verts(graph):
    return np.arange(graph.graph().num_vertices, dtype=np.int32)


def _dense(graph, vertices, values):
    """float32 [num_vertices], ``values`` at ``vertices``, 0 elsewhere."""
    out = np.zeros(graph.graph().num_vertices, np.float32)
    out[np.asarray(vertices)] = np.asarray(values, np.float32)
    return out


def _vert_df(df, value_cols):
    v = df["vertex"].to_numpy()
    return (v, *[df[c].to_numpy() for c in value_cols])


def _seed(random_state) -> int:
    """Resolve an int seed from None / int / CuGraphRandomState (each use
    of a state object advances it — repeated calls differ like the
    reference's rng_state)."""
    if random_state is None:
        return 0
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    if isinstance(random_state, CuGraphRandomState):
        return random_state.next_seed()
    return abs(hash(random_state)) % (2**31)


# -- link analysis -----------------------------------------------------------

def pagerank(resource_handle, graph,
             precomputed_vertex_out_weight_vertices=None,
             precomputed_vertex_out_weight_sums=None,
             initial_guess_vertices=None, initial_guess_values=None,
             alpha=0.85, epsilon=1e-5, max_iterations=100,
             do_expensive_check=False, fail_on_nonconvergence=True):
    import pandas as pd

    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_pagerank

        p, _, _ = mg_pagerank(*_mg(graph), alpha=alpha, tol=epsilon,
                              max_iter=max_iterations)
        return _verts(graph), _full(graph, p)
    kw = {}
    if precomputed_vertex_out_weight_vertices is not None:
        kw["precomputed_vertex_out_weight"] = pd.DataFrame({
            "vertex": np.asarray(precomputed_vertex_out_weight_vertices),
            "sums": np.asarray(precomputed_vertex_out_weight_sums),
        })
    if initial_guess_vertices is not None:
        kw["nstart"] = pd.DataFrame({
            "vertex": np.asarray(initial_guess_vertices),
            "values": np.asarray(initial_guess_values),
        })
    out = ct.pagerank(_sg(graph), alpha=alpha, tol=epsilon,
                      max_iter=max_iterations,
                      fail_on_nonconvergence=fail_on_nonconvergence, **kw)
    df = out[0] if isinstance(out, tuple) else out
    return _vert_df(df.sort_values("vertex"), ["pagerank"])


def personalized_pagerank(resource_handle, graph, personalization_vertices,
                          personalization_values, alpha=0.85, epsilon=1e-5,
                          max_iterations=100, **kw):
    import pandas as pd

    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_pagerank

        p, _, _ = mg_pagerank(*_mg(graph), alpha=alpha, tol=epsilon,
                              max_iter=max_iterations,
                              personalization=_dense(
                                  graph, personalization_vertices,
                                  personalization_values))
        return _verts(graph), _full(graph, p)
    pers = pd.DataFrame({"vertex": np.asarray(personalization_vertices),
                         "values": np.asarray(personalization_values)})
    df = ct.pagerank(_sg(graph), alpha=alpha, tol=epsilon,
                     max_iter=max_iterations, personalization=pers)
    return _vert_df(df.sort_values("vertex"), ["pagerank"])


def hits(resource_handle, graph, tol=1e-5, max_iter=100,
         initial_hubs_guess_vertices=None, initial_hubs_guess_values=None,
         normalized=True, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_hits

        nstart = (None if initial_hubs_guess_vertices is None else _dense(
            graph, initial_hubs_guess_vertices, initial_hubs_guess_values))
        h, a, _, _ = mg_hits(*_mg(graph), tol=tol, max_iter=max_iter,
                             normalized=normalized, nstart=nstart)
        return _verts(graph), _full(graph, h), _full(graph, a)
    kw = {}
    if initial_hubs_guess_vertices is not None:
        import pandas as pd

        kw["nstart"] = pd.DataFrame({
            "vertex": np.asarray(initial_hubs_guess_vertices),
            "values": np.asarray(initial_hubs_guess_values),
        })
    df = ct.hits(_sg(graph), max_iter=max_iter, tol=tol, normalized=normalized,
                 **kw)
    return _vert_df(df.sort_values("vertex"), ["hubs", "authorities"])


# -- traversal ---------------------------------------------------------------

def bfs(resource_handle, graph, sources, direction_optimizing=False,
        depth_limit=-1, compute_predecessors=True, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    srcs = np.asarray(sources).reshape(-1)
    dl = None if depth_limit in (-1, None) else depth_limit
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_bfs

        # single or multi-source: one multi-root traversal
        dist, pred = mg_bfs(*_mg(graph), srcs, dl)
        n = graph.graph().num_vertices
        pred = (_full(graph, pred) if compute_predecessors
                else np.full(n, -1, np.int32))
        return _full(graph, dist), pred, _verts(graph)
    if len(srcs) > 1:
        # multi-source BFS: one batched panel sweep (K4), distances = the
        # per-vertex min, the predecessor of the source that attains it
        ms = ct.multi_source_bfs(_sg(graph), srcs.tolist(), depth_limit=dl)
        ms = ms.sort_values("vertex")
        dcols = [c for c in ms.columns if c.startswith("distance_")]
        pcols = [c for c in ms.columns if c.startswith("predecessor_")]
        D = ms[dcols].to_numpy()
        P = ms[pcols].to_numpy()
        best = np.argmin(D, axis=1)
        rows = np.arange(len(ms))
        pv = (P[rows, best] if compute_predecessors
              else np.full(len(ms), -1, np.int64))
        return (D[rows, best], pv, ms["vertex"].to_numpy())
    df = ct.bfs(_sg(graph), start=srcs[0], depth_limit=dl,
                return_predecessors=compute_predecessors)
    df = df.sort_values("vertex")
    # reference order: (distances, predecessors, vertices) — bfs.pyx:196
    return (df["distance"].to_numpy(), df["predecessor"].to_numpy(),
            df["vertex"].to_numpy())


def sssp(resource_handle, graph, source, cutoff=np.inf,
         compute_predecessors=True, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_sssp

        dist, pred = mg_sssp(*_mg(graph), int(source), cutoff)
        return _verts(graph), _full(graph, dist), _full(graph, pred)
    df = ct.sssp(_sg(graph), source=source, cutoff=cutoff) \
        .sort_values("vertex")
    pred = (df["predecessor"].to_numpy() if compute_predecessors
            else np.full(len(df), -1, np.int64))
    return df["vertex"].to_numpy(), df["distance"].to_numpy(), pred


# -- centrality --------------------------------------------------------------

def katz_centrality(resource_handle, graph, betas=None, alpha=0.1, beta=1.0,
                    epsilon=1e-6, max_iterations=100,
                    do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_katz_centrality

        if betas is not None:
            raise NotImplementedError("per-vertex betas: SG only")
        c, _, _ = mg_katz_centrality(*_mg(graph), alpha=alpha, beta=beta,
                                     tol=epsilon, max_iter=max_iterations)
        return _verts(graph), _full(graph, c)
    G = _sg(graph)
    if betas is not None:
        # betas align with the wrapper's output order (vertices sorted by
        # external id); re-index into the engine's internal id space
        n = G.number_of_vertices()
        ext_sorted = np.sort(G.number_map.to_external(np.arange(n)))
        b_int = np.zeros(n, np.float32)
        b_int[G.lookup_internal_vertex_id(ext_sorted)] = \
            np.asarray(betas, np.float32)
        beta = b_int
    df = ct.katz_centrality(G, alpha=alpha, beta=beta,
                            tol=epsilon, max_iter=max_iterations)
    return _vert_df(df.sort_values("vertex"), ["katz_centrality"])


def eigenvector_centrality(resource_handle, graph, epsilon=1e-6,
                           max_iterations=100, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_eigenvector_centrality

        c, _, _ = mg_eigenvector_centrality(*_mg(graph), tol=epsilon,
                                            max_iter=max_iterations)
        return _verts(graph), _full(graph, c)
    df = ct.eigenvector_centrality(_sg(graph), tol=epsilon,
                                   max_iter=max_iterations)
    return _vert_df(df.sort_values("vertex"), ["eigenvector_centrality"])


def betweenness_centrality(resource_handle, graph, k=None, random_state=None,
                           normalized=True, include_endpoints=False,
                           do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_betweenness_centrality

        bc = mg_betweenness_centrality(*_mg(graph), k=k,
                                       normalized=normalized,
                                       seed=_seed(random_state),
                                       endpoints=include_endpoints)
        return _verts(graph), _full(graph, bc)
    df = ct.betweenness_centrality(_sg(graph), k=k, normalized=normalized,
                                   endpoints=include_endpoints,
                                   seed=_seed(random_state))
    return _vert_df(df.sort_values("vertex"), ["betweenness_centrality"])


def edge_betweenness_centrality(resource_handle, graph, k=None,
                                random_state=None, normalized=True,
                                do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_edge_betweenness_centrality

        df = mg_edge_betweenness_centrality(*_mg(graph), k=k,
                                            normalized=normalized,
                                            seed=_seed(random_state))
    else:
        df = ct.edge_betweenness_centrality(_sg(graph), k=k,
                                            normalized=normalized,
                                            seed=_seed(random_state))
    return (df["src"].to_numpy(), df["dst"].to_numpy(),
            df["betweenness_centrality"].to_numpy())


# -- community ---------------------------------------------------------------

def louvain(resource_handle, graph, max_level=100, threshold=1e-7,
            resolution=1.0, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_louvain

        labels, mod = mg_louvain(*_mg(graph), max_level=max_level,
                                 resolution=resolution, threshold=threshold)
        return _verts(graph), _full(graph, labels), float(mod)
    parts, mod = ct.louvain(_sg(graph), max_level=max_level,
                            threshold=threshold, resolution=resolution)
    parts = parts.sort_values("vertex")
    return (parts["vertex"].to_numpy(), parts["partition"].to_numpy(),
            float(mod))


def _graph_second(random_state, graph):
    """Legacy (graph-second) calls of the random-state-second wrappers are
    detected and swapped."""
    if graph is None or isinstance(random_state, (SGGraph, MGGraph)):
        return graph, random_state
    return random_state, graph


def leiden(resource_handle, random_state=None, graph=None, max_level=100,
           resolution=1.0, theta=1.0, do_expensive_check=False):
    """Reference positional order (leiden.pyx:50): random_state SECOND,
    graph third.  Legacy (graph-second) calls are detected and swapped."""
    import cugraph_tpu_torch as ct

    random_state, graph = _graph_second(random_state, graph)
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_leiden

        # theta: not used by the MG path, whose refinement splits
        # communities by WCC (parallel/louvain.py mg_leiden)
        labels, mod = mg_leiden(*_mg(graph), max_level=max_level,
                                resolution=resolution)
        return _verts(graph), _full(graph, labels), float(mod)
    parts, mod = ct.leiden(_sg(graph), max_iter=max_level,
                           resolution=resolution,
                           random_state=_seed(random_state), theta=theta)
    parts = parts.sort_values("vertex")
    return (parts["vertex"].to_numpy(), parts["partition"].to_numpy(),
            float(mod))


def ecg(resource_handle, random_state=None, graph=None, min_weight=0.0001,
        ensemble_size=16, max_level=10, threshold=1e-7, resolution=1.0,
        do_expensive_check=False):
    """Reference positional order (ecg.pyx:50): random_state SECOND.
    Legacy (graph-second) calls are detected and swapped.  Every argument
    reaches the engine (the JAX single-device branch passes only
    ``min_weight`` and ``ensemble_size``)."""
    import cugraph_tpu_torch as ct

    random_state, graph = _graph_second(random_state, graph)
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_ecg

        labels, _ = mg_ecg(*_mg(graph), min_weight=min_weight,
                           ensemble_size=ensemble_size, max_level=max_level,
                           threshold=threshold, resolution=resolution,
                           seed=_seed(random_state))
        return _verts(graph), _full(graph, labels)
    parts = ct.ecg(_sg(graph), min_weight=min_weight,
                   ensemble_size=ensemble_size, max_level=max_level,
                   resolution=resolution, threshold=threshold,
                   random_state=_seed(random_state))
    if isinstance(parts, tuple):
        parts, _ = parts
    parts = parts.sort_values("vertex")
    return parts["vertex"].to_numpy(), parts["partition"].to_numpy()


def triangle_count(resource_handle, graph, start_list=None,
                   do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_triangle_count

        verts, t = _verts(graph), _full(graph, mg_triangle_count(
            *_mg(graph)))
        if start_list is not None:
            sel = np.asarray(start_list).reshape(-1)
            return verts[sel], t[sel]
        return verts, t
    df = ct.triangle_count(_sg(graph), start_list=start_list) \
        .sort_values("vertex")
    return df["vertex"].to_numpy(), df["counts"].to_numpy()


def _external_edges(H):
    """(src, dst, weight) of a result Graph in external ids; unit weights
    when it is unweighted."""
    src, dst, w = H.edgelist_arrays()
    return (H.number_map.to_external(src), H.number_map.to_external(dst),
            w if w is not None else np.ones(len(src), np.float32))


def k_truss_subgraph(resource_handle, graph, k, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_k_truss

        return mg_k_truss(*_mg(graph), k)
    return _external_edges(ct.ktruss_subgraph(_sg(graph), k))


def egonet(resource_handle, graph, source_vertices, radius,
           do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_egonet

        return mg_egonet(*_mg(graph), source_vertices, radius=radius)
    df, offsets = ct.batched_ego_graphs(_sg(graph), source_vertices, radius)
    return (df["src"].to_numpy(), df["dst"].to_numpy(),
            df["weight"].to_numpy() if "weight" in df else
            np.ones(len(df), np.float32), np.asarray(offsets))


def balanced_cut_clustering(resource_handle, graph, num_clusters,
                            num_eigenvectors=2, evs_tolerance=1e-5,
                            evs_max_iterations=100, kmean_tolerance=1e-5,
                            kmean_max_iterations=100,
                            do_expensive_check=False):
    import cugraph_tpu_torch as ct

    df = ct.spectralBalancedCutClustering(
        _sg(graph), num_clusters, num_eigen_vects=num_eigenvectors,
        evs_tolerance=evs_tolerance, evs_max_iter=evs_max_iterations,
        kmean_tolerance=kmean_tolerance, kmean_max_iter=kmean_max_iterations)
    df = df.sort_values("vertex")
    return df["vertex"].to_numpy(), df["cluster"].to_numpy()


def spectral_modularity_maximization(resource_handle, graph, num_clusters,
                                     num_eigenvectors=2, **kw):
    import cugraph_tpu_torch as ct

    df = ct.spectralModularityMaximizationClustering(
        _sg(graph), num_clusters, num_eigen_vects=num_eigenvectors)
    df = df.sort_values("vertex")
    return df["vertex"].to_numpy(), df["cluster"].to_numpy()


def _clustering_score(fn, graph, num_clusters, vertex, cluster):
    import pandas as pd

    df = pd.DataFrame({"vertex": np.asarray(vertex),
                       "cluster": np.asarray(cluster)})
    return float(fn(_sg(graph), num_clusters, df, "vertex", "cluster"))


def analyze_clustering_modularity(resource_handle, graph, num_clusters,
                                  vertex, cluster):
    import cugraph_tpu_torch as ct

    return _clustering_score(ct.analyzeClustering_modularity, graph,
                             num_clusters, vertex, cluster)


def analyze_clustering_edge_cut(resource_handle, graph, num_clusters, vertex,
                                cluster):
    import cugraph_tpu_torch as ct

    return _clustering_score(ct.analyzeClustering_edge_cut, graph,
                             num_clusters, vertex, cluster)


def analyze_clustering_ratio_cut(resource_handle, graph, num_clusters, vertex,
                                 cluster):
    import cugraph_tpu_torch as ct

    return _clustering_score(ct.analyzeClustering_ratio_cut, graph,
                             num_clusters, vertex, cluster)


# -- cores -------------------------------------------------------------------

def core_number(resource_handle, graph, degree_type="bidirectional",
                do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_core_number

        core = mg_core_number(*_mg(graph), degree_type=degree_type)
        return _verts(graph), _full(graph, core)
    df = ct.core_number(_sg(graph), degree_type=degree_type) \
        .sort_values("vertex")
    return df["vertex"].to_numpy(), df["core_number"].to_numpy()


def k_core(resource_handle, graph, k=None, degree_type="bidirectional",
           core_result=None, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_k_core

        src, dst, w, _ = mg_k_core(*_mg(graph), k=k, degree_type=degree_type)
        return src, dst, w
    core_df = None
    if core_result is not None:
        import pandas as pd

        if isinstance(core_result, tuple):
            core_df = pd.DataFrame({"vertex": np.asarray(core_result[0]),
                                    "core_number": np.asarray(core_result[1])})
        else:
            core_df = core_result
    return _external_edges(ct.k_core(_sg(graph), k=k, degree_type=degree_type,
                                     core_number_df=core_df))


# -- components --------------------------------------------------------------

def _legacy_csr_graph(resource_handle, offsets, indices, weights):
    """Legacy CSR-input path of the reference wcc/scc pyx (graph=None),
    built on the handle's device."""
    import cugraph_tpu_torch as ct

    offs = np.asarray(offsets)
    idx = np.asarray(indices)
    src = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    w = None if weights is None else np.asarray(weights)
    G = ct.Graph(directed=True, device=handle_device(resource_handle))
    G.from_edgelist(src, idx, w, vertices=np.arange(len(offs) - 1),
                    renumber=False)
    return G


def weakly_connected_components(resource_handle, graph, offsets=None,
                                indices=None, weights=None, labels=None,
                                do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if graph is None and offsets is not None:
        graph = _legacy_csr_graph(resource_handle, offsets, indices, weights)
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_wcc

        return _verts(graph), _full(graph, mg_wcc(*_mg(graph)))
    df = ct.weakly_connected_components(_sg(graph)).sort_values("vertex")
    return df["vertex"].to_numpy(), df["labels"].to_numpy()


def strongly_connected_components(resource_handle, graph, offsets=None,
                                  indices=None, weights=None, labels=None,
                                  do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if graph is None and offsets is not None:
        graph = _legacy_csr_graph(resource_handle, offsets, indices, weights)
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import \
            mg_strongly_connected_components

        return _verts(graph), _full(graph, mg_strongly_connected_components(
            *_mg(graph)))
    df = ct.strongly_connected_components(_sg(graph)).sort_values("vertex")
    return df["vertex"].to_numpy(), df["labels"].to_numpy()


# -- similarity --------------------------------------------------------------

def _sim(fn, graph, first, second, use_weight=False):
    import pandas as pd

    df = fn(_sg(graph), pd.DataFrame({"first": np.asarray(first),
                                      "second": np.asarray(second)}),
            use_weight=use_weight)
    col = [c for c in df.columns if c.endswith("_coeff")][0]
    return df["first"].to_numpy(), df["second"].to_numpy(), df[col].to_numpy()


def jaccard_coefficients(resource_handle, graph, first, second,
                         use_weight=False, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_jaccard_coefficients

        return _mg_sim(mg_jaccard_coefficients, graph, first, second)
    return _sim(ct.jaccard, graph, first, second, use_weight)


def sorensen_coefficients(resource_handle, graph, first, second,
                          use_weight=False, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_sorensen_coefficients

        return _mg_sim(mg_sorensen_coefficients, graph, first, second)
    return _sim(ct.sorensen, graph, first, second, use_weight)


def overlap_coefficients(resource_handle, graph, first, second,
                         use_weight=False, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_overlap_coefficients

        return _mg_sim(mg_overlap_coefficients, graph, first, second)
    return _sim(ct.overlap, graph, first, second, use_weight)


def cosine_coefficients(resource_handle, graph, first, second,
                        use_weight=False, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_cosine_coefficients

        return _mg_sim(mg_cosine_coefficients, graph, first, second)
    return _sim(ct.cosine, graph, first, second, use_weight)


def _mg_sim(mg_fn, graph, first, second):
    c = mg_fn(*_mg(graph), first, second)
    return np.asarray(first), np.asarray(second), np.asarray(c)


def _all_pairs(fn, graph, vertices, topk, kind):
    # use_weight is not forwarded, as in the JAX wrappers
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_all_pairs_similarity

        df = mg_all_pairs_similarity(*_mg(graph), kind=kind,
                                     vertices=vertices, topk=topk)
    else:
        df = fn(_sg(graph), vertices=vertices, topk=topk)
    col = [c for c in df.columns if c.endswith("_coeff")][0]
    return df["first"].to_numpy(), df["second"].to_numpy(), df[col].to_numpy()


def all_pairs_jaccard_coefficients(resource_handle, graph, vertices=None,
                                   use_weight=False, topk=None,
                                   do_expensive_check=False):
    import cugraph_tpu_torch as ct

    return _all_pairs(ct.all_pairs_jaccard, graph, vertices, topk,
                      "jaccard")


def all_pairs_sorensen_coefficients(resource_handle, graph, vertices=None,
                                    use_weight=False, topk=None,
                                    do_expensive_check=False):
    import cugraph_tpu_torch as ct

    return _all_pairs(ct.all_pairs_sorensen, graph, vertices, topk,
                      "sorensen")


def all_pairs_overlap_coefficients(resource_handle, graph, vertices=None,
                                   use_weight=False, topk=None,
                                   do_expensive_check=False):
    import cugraph_tpu_torch as ct

    return _all_pairs(ct.all_pairs_overlap, graph, vertices, topk,
                      "overlap")


def all_pairs_cosine_coefficients(resource_handle, graph, vertices=None,
                                  use_weight=False, topk=None,
                                  do_expensive_check=False):
    import cugraph_tpu_torch as ct

    return _all_pairs(ct.all_pairs_cosine, graph, vertices, topk,
                      "cosine")


# -- sampling / walks --------------------------------------------------------

def uniform_random_walks(resource_handle, graph, start_vertices, max_length,
                         random_state=None):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_uniform_random_walks

        return mg_uniform_random_walks(*_mg(graph), start_vertices,
                                       max_length, seed=_seed(random_state))
    return ct.uniform_random_walks(_sg(graph), start_vertices, max_length,
                                   random_state=_seed(random_state))


def biased_random_walks(resource_handle, graph, start_vertices, max_length,
                        random_state=None):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_biased_random_walks

        return mg_biased_random_walks(*_mg(graph), start_vertices,
                                      max_length, seed=_seed(random_state))
    return ct.biased_random_walks(_sg(graph), start_vertices, max_length,
                                  random_state=_seed(random_state))


def node2vec_random_walks(resource_handle, graph, start_vertices, max_length,
                          p=1.0, q=1.0, random_state=None):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_node2vec_random_walks

        return mg_node2vec_random_walks(*_mg(graph), start_vertices,
                                        max_length, p=p, q=q,
                                        seed=_seed(random_state))
    return ct.node2vec_random_walks(_sg(graph), start_vertices, max_length,
                                    p=p, q=q,
                                    random_state=_seed(random_state))


def uniform_neighbor_sample(resource_handle, graph, start_list, fanout_vals,
                            with_replacement=True, random_state=None, **kw):
    import cugraph_tpu_torch as ct

    # the other keywords are not forwarded, as in the JAX wrapper
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_uniform_neighbor_sample

        return mg_uniform_neighbor_sample(
            *_mg(graph), start_list, fanout_vals,
            with_replacement=with_replacement, seed=_seed(random_state))
    return ct.uniform_neighbor_sample(_sg(graph), start_list, fanout_vals,
                                      with_replacement=with_replacement,
                                      random_state=_seed(random_state))


def _fanout_compat(starting_vertex_label_offsets, h_fan_out):
    """Reference order is (..., starting_vertex_label_offsets, h_fan_out);
    legacy 4-positional calls passed the fanout in the offsets slot."""
    if h_fan_out is None:
        return None, starting_vertex_label_offsets
    return starting_vertex_label_offsets, h_fan_out


def _label_offsets_to_batches(offsets, start_list, kw):
    """starting_vertex_label_offsets → batch_id_list (the reference groups
    seeds into labels by CSR offsets, sampling_functions.hpp:512).
    Explicit batch_id_list wins when both are given."""
    if offsets is None or kw.get("batch_id_list") is not None:
        return kw
    off = np.asarray(offsets, np.int64).reshape(-1)
    n_seeds = len(np.asarray(start_list).reshape(-1))
    if len(off) < 2 or off[0] != 0 or off[-1] != n_seeds or \
            (np.diff(off) < 0).any():
        raise ValueError(
            f"starting_vertex_label_offsets must be a CSR over the "
            f"{n_seeds} start vertices (got {offsets!r})")
    kw = dict(kw)
    kw["batch_id_list"] = np.repeat(
        np.arange(len(off) - 1, dtype=np.int32), np.diff(off))
    return kw


def _engine_kw(kw):
    """The keywords the engines take: the OUTPUT-shaping ones dropped
    (``_finish_sample`` consumes them) and ``random_state`` resolved to an
    int, once per call."""
    out = {k: v for k, v in kw.items()
           if k not in ("renumber", "compression", "compress_per_hop",
                        "retain_seeds")}
    out["random_state"] = _seed(kw.get("random_state"))
    return out


def _mg_sample_kw(kw):
    """Map plc sampler kwargs onto the MG engine's knobs, including the
    reference sampling_flags_t fields (sampling_functions.hpp:36-76)."""
    out = {
        "with_replacement": bool(kw.get("with_replacement", False)),
        "seed": _seed(kw.get("random_state")),
    }
    for name in ("prior_sources_behavior", "dedupe_sources",
                 "deduplicate_sources", "return_hops",
                 "with_edge_properties", "batch_id_list",
                 "disjoint_sampling", "temporal_sampling_comparison"):
        if kw.get(name) is not None:
            out[name] = kw[name]
    return out


def _mg_attach_ids(graph, df, kw):
    """Attach sampled edge ids when the MGGraph carries an id table and the
    caller asked for edge properties (gather_sampled_properties.cuh role)."""
    if (kw.get("with_edge_properties")
            and graph._edge_id_table is not None and len(df)):
        df["edge_id"] = graph.lookup_edge_ids(df["sources"].to_numpy(),
                                              df["destinations"].to_numpy())
    return df


def _seed_time(kw):
    """The temporal branches' start time: a scalar as a float, an array of
    per-seed times as it is."""
    st = kw.get("seed_time", 0.0)
    return float(st) if np.ndim(st) == 0 else np.asarray(st, np.float32)


def _seeds_per_label(kw, start_list):
    seeds = np.asarray(start_list).reshape(-1)
    bl = kw.get("batch_id_list")
    if bl is None:
        bl = np.arange(len(seeds))
    out = {}
    for s, b in zip(seeds, np.asarray(bl).reshape(-1)):
        out.setdefault(int(b), []).append(int(s))
    return {b: np.asarray(v) for b, v in out.items()}


def _finish_sample(df, kw, start_list, vertex_type_offsets=None,
                   num_edge_types=None):
    """Apply the reference's sampler OUTPUT options (pyx:184-205):
    ``renumber=True`` renumbers per batch and compresses per ``compression``
    ("COO" default /"CSR"/"CSC"/"DCSR"/"DCSC") honoring ``compress_per_hop``;
    ``retain_seeds`` keeps outgoing-edge-less seeds in the renumber map.
    With ``vertex_type_offsets`` (the heterogeneous samplers) the renumber
    routes through heterogeneous_renumber_and_sort_sampled_edgelist —
    per-(label, vertex type) segmented maps, (label, edge type, hop) sorted
    COO (c_api/neighbor_sampling.cpp:579).
    Returns the plain frame when renumber is off (the default)."""
    if not kw.get("renumber"):
        return df
    import cugraph_tpu_torch as ct

    compression = str(kw.get("compression") or "COO").upper()
    if compression not in ("COO", "CSR", "CSC", "DCSR", "DCSC"):
        raise ValueError(f"unknown compression {compression!r}")
    seeds_per_label = None
    if kw.get("retain_seeds") and start_list is not None:
        seeds_per_label = _seeds_per_label(kw, start_list)
    src_is_major = compression not in ("CSC", "DCSC")
    if vertex_type_offsets is not None:
        # heterogeneous path: renumber+SORT only (the reference's C API
        # pairs vertex_type_offsets with the sort entry, not compression)
        if compression not in ("COO", "CSC"):
            raise ValueError(
                "heterogeneous renumbering (vertex_type_offsets) emits "
                "sorted COO only; use compression='COO' (src major) or "
                "'CSC' (dst major)")
        return ct.heterogeneous_renumber_and_sort_sampled_edgelist(
            df, vertex_type_offsets=vertex_type_offsets,
            num_edge_types=num_edge_types, src_is_major=src_is_major,
            seed_vertices_per_label=seeds_per_label)
    out = ct.renumber_and_compress_sampled_edgelist(
        df, src_is_major=src_is_major,
        compress_per_hop=bool(kw.get("compress_per_hop", False)),
        doubly_compress=compression in ("DCSR", "DCSC"),
        seed_vertices_per_label=seeds_per_label)
    if compression == "COO":
        # expand the offsets back to explicit renumbered majors (the
        # reference's COO mode returns majors alongside minors), and convert
        # label_hop_offsets from offset-array indices to EDGE indices so
        # minors[lho[i]:lho[i+1]] segments stay meaningful
        lho = out["label_hop_offsets"]
        majors, edge_lho = [], [0]
        for si in range(len(lho) - 1):
            offs = out["major_offsets"][lho[si]:lho[si + 1]]
            majors.append(np.repeat(np.arange(len(offs) - 1), np.diff(offs)))
            edge_lho.append(edge_lho[-1] + int(offs[-1] if len(offs) else 0))
        out["majors"] = (np.concatenate(majors) if majors
                         else np.zeros(0, np.int64))
        out["label_hop_offsets"] = np.asarray(edge_lho, np.int64)
        out["major_offsets"] = None
    return out


def _homogeneous(engine, mg_name, graph, start_list,
                 starting_vertex_label_offsets, h_fan_out, kw):
    offs, fanout_vals = _fanout_compat(starting_vertex_label_offsets,
                                       h_fan_out)
    kw = _label_offsets_to_batches(offs, start_list, kw)
    kw.setdefault("with_replacement", False)  # the reference's default
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import sampling_mg

        df = getattr(sampling_mg, mg_name)(*_mg(graph), start_list,
                                           fanout_vals, **_mg_sample_kw(kw))
        return _finish_sample(_mg_attach_ids(graph, df, kw), kw, start_list)
    return _finish_sample(engine(_sg(graph), start_list, fanout_vals,
                                 **_engine_kw(kw)), kw, start_list)


def homogeneous_uniform_neighbor_sample(resource_handle, graph, start_list,
                                        starting_vertex_label_offsets=None,
                                        h_fan_out=None, **kw):
    import cugraph_tpu_torch as ct

    return _homogeneous(ct.homogeneous_uniform_neighbor_sample,
                        "mg_uniform_neighbor_sample", graph, start_list,
                        starting_vertex_label_offsets, h_fan_out, kw)


def homogeneous_biased_neighbor_sample(resource_handle, graph, start_list,
                                       starting_vertex_label_offsets=None,
                                       h_fan_out=None, **kw):
    import cugraph_tpu_torch as ct

    return _homogeneous(ct.homogeneous_biased_neighbor_sample,
                        "mg_biased_neighbor_sample", graph, start_list,
                        starting_vertex_label_offsets, h_fan_out, kw)


def _heterogeneous(engine, biased, graph, start_list,
                   starting_vertex_label_offsets, vertex_type_offsets,
                   h_fan_out, num_edge_types, kw):
    """Reference positional order (heterogeneous_*.pyx:74): label/type
    offsets precede h_fan_out; legacy (start, fanout, num_edge_types)
    calls are detected by the missing h_fan_out."""
    if h_fan_out is None:
        h_fan_out = starting_vertex_label_offsets
        if num_edge_types is None:
            # legacy positional slot held num_edge_types; an EXPLICIT
            # keyword vertex_type_offsets alongside num_edge_types must
            # survive (it drives the heterogeneous renumber)
            num_edge_types = vertex_type_offsets
            vertex_type_offsets = None
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import \
            mg_heterogeneous_neighbor_sample

        return _finish_sample(mg_heterogeneous_neighbor_sample(
            *_mg(graph), start_list, h_fan_out,
            num_edge_types=num_edge_types, biased=biased,
            **_mg_sample_kw(kw)), kw, start_list, vertex_type_offsets,
            num_edge_types)
    return _finish_sample(engine(_sg(graph), start_list, h_fan_out,
                                 num_edge_types=num_edge_types,
                                 **_engine_kw(kw)),
                          kw, start_list, vertex_type_offsets,
                          num_edge_types)


def heterogeneous_uniform_neighbor_sample(resource_handle, graph, start_list,
                                          starting_vertex_label_offsets=None,
                                          vertex_type_offsets=None,
                                          h_fan_out=None, *,
                                          num_edge_types=None, **kw):
    import cugraph_tpu_torch as ct

    return _heterogeneous(ct.heterogeneous_uniform_neighbor_sample, False,
                          graph,
                          start_list, starting_vertex_label_offsets,
                          vertex_type_offsets, h_fan_out, num_edge_types, kw)


def heterogeneous_biased_neighbor_sample(resource_handle, graph, start_list,
                                         starting_vertex_label_offsets=None,
                                         vertex_type_offsets=None,
                                         h_fan_out=None, *,
                                         num_edge_types=None, **kw):
    import cugraph_tpu_torch as ct

    return _heterogeneous(ct.heterogeneous_biased_neighbor_sample, True,
                          graph,
                          start_list, starting_vertex_label_offsets,
                          vertex_type_offsets, h_fan_out, num_edge_types, kw)


def _temporal_compat(args, kw):
    """Reference order (homogeneous_uniform_temporal_*.pyx:76):
    (temporal_property_name, start_vertex_list, starting_vertex_start_times,
    starting_vertex_label_offsets, h_fan_out).  Legacy calls passed
    (start_list, fanout_vals[, num_edge_types], seed_time=...).  Detect by
    the leading string property name.  In both, the label offsets become
    ``batch_id_list`` as for the other samplers."""
    kw = dict(kw)
    offsets = kw.pop("starting_vertex_label_offsets", None)
    if args and isinstance(args[0], str):
        start_list = args[1]
        start_times = args[2] if len(args) > 2 else None
        if len(args) > 3:
            offsets = args[3]
        fanout = args[4] if len(args) > 4 else kw.pop("h_fan_out", None)
        if start_times is not None:
            # PER-SEED start times flow through whole (the engines
            # broadcast a scalar or take the aligned array)
            st = np.asarray(start_times, np.float32).reshape(-1)
            kw.setdefault("seed_time",
                          float(st[0]) if len(st) == 1 else st)
    else:
        start_list = args[0]
        fanout = args[1] if len(args) > 1 else kw.pop("h_fan_out", None)
        if len(args) > 2 and args[2] is not None:
            kw.setdefault("num_edge_types", args[2])
    return start_list, fanout, _label_offsets_to_batches(offsets, start_list,
                                                         kw)


def _temporal(engine, graph, args, kw, homogeneous, biased):
    start_list, fanout_vals, kw = _temporal_compat(args, kw)
    if homogeneous:
        kw.pop("num_edge_types", None)
    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import (
            mg_heterogeneous_temporal_neighbor_sample,
            mg_temporal_neighbor_sample)

        extra = ({} if homogeneous
                 else {"num_edge_types": kw.get("num_edge_types")})
        mg_engine = (mg_temporal_neighbor_sample if homogeneous
                     else mg_heterogeneous_temporal_neighbor_sample)
        return _finish_sample(mg_engine(
            *_mg(graph), start_list, fanout_vals, **extra,
            seed_time=_seed_time(kw), biased=biased,
            strict=bool(kw.get("strict", True)), **_mg_sample_kw(kw)),
            kw, start_list)
    return _finish_sample(engine(_sg(graph), start_list, fanout_vals,
                                 **_engine_kw(kw)), kw, start_list)


def homogeneous_uniform_temporal_neighbor_sample(resource_handle, graph,
                                                 *args, **kw):
    """Temporal variant (reference homogeneous_uniform_temporal_neighbor_
    sample.pyx / temporal_sampling_impl.cuh); accepts both the reference
    positional order and the legacy (start, fanout) form."""
    import cugraph_tpu_torch as ct

    return _temporal(ct.homogeneous_uniform_temporal_neighbor_sample, graph,
                     args, kw, True, False)


def homogeneous_biased_temporal_neighbor_sample(resource_handle, graph,
                                                *args, **kw):
    import cugraph_tpu_torch as ct

    return _temporal(ct.homogeneous_biased_temporal_neighbor_sample, graph,
                     args, kw, True, True)


def heterogeneous_uniform_temporal_neighbor_sample(resource_handle, graph,
                                                   *args, **kw):
    import cugraph_tpu_torch as ct

    return _temporal(ct.heterogeneous_uniform_temporal_neighbor_sample,
                     graph, args, kw, False, False)


def heterogeneous_biased_temporal_neighbor_sample(resource_handle, graph,
                                                  *args, **kw):
    import cugraph_tpu_torch as ct

    return _temporal(ct.heterogeneous_biased_temporal_neighbor_sample,
                     graph, args, kw, False, True)


def negative_sampling(resource_handle, graph, num_samples, random_state=None,
                      vertices=None, src_bias=None, dst_bias=None,
                      remove_duplicates=True, remove_false_negatives=True,
                      exact_number_of_samples=False, do_expensive_check=False):
    """Reference positional order (negative_sampling.pyx:57):
    random_state fourth, then vertices/biases."""
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_negative_sampling

        df = mg_negative_sampling(
            *_mg(graph), num_samples, seed=_seed(random_state),
            remove_duplicates=remove_duplicates,
            remove_existing_edges=remove_false_negatives,
            src_bias=src_bias, dst_bias=dst_bias, vertices=vertices,
            exact_number_of_samples=exact_number_of_samples)
        return df["src"].to_numpy(), df["dst"].to_numpy()
    df = ct.negative_sampling(_sg(graph), num_samples, vertices=vertices,
                              src_bias=src_bias, dst_bias=dst_bias,
                              remove_duplicates=remove_duplicates,
                              remove_existing_edges=remove_false_negatives,
                              exact_number_of_samples=exact_number_of_samples,
                              random_state=_seed(random_state))
    return df["src"].to_numpy(), df["dst"].to_numpy()


# -- generators --------------------------------------------------------------

def generate_rmat_edgelist(resource_handle, random_state, scale, num_edges,
                           a=0.57, b=0.19, c=0.19, clip_and_flip=False,
                           scramble_vertex_ids=False,
                           include_edge_weights=False,
                           minimum_weight=0.0, maximum_weight=1.0, dtype=None,
                           include_edge_ids=False, include_edge_types=False,
                           min_edge_type_value=0, max_edge_type_value=0,
                           multi_gpu=False):
    """The native counter-RNG R-MAT on the host; the type column from
    ``default_rng(seed + 7)``.  A state is resolved once, so the types
    come from the edges' seed (the JAX wrapper draws a second seed from a
    state for them)."""
    import cugraph_tpu_torch as ct

    seed = _seed(random_state)
    df = ct.rmat(scale, num_edges, a, b, c, seed=seed,
                 clip_and_flip=clip_and_flip,
                 scramble_vertex_ids=scramble_vertex_ids,
                 include_edge_weights=include_edge_weights,
                 minimum_weight=minimum_weight, maximum_weight=maximum_weight)
    out = [df["src"].to_numpy(), df["dst"].to_numpy()]
    if include_edge_weights:
        w = df["weights"].to_numpy()
        out.append(w.astype(dtype) if dtype is not None else w)
    if include_edge_ids:
        out.append(np.arange(len(df), dtype=np.int64))
    if include_edge_types:
        rng_t = np.random.default_rng(seed + 7)
        out.append(rng_t.integers(min_edge_type_value,
                                  max(max_edge_type_value,
                                      min_edge_type_value) + 1,
                                  len(df)).astype(np.int32))
    return tuple(out)


def generate_rmat_edgelists(resource_handle, random_state, n_edgelists,
                            min_scale, max_scale, edge_factor=16, **kw):
    from cugraph_tpu_torch.generators.rmat import \
        generate_rmat_edgelists as gen

    return gen(n_edgelists, min_scale, max_scale, edge_factor=edge_factor,
               seed=_seed(random_state))


# -- structure / misc --------------------------------------------------------

def two_hop_neighbors(resource_handle, graph, start_vertices=None,
                      do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_two_hop_neighbors

        return mg_two_hop_neighbors(*_mg(graph),
                                    start_vertices=start_vertices)
    df = ct.two_hop_neighbors(_sg(graph))
    if start_vertices is not None:
        # pairs FROM the given starts only, as get_two_hop_neighbors
        sel = np.isin(df["first"].to_numpy(),
                      np.asarray(start_vertices).reshape(-1))
        df = df[sel]
    return df["first"].to_numpy(), df["second"].to_numpy()


def _mg_edges_host(graph):
    """The MG graph's whole COO (src, dst, weight) on the host, the same
    on every rank (``partition.gathered_coo``)."""
    from cugraph_tpu_torch.parallel.partition import gathered_coo

    return gathered_coo(*_mg(graph))


def _mg_degree_arrays(graph):
    # edge COUNTS (the plc degrees contract): DistGraph.in/out_degree hold
    # WEIGHT sums (the pagerank normalizer); count from the gathered COO
    n = graph.graph().num_vertices
    src, dst, _ = _mg_edges_host(graph)
    return (_verts(graph),
            np.bincount(dst, minlength=n)[:n].astype(np.int64),
            np.bincount(src, minlength=n)[:n].astype(np.int64))


def _subset_deg(verts, deg, source_vertices):
    if source_vertices is None:
        return verts, deg
    sel = np.asarray(source_vertices).reshape(-1)
    return verts[sel], deg[sel]


def degrees(resource_handle, graph, source_vertices=None,
            do_expensive_check=False):
    if isinstance(graph, MGGraph):
        verts, din, dout = _mg_degree_arrays(graph)
        v1, din = _subset_deg(verts, din, source_vertices)
        _, dout = _subset_deg(verts, dout, source_vertices)
        return v1, din, dout
    df = _sg(graph).degrees(vertex_subset=source_vertices) \
        .sort_values("vertex")
    return (df["vertex"].to_numpy(), df["in_degree"].to_numpy(),
            df["out_degree"].to_numpy())


def in_degrees(resource_handle, graph, source_vertices=None, **kw):
    if isinstance(graph, MGGraph):
        verts, din, _ = _mg_degree_arrays(graph)
        return _subset_deg(verts, din, source_vertices)
    df = _sg(graph).in_degree(source_vertices).sort_values("vertex")
    return df["vertex"].to_numpy(), df["degree"].to_numpy()


def out_degrees(resource_handle, graph, source_vertices=None, **kw):
    if isinstance(graph, MGGraph):
        verts, _, dout = _mg_degree_arrays(graph)
        return _subset_deg(verts, dout, source_vertices)
    df = _sg(graph).out_degree(source_vertices).sort_values("vertex")
    return df["vertex"].to_numpy(), df["degree"].to_numpy()


def select_random_vertices(resource_handle, graph, random_state, num_vertices):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        n = graph.graph().num_vertices
        rng = np.random.default_rng(_seed(random_state))
        return rng.choice(n, size=min(int(num_vertices), n), replace=False)
    return ct.select_random_vertices(_sg(graph), num_vertices,
                                     random_state=_seed(random_state))


def replicate_edgelist(resource_handle, src_array=None, dst_array=None,
                       weight_array=None, graph=None, **kw):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        src, dst, _ = _mg_edges_host(graph)
        return src, dst
    if graph is not None:
        df = ct.replicate_edgelist(_sg(graph))
        return df["src"].to_numpy(), df["dst"].to_numpy()
    if weight_array is not None:
        return (np.asarray(src_array), np.asarray(dst_array),
                np.asarray(weight_array))
    return np.asarray(src_array), np.asarray(dst_array)


def decompress_to_edgelist(resource_handle, graph, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        return _mg_edges_host(graph)
    df = ct.decompress_to_edgelist(_sg(graph))
    out = [df["src"].to_numpy(), df["dst"].to_numpy()]
    if "weight" in df:
        out.append(df["weight"].to_numpy())
    return tuple(out)


def extract_vertex_list(resource_handle, graph, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        return np.arange(graph.graph().num_vertices, dtype=np.int64)
    return ct.extract_vertex_list(_sg(graph))


def has_vertex(resource_handle, graph, vertices):
    if isinstance(graph, MGGraph):
        v = np.asarray(vertices).reshape(-1)
        nmap = getattr(graph, "number_map", None)
        if nmap is not None:          # sharded build: EXTERNAL id space
            return nmap.contains(v)
        return (v >= 0) & (v < graph.graph().num_vertices)
    G = _sg(graph)
    return np.array([G.has_vertex(v)
                     for v in np.asarray(vertices).reshape(-1)])


def count_multi_edges(resource_handle, graph, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        src, dst, _ = _mg_edges_host(graph)
        keys = src.astype(np.int64) * np.int64(graph.graph().pad_v) + dst
        _, counts = np.unique(keys, return_counts=True)
        return int((counts - 1).sum())
    return ct.count_multi_edges(_sg(graph))


def renumber_arbitrary_edgelist(resource_handle, renumber_map, src_array,
                                dst_array):
    """Ids become POSITIONS in the caller-supplied renumber_map
    (pylibcugraph renumber_arbitrary_edgelist.pyx contract)."""
    rmap = np.asarray(renumber_map)
    order = np.argsort(rmap, kind="stable")
    sorted_map = rmap[order]

    def to_pos(a):
        a = np.asarray(a)
        pos = np.searchsorted(sorted_map, a)
        pos = np.clip(pos, 0, max(len(sorted_map) - 1, 0))
        if len(sorted_map) == 0 or not np.all(sorted_map[pos] == a):
            raise ValueError("edge endpoint not present in renumber_map")
        return order[pos].astype(np.int32)

    return to_pos(src_array), to_pos(dst_array)


def minimum_spanning_tree(resource_handle, graph, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    T = ct.minimum_spanning_tree(_sg(graph))
    src, dst, w = T._src, T._dst, T._weight
    return (T.number_map.to_external(src), T.number_map.to_external(dst),
            w if w is not None else np.ones(len(src), np.float32))


def induced_subgraph(resource_handle, graph, subgraph_vertices,
                     subgraph_offsets=None, do_expensive_check=False):
    import cugraph_tpu_torch as ct

    def weights(df):
        return (df["weight"].to_numpy(np.float32) if "weight" in df.columns
                else np.ones(len(df), np.float32))

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_induced_subgraph

        src, dst, w = mg_induced_subgraph(*_mg(graph), subgraph_vertices)
        return src, dst, w, np.asarray([0, len(src)])
    if subgraph_offsets is not None and len(subgraph_offsets) > 2:
        # multiple induced subgraphs in one call (induced_subgraph.pyx):
        # offsets delimit vertex groups; results concatenate with edge
        # offsets per group
        so = np.asarray(subgraph_offsets)
        sv = np.asarray(subgraph_vertices)
        srcs, dsts, ws, eoff = [], [], [], [0]
        for gi in range(len(so) - 1):
            df, _ = ct.induced_subgraph(_sg(graph), sv[so[gi]:so[gi + 1]])
            srcs.append(df["src"].to_numpy())
            dsts.append(df["dst"].to_numpy())
            ws.append(weights(df))
            eoff.append(eoff[-1] + len(df))
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(ws), np.asarray(eoff))
    df, offsets = ct.induced_subgraph(_sg(graph), subgraph_vertices)
    return (df["src"].to_numpy(), df["dst"].to_numpy(), weights(df),
            np.asarray(offsets))


def force_atlas2(resource_handle, graph, max_iter=500, **kw):
    import cugraph_tpu_torch as ct

    df = ct.force_atlas2(_sg(graph), max_iter=max_iter, **kw)
    df = df.sort_values("vertex")
    return df["vertex"].to_numpy(), df["x"].to_numpy(), df["y"].to_numpy()


def edge_id_lookup_table(resource_handle, graph):
    """pylibcugraph.EdgeIdLookupTable (edge_id_lookup_table.pyx:49).  MG
    graphs get the distributed id-hash-sharded container
    (lookup/lookup_src_dst_mg.cu analog, parallel/lookup.py)."""
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel.lookup import MGEdgeIdLookupTable

        return MGEdgeIdLookupTable(graph)
    return ct.edge_id_lookup_table(_sg(graph))


def ego_graph(resource_handle, graph, source_vertices, radius,
              do_expensive_check=False):
    """pylibcugraph.ego_graph (egonet.pyx:50) — induced subgraphs within
    ``radius`` of each source.  Returns (srcs, dsts, weights, offsets)."""
    return egonet(resource_handle, graph, source_vertices, radius,
                  do_expensive_check)


def get_two_hop_neighbors(resource_handle, graph, start_vertices,
                          do_expensive_check=False):
    """pylibcugraph.get_two_hop_neighbors (two_hop_neighbors.pyx:45).
    Returns (first, second) sorted vertex-pair arrays two hops apart."""
    import cugraph_tpu_torch as ct

    if isinstance(graph, MGGraph):
        from cugraph_tpu_torch.parallel import mg_two_hop_neighbors

        return mg_two_hop_neighbors(*_mg(graph),
                                    start_vertices=start_vertices)
    df = ct.two_hop_neighbors(_sg(graph))
    if start_vertices is not None:
        sv = set(np.asarray(start_vertices).tolist())
        df = df[df["first"].isin(sv)]
    df = df.sort_values(["first", "second"])
    return df["first"].to_numpy(), df["second"].to_numpy()


class CuGraphRandomState:
    """pylibcugraph.CuGraphRandomState (random.pyx:53): a reusable RNG state
    for the random entry points.  Each use advances a count; ``next_seed``
    gives (seed · 1,000,003 + uses) mod 2^31, the int the wrappers feed the
    engines, and ``next_key`` a ``torch.Generator`` on the handle's device
    seeded with the same mix (where the JAX package folds the count into a
    JAX key)."""

    def __init__(self, resource_handle, seed=None):
        self._seed0 = 0 if seed is None else int(seed)
        self._uses = 0
        self._handle = resource_handle

    def next_key(self):
        import torch

        g = torch.Generator(device=handle_device(self._handle))
        g.manual_seed(self.next_seed())
        return g

    def next_seed(self) -> int:
        """An int seed derived from (seed, use count)."""
        self._uses += 1
        return (self._seed0 * 1_000_003 + self._uses) % (2**31)
