"""Community detection: Louvain, Leiden, ECG and the clustering scores;
triangles and k-truss, egonets, spectral clustering and the approximate
weighted matching.

Counterpart of ``cugraph_tpu.algos.community`` (reference
louvain_impl.cuh:339, leiden_impl.cuh:694, ecg_impl.cuh:148,
triangle_count_impl.cuh:124, k_truss_impl.cuh:166, egonet_impl.cuh:212,
legacy/spectral_clustering.cu, approx_weighted_matching_impl.cuh:372).
The JAX package runs Louvain and Leiden on its native host engines
whenever g++ is present (community.py:122-168,208-236,360-384,481-509),
and so does the port: the local-moving sweep, the Leiden refinement sweep
and the cluster contraction are the threaded C++ of
``core/_native/builder.cpp``, the level loop, its float64 modularity and
ECG's votes are NumPy.  Triangles and k-truss run the native wedge engine
(``algos/_oriented_tri.py``) over unique pairs sorted on the graph's
device; spectral clustering is scipy and NumPy on the host, as in the JAX
package.  Egonets run the port's BFS (K2 (max, left) on its dense levels)
and build their edge masks on the device; the matching's locally-dominant
rounds run on the device as torch scatters.

Unlike the JAX package, a failed build or a nonzero return of an engine
raises: there is no fallback to the XLA sweeps or the NumPy wedge loop.
``_louvain_move_sweep_torch`` (the JAX package's jitted sweep in torch),
``_coarsen_numpy`` (its NumPy contraction) and
``_approx_weighted_matching_serial`` (its serial matching loop) stay as
plain versions for the tests; none is a route.  The JAX package's XLA
refinement sweep draws with ``jax.random`` and is not ported: Leiden's
draws come from the native counter RNG, keyed per level by
``level_seed``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos import _oriented_tri
from cugraph_tpu_torch.algos._utils import vertex_frame
from cugraph_tpu_torch.core import native
from cugraph_tpu_torch.core.preprocess import unique_by_sort


# -- Louvain ------------------------------------------------------------------

def _modularity(src, dst, w, cluster, resolution, n):
    """Modularity of ``cluster`` in float64 on the host (the JAX package's
    ``_modularity`` formula, which it evaluates in float32): w already
    carries the doubled-self-loop convention."""
    w64 = np.asarray(w, np.float64)
    cl = np.asarray(cluster)
    m2 = max(w64.sum(), 1e-30)
    intra = w64[cl[src] == cl[dst]].sum()
    k = np.bincount(src, weights=w64, minlength=n)
    sigma = np.bincount(cl, weights=k, minlength=n)
    return float(intra / m2 - resolution * np.sum((sigma / m2) ** 2))


def _louvain_one_level(src, dst, w, n, resolution, max_sweeps=20,
                       threshold=1e-7, init=None):
    """Local moving until a sweep stops improving modularity (JAX
    ``_louvain_one_level_native``): the native sweeps over the graph sorted
    by source, which ``coarsen_edges`` with identity labels gives while
    merging parallel edges; modularity in float64 NumPy; the up/down
    alternation; a sweep is kept only if it improves modularity by more
    than ``threshold``.  ``init`` seeds the assignment (Leiden's levels).
    Returns (cluster int32 [n], modularity)."""
    cluster = (np.arange(n, dtype=np.int32) if init is None
               else np.asarray(init, np.int32).copy())
    if n == 0 or len(src) == 0:
        return cluster, 0.0
    src, dst, w = native.coarsen_edges_native(
        np.asarray(src, np.int32), np.asarray(dst, np.int32),
        np.asarray(w, np.float32), n)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_off[1:])

    w64 = w.astype(np.float64)
    m2 = max(w64.sum(), 1e-30)
    k = np.bincount(src, weights=w64, minlength=n)

    def modularity(cl):
        intra = w64[cl[src] == cl[dst]].sum()
        sigma = np.bincount(cl, weights=k, minlength=n)
        return intra / m2 - resolution * np.sum((sigma / m2) ** 2)

    best_q = modularity(cluster)
    up_down = True
    for sweep in range(max_sweeps):
        cluster2 = native.louvain_sweep_native(dst, w, row_off, cluster,
                                               up_down, resolution)
        q2 = modularity(cluster2)
        up_down = not up_down
        if q2 > best_q + threshold:
            best_q, cluster = q2, cluster2
        elif sweep >= 1:
            break
    return cluster, float(best_q)


def _compact_labels(labels):
    """Dense ids in label order for the labels present: (compact int32
    [n], the number of clusters)."""
    labels = np.asarray(labels)
    n_lab = int(labels.max()) + 1 if len(labels) else 0
    present = np.bincount(labels, minlength=n_lab) > 0
    remap = np.cumsum(present) - 1
    nc = int(remap[-1]) + 1 if n_lab else 0
    return remap[labels].astype(np.int32), nc


def _coarsen(src, dst, w, labels):
    """Contract clusters (reference coarsen_graph): the edges relabelled
    to compact cluster ids, parallel edges merged by the native counting
    sorts.  Returns (src, dst, w, nc, compact)."""
    compact, nc = _compact_labels(labels)
    osrc, odst, ow = native.coarsen_edges_native(compact[src], compact[dst],
                                                 w, nc)
    return osrc, odst, ow, nc, compact


def _coarsen_numpy(src, dst, w, labels):
    """Plain version of ``_coarsen``: the JAX package's NumPy key sort
    (community.py:230-236)."""
    compact, nc = _compact_labels(labels)
    cs = compact[src]
    cd = compact[dst]
    key = cs.astype(np.int64) * nc + cd
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    w_s = w[order]
    uk, start = np.unique(key_s, return_index=True)
    wagg = np.add.reduceat(w_s, start)
    return (uk // nc).astype(np.int32), (uk % nc).astype(np.int32), \
        wagg.astype(np.float32), nc, compact


def _loop_doubled_weights(src, dst, w):
    """float32 weights (1.0 when unweighted) with every self-loop doubled,
    so that k_v = the weights summed by source is exact."""
    w = np.ones(len(src), np.float32) if w is None else w.astype(np.float32)
    return np.where(src == dst, 2.0 * w, w)


def _louvain_levels(G, max_level, resolution, threshold):
    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    w = _loop_doubled_weights(src, dst, w)

    labels = np.arange(n, dtype=np.int32)   # fine-level assignment
    q_prev = -np.inf
    q = -np.inf
    for level in range(max_level):
        lab, q = _louvain_one_level(src, dst, w, n, resolution,
                                    threshold=threshold)
        src, dst, w, n, compact = _coarsen(src, dst, w, lab)
        # labels: original vertex -> current-level vertex; compact maps
        # current-level vertex -> coarse vertex
        labels = compact[labels]
        if q <= q_prev + threshold:
            break
        q_prev = q
    return labels, float(q)


def louvain(G, max_level: int = 100, max_iter=None, resolution: float = 1.0,
            threshold: float = 1e-7):
    """Louvain community detection (reference louvain_impl.cuh:339).
    Returns (DataFrame ['vertex', 'partition'], modularity)."""
    if G.is_directed():
        raise ValueError("louvain requires an undirected graph")
    if max_iter is not None:
        max_level = max_iter
    labels, q = _louvain_levels(G, max_level, resolution, threshold)
    _, compact = np.unique(labels, return_inverse=True)
    df = vertex_frame(G, {"partition": compact.astype(np.int32)})
    return df, q


def _segment_sum(values, ids, n):
    """Sums of ``values`` by ``ids`` in [0, n), in a fixed order on any
    device: a stable sort by id, then one segment per id."""
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=n)
    return torch.segment_reduce(values[order], "sum", lengths=lengths)


def _louvain_move_sweep_torch(src, dst, w, cluster, up_down: bool,
                              resolution: float, n: int):
    """Plain version: the JAX package's jitted local-moving sweep
    (community.py:40-97) in torch on any device, float32, over an unpadded
    COO (src, dst, w) of ``n`` vertices: edges grouped by (src,
    cluster[dst]) with a sort and run boundaries, gains from segment sums,
    the up/down filter, the smallest cluster id among the best gains, a
    move only past the stay value + 1e-9.  Sums run in a fixed order (no
    atomics).  Returns the new cluster tensor (int64 [n])."""
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    w = w.to(torch.float32)
    cluster = cluster.to(torch.int64)
    m2 = torch.clamp(w.sum(), min=1e-30)
    k = _segment_sum(w, src, n)
    sigma = _segment_sum(k, cluster, n)

    cd = cluster[dst]
    order = torch.sort(src * n + cd, stable=True).indices
    s_s, cd_s, d_s, w_s = src[order], cd[order], dst[order], w[order]
    first = torch.ones_like(s_s, dtype=torch.bool)
    first[1:] = (s_s[1:] != s_s[:-1]) | (cd_s[1:] != cd_s[:-1])
    starts = torch.nonzero(first).flatten()
    lengths = torch.diff(starts, append=starts.new_tensor([len(s_s)]))
    w_vc = torch.where(s_s == d_s, 0.0, w_s)  # self-loops excluded
    W = torch.segment_reduce(w_vc, "sum", lengths=lengths)
    run_v, run_c = s_s[starts], cd_s[starts]

    kv = k[run_v]
    cur = cluster[run_v]
    sig_adj = sigma[run_c] - torch.where(run_c == cur, kv, 0.0)
    gain = W - resolution * kv * sig_adj / m2
    # the stay value: W of the vertex's own-cluster run (0 if none); runs
    # are sorted by vertex, one own-cluster run at most per vertex
    w_stay = torch.segment_reduce(torch.where(run_c == cur, W, 0.0), "sum",
                                  lengths=torch.bincount(run_v, minlength=n))
    f_stay = w_stay - resolution * k * (sigma[cluster] - k) / m2

    cand = (run_c > cur) if up_down else (run_c < cur)
    g_m = torch.where(cand, gain, torch.tensor(-1e30, dtype=torch.float32,
                                               device=gain.device))
    best_gain = torch.full((n,), -float("inf"), dtype=torch.float32,
                           device=w.device).scatter_reduce_(
        0, run_v, g_m, "amax")
    is_best = cand & (g_m >= best_gain[run_v])
    big = 2 ** 30
    best_c = torch.full((n,), big, dtype=torch.int64,
                        device=w.device).scatter_reduce_(
        0, run_v, torch.where(is_best, run_c, big), "amin")
    improve = (best_gain > f_stay + 1e-9) & (best_c < big)
    return torch.where(improve, best_c, cluster)


# -- Leiden -------------------------------------------------------------------

def level_seed(random_state, level: int) -> int:
    """The native refinement sweeps' seed for one level of ``leiden``: a
    32-bit value, a splitmix64 mix of (random_state, level).  The JAX
    package takes the last word of ``fold_in(key(random_state), level)``
    instead; the tests put that derivation here to compare partitions bit
    for bit."""
    mask = 2**64 - 1
    rs = 0 if random_state is None else int(random_state)
    z = (rs * 0x9E3779B97F4A7C15 + level + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def _leiden_refine(src, dst, w, n, comm, resolution, theta, seed,
                   sweeps: int = 4):
    """Randomized refinement of ``comm`` (community per vertex, [n]) by
    ``sweeps`` native sweeps, sweep i keyed by seed * 0x9E3779B97F4A7C15 + i
    (JAX ``_leiden_refine``'s native branch).  Returns the refined
    sub-community labels, int32 [n], each a vertex id."""
    refined = np.arange(n, dtype=np.int32)
    if n == 0 or len(src) == 0:
        return refined
    order = np.argsort(src, kind="stable")
    ds = np.ascontiguousarray(np.asarray(dst)[order], np.int32)
    dw = np.ascontiguousarray(np.asarray(w, np.float32)[order])
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_off[1:])
    comm32 = np.asarray(comm, np.int32)
    for i in range(sweeps):
        refined = native.leiden_refine_sweep_native(
            ds, dw, row_off, comm32, refined, theta, resolution,
            seed * 0x9E3779B97F4A7C15 + i)
    return refined


def leiden(G, max_iter: int = 100, resolution: float = 1.0,
           random_state=None, theta: float = 1.0):
    """Leiden (reference leiden_impl.cuh:694): per level, Louvain local
    moving, the randomized refinement, then contraction by the refined
    partition with the next level seeded from the parent communities; a
    final connected-components split makes every community connected.
    Returns (DataFrame ['vertex', 'partition'], modularity in float64)."""
    if G.is_directed():
        raise ValueError("leiden requires an undirected graph")
    src0, dst0, w0 = G.edgelist_arrays()
    n0 = G.number_of_vertices()
    src, dst = src0, dst0
    w = _loop_doubled_weights(src, dst, w0)
    n = n0

    vmap = np.arange(n0, dtype=np.int32)   # original -> current-level vertex
    comm_init = None
    best_labels = np.arange(n0, dtype=np.int64)
    q_prev = -np.inf
    for level in range(max_iter):
        lab, q = _louvain_one_level(src, dst, w, n, resolution,
                                    init=comm_init)
        if q <= q_prev + 1e-7 and level > 0:
            break
        q_prev = q
        best_labels = lab.astype(np.int64)[vmap]
        refined = _leiden_refine(src, dst, w, n, lab, resolution, theta,
                                 level_seed(random_state, level))
        src, dst, w, n, compact = _coarsen(src, dst, w, refined)
        # parent community of each coarse vertex (all members share lab)
        comm_coarse = np.zeros(n, np.int64)
        comm_coarse[compact] = lab
        _, comm_init = np.unique(comm_coarse, return_inverse=True)
        vmap = compact[vmap]
        if n <= 1:
            break

    # the Leiden guarantee, enforced exactly: split disconnected communities
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    keep = best_labels[src0] == best_labels[dst0]
    A = sp.csr_matrix((np.ones(int(keep.sum())), (src0[keep], dst0[keep])),
                      shape=(n0, n0))
    _, cc = csgraph.connected_components(A, directed=False)
    _, compact_f = np.unique(cc, return_inverse=True)
    df = vertex_frame(G, {"partition": compact_f.astype(np.int32)})
    q = _modularity(src0, dst0, _loop_doubled_weights(src0, dst0, w0),
                    compact_f, resolution, n0)
    return df, q


# -- ECG ----------------------------------------------------------------------

def ecg(G, min_weight: float = 0.05, ensemble_size: int = 16,
        max_level: int = 10, resolution: float = 1.0, threshold: float = 1e-7,
        random_state: int = 0):
    """Ensemble Clustering for Graphs (reference ecg_impl.cuh:148):
    ``ensemble_size`` two-sweep one-level Louvains, each over the same
    aggregated graph with a random id rank (the ensemble's vertex
    permutation) drawn from ``np.random.default_rng(random_state)``, the
    edges reweighted by how often their ends share a cluster, then a full
    Louvain on the reweighted graph.  Returns (DataFrame ['vertex',
    'partition'], that Louvain's modularity on the reweighted graph)."""
    if G.is_directed():
        raise ValueError("ecg requires an undirected graph")
    from cugraph_tpu_torch.api.graph import Graph

    src, dst, w0 = G.edgelist_arrays()
    n = G.number_of_vertices()
    w = np.ones(len(src), np.float32) if w0 is None else w0.astype(np.float32)
    rng = np.random.default_rng(random_state)
    votes = np.zeros(len(src), np.float64)
    if len(src):
        agg_s, agg_d, agg_w = native.coarsen_edges_native(
            src.astype(np.int32), dst.astype(np.int32), w, n)
        row_off = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(agg_s, minlength=n), out=row_off[1:])
        for _ in range(ensemble_size):
            rank = rng.permutation(n).astype(np.int32)
            cluster = np.arange(n, dtype=np.int32)
            for up_down in (True, False):
                cluster = native.louvain_sweep_native(
                    agg_d, agg_w, row_off, cluster, up_down, resolution,
                    rank=rank)
            votes += (cluster[src] == cluster[dst])
    new_w = min_weight + (1.0 - min_weight) * (votes / ensemble_size)
    new_w = new_w.astype(np.float32)
    ext_s = G.number_map.to_external(src)
    ext_d = G.number_map.to_external(dst)
    G2 = Graph(device=G.device).from_edgelist(ext_s, ext_d, new_w)
    return louvain(G2, max_level=max_level, resolution=resolution,
                   threshold=threshold)


# -- clustering scores --------------------------------------------------------

def _cluster_arrays(G, df):
    n = G.number_of_vertices()
    internal = G.lookup_internal_vertex_id(df["vertex"].to_numpy())
    lab = np.zeros(n, np.int64)
    col = "cluster" if "cluster" in df.columns else "partition"
    lab[internal] = df[col].to_numpy()
    return lab


def analyzeClustering_modularity(G, n_clusters, df, vertex_col_name="vertex",
                                 cluster_col_name=None):
    """Modularity of a clustering, in float64 (the JAX package evaluates
    the same formula in float32)."""
    src, dst, w = G.edgelist_arrays()
    return _modularity(src, dst, _loop_doubled_weights(src, dst, w),
                       _cluster_arrays(G, df), 1.0,
                       G.number_of_vertices())


def analyzeClustering_edge_cut(G, n_clusters, df, vertex_col_name="vertex",
                               cluster_col_name=None):
    src, dst, w = G.edgelist_arrays()
    w = np.ones(len(src)) if w is None else w
    lab = _cluster_arrays(G, df)
    return float(np.sum(np.where(lab[src] != lab[dst], w, 0.0))) / 2.0


def analyzeClustering_ratio_cut(G, n_clusters, df, vertex_col_name="vertex",
                                cluster_col_name=None):
    src, dst, w = G.edgelist_arrays()
    w = np.ones(len(src)) if w is None else w
    lab = _cluster_arrays(G, df)
    total = 0.0
    for c in np.unique(lab):
        size = int((lab == c).sum())
        if size == 0:
            continue
        cut_c = float(np.sum(np.where((lab[src] == c) != (lab[dst] == c),
                                      w, 0.0))) / 2.0
        total += cut_c / size
    return total


# -- triangles and k-truss ----------------------------------------------------

def _edge_triangle_counts(G):
    """Per-directed-edge triangle support on the symmetrized edge list,
    by the degree-oriented wedge engine (``algos/_oriented_tri.py``)."""
    src, dst, _ = G.edgelist_arrays()
    _, counts = _oriented_tri.directed_edge_support(
        src, dst, G.number_of_vertices(), G.device)
    return src, dst, counts


def triangle_count(G, start_list=None):
    """Per-vertex triangle counts (reference triangle_count_impl.cuh:124,
    degree-oriented wedge enumeration).  Returns ['vertex', 'counts']."""
    if G.is_directed():
        raise ValueError("triangle_count requires an undirected graph")
    src, dst, _ = G.edgelist_arrays()
    n = G.number_of_vertices()
    per_v = _oriented_tri.directed_vertex_counts(src, dst, n, G.device)
    df = vertex_frame(G, {"counts": per_v[:n]})
    if start_list is not None:
        wanted = set(np.atleast_1d(np.asarray(start_list)).tolist())
        df = df[df["vertex"].isin(wanted)].reset_index(drop=True)
    return df


def edge_triangle_count(G) -> pd.DataFrame:
    """Per-edge triangle counts over the (symmetrized) edge list
    (reference community/edge_triangle_count_impl.cuh).  Returns
    ['src', 'dst', 'counts']."""
    src, dst, counts = _edge_triangle_counts(G)
    nm = G.number_map
    return pd.DataFrame({"src": nm.to_external(src),
                         "dst": nm.to_external(dst),
                         "counts": np.asarray(counts).astype(np.int64)})


def ktruss_subgraph(G, k: int, use_weights=True):
    """Maximal subgraph where every edge is in >= k-2 triangles (reference
    k_truss_impl.cuh:166: iterative support peeling).  Peels on the host,
    one engine call per round, over the unique undirected pairs (found
    once by a sort, in key order as ``np.unique`` gives them); returns a
    Graph on the input graph's device."""
    if G.is_directed():
        raise ValueError("k_truss requires an undirected graph")
    from cugraph_tpu_torch.api.graph import Graph

    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    ukey, uidx = unique_by_sort(lo * n + hi, G.device, return_index=True)
    noloop = (ukey // n) != (ukey % n)
    src = src[uidx][noloop]
    dst = dst[uidx][noloop]
    w = None if w is None else w[uidx][noloop]
    while True:
        _, cnt = _oriented_tri.oriented_wedge_counts(src, dst, n,
                                                     need_edge_support=True)
        keep = cnt >= (k - 2)
        if keep.all() or not keep.any():
            break
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    out = Graph(device=G.device)
    if not keep.any():
        empty = np.array([], dtype=np.int64)
        return out.from_edgelist(empty, empty)
    return out.from_edgelist(G.number_map.to_external(src[keep]),
                             G.number_map.to_external(dst[keep]),
                             None if w is None else w[keep])


def k_truss(G, k: int):
    return ktruss_subgraph(G, k)


# -- egonets ------------------------------------------------------------------

def batched_ego_graphs(G, seeds, radius: int = 1):
    """Induced subgraphs within ``radius`` hops of each seed (reference
    egonet_impl.cuh:212): one BFS per seed (K2 (max, left) on its dense
    levels, no predecessor pass), the induced-edge mask on the graph's
    device, and only the kept rows copied to the host.  Returns (edge
    DataFrame ['src', 'dst', 'weight', 'seed'], seeds_offsets array)."""
    from cugraph_tpu_torch.algos.traversal import _bfs_levels

    g = G.structure
    seeds_arr = np.atleast_1d(np.asarray(seeds))
    internal = G.lookup_internal_vertex_id(seeds_arr)
    src, dst, w = G.edgelist_arrays()
    s_dev = torch.as_tensor(src, device=g.device).to(torch.int64)
    d_dev = torch.as_tensor(dst, device=g.device).to(torch.int64)
    upper = None if G.is_directed() else s_dev <= d_dev
    nm = G.number_map
    stats = {"syncs": 0, "sparse_levels": 0, "dense_levels": 0}
    frames, offsets, total = [], [0], 0
    for seed_ext, s in zip(seeds_arr, internal):
        in_ego = _bfs_levels(g, int(s), int(radius), stats) <= radius
        keep = in_ego[s_dev] & in_ego[d_dev]
        if upper is not None:
            keep &= upper
        idx = torch.nonzero(keep).squeeze(1).cpu().numpy()
        frames.append(pd.DataFrame({
            "src": nm.to_external(src[idx]),
            "dst": nm.to_external(dst[idx]),
            "weight": (w[idx] if w is not None
                       else np.ones(len(idx), np.float32)),
            "seed": seed_ext,
        }))
        total += len(idx)
        offsets.append(total)
    out = pd.concat(frames, ignore_index=True) if frames else pd.DataFrame(
        columns=["src", "dst", "weight", "seed"])
    return out, np.asarray(offsets)


def egonet(G, seeds, radius: int = 1):
    return batched_ego_graphs(G, seeds, radius)


# -- spectral clustering ------------------------------------------------------

def _adjacency_scipy(G):
    import scipy.sparse as sp
    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    vals = np.ones(len(src)) if w is None else w.astype(np.float64)
    return sp.csr_matrix((vals, (src, dst)), shape=(n, n))


def _kmeans(X, k, seed=0, iters=50):
    rng = np.random.default_rng(seed)
    # k-means++ init
    centers = [X[rng.integers(len(X))]]
    for _ in range(k - 1):
        d2 = np.min([((X - c) ** 2).sum(1) for c in centers], axis=0)
        if d2.sum() <= 0:  # fewer distinct rows than clusters
            centers.append(X[rng.integers(len(X))])
            continue
        p = d2 / d2.sum()
        centers.append(X[rng.choice(len(X), p=p)])
    C = np.stack(centers)
    for _ in range(iters):
        assign = np.argmin(((X[:, None, :] - C[None]) ** 2).sum(-1), axis=1)
        for j in range(k):
            pts = X[assign == j]
            if len(pts):
                C[j] = pts.mean(0)
    return assign


def spectralBalancedCutClustering(G, num_clusters: int,
                                  num_eigen_vects: int = 2,
                                  evs_tolerance=1e-5, evs_max_iter=1000,
                                  kmean_tolerance=1e-5, kmean_max_iter=100,
                                  seed: int = 0):
    """Balanced-cut spectral clustering on the normalized Laplacian
    (reference community/legacy/spectral_clustering.cu via raft::spectral;
    here, as in the JAX package, scipy Lanczos and NumPy k-means on the
    host).  Returns ['vertex', 'cluster']."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    A = _adjacency_scipy(G)
    A = (A + A.T) * 0.5
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).ravel()
    dm = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    L = sp.eye(n) - sp.diags(dm) @ A @ sp.diags(dm)
    k = max(num_eigen_vects, num_clusters)
    _, vecs = spl.eigsh(L, k=min(k, n - 1), which="SM", tol=evs_tolerance,
                        maxiter=evs_max_iter * 10)
    X = vecs[:, :num_eigen_vects]
    X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    assign = _kmeans(X, num_clusters, seed=seed, iters=kmean_max_iter)
    return vertex_frame(G, {"cluster": assign.astype(np.int32)})


def spectralModularityMaximizationClustering(G, num_clusters: int,
                                             num_eigen_vects: int = 2,
                                             evs_tolerance=1e-5,
                                             evs_max_iter=1000,
                                             kmean_tolerance=1e-5,
                                             kmean_max_iter=100,
                                             seed: int = 0):
    """Modularity-maximization spectral clustering: leading eigenvectors of
    the modularity matrix B = A - k k^T / 2m (reference
    spectral_modularity_maximization.pyx), on the host."""
    import scipy.sparse.linalg as spl
    A = _adjacency_scipy(G)
    A = (A + A.T) * 0.5
    n = A.shape[0]
    kdeg = np.asarray(A.sum(axis=1)).ravel()
    m2 = kdeg.sum()

    def matvec(x):
        return A @ x - kdeg * (kdeg @ x) / max(m2, 1e-30)

    B = spl.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    _, vecs = spl.eigsh(B, k=min(max(num_eigen_vects, num_clusters), n - 1),
                        which="LA", tol=evs_tolerance)
    X = vecs[:, :num_eigen_vects]
    assign = _kmeans(X, num_clusters, seed=seed, iters=kmean_max_iter)
    return vertex_frame(G, {"cluster": assign.astype(np.int32)})


# -- approximate weighted matching -------------------------------------------

def _edge_ranks(w: torch.Tensor) -> torch.Tensor:
    """int64 rank of every stored edge in the serial loop's order: weight
    descending, ties by position (``np.argsort(-w, kind="stable")``).
    -0.0 and +0.0 tie there, so both sort as +0.0 here."""
    key = torch.where(w == 0, torch.zeros_like(w), -w)
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=w.device)
    return rank


def _matching_rounds(src, dst, rank, n):
    """Locally-dominant rounds (reference
    approx_weighted_matching_impl.cuh:372): every free vertex picks its
    best incident edge to a free vertex by ``rank``, and an edge picked by
    both endpoints is matched.  Under a strict total order this is the
    greedy matching of the serial loop.  Returns (partner int64 [n], the
    matched edges' positions in rank order, host int64), one host sync
    per round."""
    dev = src.device
    partner = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    live = torch.nonzero(src != dst).squeeze(1)
    won_edges = []
    while live.numel():
        s, d, r = src[live], dst[live], rank[live]
        best = torch.full((n,), big, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, s, r, "amin").scatter_reduce_(0, d, r,
                                                              "amin")
        won = (best[s] == r) & (best[d] == r)
        spare = torch.full_like(s, n)  # losers write the spare slot n
        partner.index_put_((torch.where(won, s, spare),), d)
        partner.index_put_((torch.where(won, d, spare),), s)
        partner[n] = -1
        won_edges.append(torch.where(won, live, -1))
        free = partner[:n] < 0
        live = live[free[s] & free[d]]
    partner = partner[:n]
    if not won_edges:
        return partner, np.zeros(0, np.int64)
    pos = torch.cat(won_edges)
    pos = pos[pos >= 0]
    pos = pos[torch.sort(rank[pos]).indices]
    return partner, pos.cpu().numpy()


def _approx_weighted_matching_serial(src, dst, w, n):
    """The plain version: the JAX package's serial loop over the edges by
    descending weight (community.py:800-805)."""
    order = np.argsort(-w, kind="stable")
    partner = np.full(n, -1, np.int64)
    total = 0.0
    for e in order:
        u, v = int(src[e]), int(dst[e])
        if u != v and partner[u] == -1 and partner[v] == -1:
            partner[u], partner[v] = v, u
            total += float(w[e])
    return partner, total


def approx_weighted_matching(G) -> pd.DataFrame:
    """Greedy half-approximation to maximum weight matching (reference
    community/approx_weighted_matching_impl.cuh:372).  The locally-dominant
    rounds run on the graph's device; the matching is the serial loop's,
    and the total sums the matched weights in float64 in that loop's
    order.  Returns (['vertex', 'partner'] with -1 when unmatched, the
    matching weight)."""
    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    if w is None:
        w = np.ones(len(src), np.float32)
    dev = G.device
    partner, pos = _matching_rounds(
        torch.as_tensor(src, device=dev).to(torch.int64),
        torch.as_tensor(dst, device=dev).to(torch.int64),
        _edge_ranks(torch.as_tensor(w, device=dev)), n)
    partner = partner.cpu().numpy()
    total = float(np.cumsum(w[pos].astype(np.float64))[-1]) if len(pos) \
        else 0.0
    nm = G.number_map
    ext_partner = np.where(partner >= 0,
                           nm.to_external(np.maximum(partner, 0)), -1)
    return pd.DataFrame({"vertex": nm.to_external(np.arange(n)),
                         "partner": ext_partner}), total
