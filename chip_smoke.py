#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cugraph_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
In order, and any failure exits non-zero:

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   device count);
2. builds every kernel under ``cugraph_tpu_torch/kernels/csrc`` with nvcc,
   one process per source, and the native host library
   (``cugraph_tpu_torch/core/native.py``) with g++, all started together;
3. holds each kernel against its plain PyTorch version on the card, on
   small edge cases and on the RMAT-20 CSC/CSR, and checks that two launches
   are bit-identical: K1 (sum SpMV) within rtol 1e-5, every mode of K2
   (min/max SpMV) and K3 (argmax select) bit for bit, K4 (sum SpMM) within
   rtol 1e-5 and every mode of K5 (min/max SpMM) bit for bit, at F = 1, 3,
   128 and 130 on the small cases and F = 128 at RMAT-20; and K4's VJP
   (K4 over the CSR, the backward of ``kernels/spmm.make_spmm_pair``)
   within rtol 1e-5 of the plain K4 over the CSR, at F = 1, 3, 40, 128 and
   130 on the small cases and F = 256 at RMAT-20; and K1 (both modes), K4
   (both arms), K4's VJP and every mode of K2, K3 and K5 on heavy-row
   graphs cut at the span of K1-K5 and at 32
   (``cugraph_tpu_torch.testing.heavy_rows``), over the CSC and the CSR, at
   F = 1, 3, 40, 128, 130 and 256, K2, K3 and K5 at their wrappers' spans
   and at the graph's; K2 and K5 in fp32 also with a NaN on the heaviest
   row and on a light row and a row of -0.0 and +0.0, K3 with NaNs in
   x[u], x[r] and w and a row of signed zeros (on these graphs and on a
   small random one split at 8 edges): bit for bit, a NaN matching any
   NaN, K3 selecting no NaN, and a check that finds no NaN fails;
4. runs the PageRank path through the public entry points: RMAT-20 edge
   factor 16 (the graph of ``bench.py``) into ``Graph(directed=True)``
   (generation, renumbering and de-duplication on the native engines, held
   bit for bit against the graph's own edge list and vertex map, and at
   RMAT-18 against their NumPy plain versions, all timed), then
   ``pagerank`` twice and ``hits``, counting kernel launches, and checks the
   results against a float64 scipy.sparse power iteration;
5. runs the traversal paths through the public entry points: ``bfs`` from 8
   and ``sssp`` from 4 Graph500 search keys on the same edges as an
   undirected graph with Graph500 SSSP weights
   (``benchmarks/graph500_bfs.py:468-498``), and
   ``weakly_connected_components`` on the directed graph, each with the
   launch counts set to 0 just before and read just after; checks them
   against scipy.sparse.csgraph in float64, the Graph500 validators and a
   NumPy max-id predecessor pass;
6. runs the analytics paths through the public entry points:
   ``betweenness_centrality`` and ``edge_betweenness_centrality`` from 128
   sampled sources on the directed graph, ``multi_source_bfs`` from 32
   sources on it, and ``od_shortest_distances`` for 128 origins x 128
   destinations on the weighted undirected graph and on the directed one,
   each with the launch counts set to 0 just before and read just after;
   checks them against scipy's unweighted shortest paths, float64
   Dijkstra, a float64 panel Brandes with torch.sparse products, and
   networkx's betweenness on netscience;
7. runs the components, cores and power-method paths through the public
   entry points, each with the launch counts set to 0 just before and
   read just after: ``strongly_connected_components``, ``katz_centrality``
   (default alpha), ``degree_centrality`` and the hybrid WCC
   (``CUGRAPH_TPU_WCC_HYBRID=1``) on the directed graph, and
   ``eigenvector_centrality``, ``maximal_independent_set``,
   ``vertex_coloring``, ``core_number`` and ``k_core`` (largest k) on the
   undirected one; checks them against scipy's strong components (the
   partition and the largest internal id of each), float64 Katz and
   eigenvector iterations with the same stopping rule (L1 <= 1e-5 at unit
   L1 norm), the host degrees, independence and maximality, a proper
   colouring, an h-index fixpoint of the core numbers in plain torch on
   the card, the k-core's definition and the default WCC's labels;
8. runs the GNN path through the public entry points
   (``cugraph_tpu_torch.nn``): ``GraphSAGE(128, 256, 40)`` on the directed
   graph, 5 Adam steps and one eval forward, then ``GCN(128, 256, 40)``, 2
   steps, each with the launch counts set to 0 just before and read just
   after (2 forward and 1 VJP K4 launch per GraphSAGE step, 2 and 2 per
   GCN step); holds each first step's loss and gradients against the same
   model in float64, and requires GraphSAGE's loss to fall;
9. runs the sampling paths through the public entry points, each with the
   launch counts set to 0 just before and read just after:
   ``uniform_neighbor_sample`` on the directed graph and
   ``homogeneous_biased_neighbor_sample`` on the weighted undirected one,
   with and without replacement (4,096 seeds, fanout [10, 10]); 10 calls
   of ``per_v_random_select`` (K2 (max, right), then K3 eqsel) and the
   bulk with-replacement route over 65,536 vertices at k = 10 (10 rounds
   of both); ``uniform_random_walks``, ``biased_random_walks`` (4,096
   walks of depth 16) and ``node2vec_random_walks`` (512 walks of depth
   8); ``negative_sampling`` and ``sample_negatives(degree_biased=True)``
   (100,000 pairs each); ``nn.make_batches`` and GraphSAGE(128, 256, 40)
   on 5 sampled batches of 1,024 seeds and an eval forward; a
   link-prediction encoder (the same GraphSAGE, full graph, dot decoder),
   3 steps on 100,000 edges and as many negatives.  Checks every sampled
   pair against the CSR, the rows per (source, batch, hop), walks and
   negatives against the CSR; K2 (max, right) and K3 eqsel bit for bit on
   the path's own priorities and the select against a float64 NumPy
   argmax, with a χ² test on the hub; frames and walks on the card equal
   to the CPU plain path's at RMAT-12 on the same draws; the first sampled
   step against float64; a falling link-prediction loss;
   then, on the same edge list with edge ids, 4 edge types and
   integer-valued times (``from_edgelist(edge_id=, edge_type=,
   edge_time=)``, the CSR's kept permutation held against ``np.lexsort``),
   the two heterogeneous samplers, the three homogeneous temporal ones
   (one under "last"), the two heterogeneous temporal ones,
   ``heterogeneous_neighbor_sample`` and ``uniform_neighbor_sample(
   with_edge_properties=True)`` from 4,096 seeds, and an
   ``EdgeIdLookupTable`` queried 1,000,000 times, each with the launch
   counts set to 0 just before and read just after (none expected); and a
   directed ``MultiGraph`` from the raw RMAT-18 list with ``pagerank``
   (K1 mul) and ``count_multi_edges``.  Checks every sampled row against
   its edge's weight, id, type and time and the lookup table, the rows per
   (source, batch, type, hop) against min(k, eligible) over the source's
   copies, the times along every temporal path, two χ² tests on the top
   hub (uniform and weight-proportional type-0 picks), the lookup against
   a NumPy oracle, the card's frames against the CPU's at RMAT-12 on the
   same draws ("last": the card's per-edge route against the CPU's tile
   route), the MultiGraph's PageRank against float64 with the duplicates
   summed and its multi-edge count against a NumPy sort;
10. runs ``BASELINE.json``'s third configuration, "Louvain + WCC +
   Jaccard on netscience", through the public entry points on the
   undirected, weighted netscience graph: ``louvain``,
   ``weakly_connected_components`` (with the launch counts set to 0 just
   before and read just after: K2 (min, left) int32, one per sweep), the
   four coefficients weighted and unweighted over the default pairs,
   ``leiden`` and ``ecg`` (random_state 0), ``all_pairs_jaccard`` (top
   100) and the three ``analyzeClustering_*``; then ``jaccard`` over
   the 15.7 M default pairs and weighted over 1,000,000 edge pairs, and
   ``all_pairs_jaccard`` of 64 vertices (top 1,000) on the Graph500
   RMAT-20, and ``louvain``, ``leiden`` and ``ecg`` (16 members) on the
   same construction at RMAT-18 (cut for the time limit).  Checks every
   partition (0..k-1 over every vertex), louvain's and leiden's q against
   float64 on the input graph (1e-5), leiden's connected communities,
   ecg's positive float64 modularity on the input graph, the netscience
   WCC against scipy, the card's pair probe on 100,000 default pairs
   against a scipy oracle (counts and Jaccard exact, the weighted sums
   within rtol 1e-6) and twice bit-identical, and netscience on the card
   equal to the CPU run bit for bit;
11. runs the remaining algorithms through the public entry points, each
   once and timed, with the launch counts set to 0 just before and read
   just after: ``triangle_count`` and ``edge_triangle_count`` on the
   Graph500 construction at RMAT-18 and ``k_truss(5)`` on the one at
   RMAT-16 (the native wedge engine; cut from RMAT-20 and RMAT-18 for the
   time limit); ``topological_sort`` on the PageRank cell's edges
   with src < dst (a DAG; K1 "left" once per Kahn level) and on the cyclic
   directed graph, which must raise; ``minimum_spanning_tree`` and
   ``maximum_spanning_tree``, ``batched_ego_graphs`` from 33 seeds at
   radius 1 and 4 at radius 2 (K2 (max, left) on dense BFS levels) and
   ``approx_weighted_matching`` on the Graph500 RMAT-20;
   ``dense_hungarian`` on 1,024 x 1,024 integer costs and ``hungarian``
   on a small bipartite graph; ``force_atlas2`` on netscience (exact, 500
   iterations) and on the Graph500 RMAT-16 (particle-mesh, 50
   iterations); the two spectral clusterings of netscience and
   ``experimental.find_bicliques`` on a planted frame.  Checks triangle
   counts at 256 vertices against NumPy neighbour-list intersections, Σ
   tri = 3·T and the per-edge sum, the k-truss's own support and its
   peel against the NumPy engine's at RMAT-14; the levels against a NumPy
   Kahn pass; each forest's edge count, acyclicity and weight against
   scipy (rtol 1e-6); each ego's vertex set and induced edges against
   NumPy CSR expansions; the matching's symmetry, greedy order and
   float64 total; the assignments within N·ε of scipy's optimum; one
   exact ForceAtlas2 step against float64 and the particle-mesh
   repulsion against the exact one; the cluster labels and the planted
   biclique;
12. runs the Graph and API long tail through the public entry points,
   each call once and timed, with the launch counts set to 0 just before
   and read just after: ``erdos_renyi_gnm(2^19, 2^23)`` into an undirected
   ``Graph`` by ``from_pandas_edgelist``, ``shortest_path`` (K2 (min,
   add), K3) and ``bfs_edges`` (K2 (max, left), K3) from one vertex,
   ``has_isolated_vertices``, ``number_of_nodes``, ``to_directed``, and
   ``unrenumber`` and ``add_internal_vertex_id`` on 2^20 rows;
   ``mesh_3d_graph(128, 128, 128)`` by ``from_adjlist`` and ``bfs_edges``
   from vertex 0 (381 levels); ``bipartite_rmat(19, 17, 2^23)`` in a
   ``BiPartiteGraph`` with both partitions registered and ``pagerank``
   (20 iterations, tol 0; K1 mul); ``to_numpy_array``,
   ``from_numpy_array``, ``to_pandas_adjacency`` and
   ``from_pandas_adjacency`` on an undirected weighted RMAT-14;
   ``graphsage_apply`` at (128, 256, 40) on the directed RMAT-20 graph and
   one functional train step (K4 and its VJP); and every dataset's
   ``get_graph()`` with ``weakly_connected_components`` (K2 (min, left)).
   Checks the distances against scipy's unit-weight Dijkstra and both
   trees against the Graph500 validators, the edge and vertex counts, the
   frames against NumPy, every mesh distance i + j + k and its tree, the
   partitions, every edge across them and the PageRank against float64
   (L1 1e-5), ``to_numpy_array`` bit for bit against a NumPy last-write
   pass and the edge sets and float32 weights the two constructors give
   back, ``graphsage_apply`` bit for bit against the module on the same
   weights and the functional step against the module's (loss rtol 1e-5,
   weights atol 1e-4), and each dataset's WCC against scipy;
13. runs the plc layer (``cugraph_tpu_torch.plc``) through its wrappers,
   each call once and timed, with the launch counts set to 0 just before
   and read just after: an ``SGGraph`` of the PageRank cell's COO with
   ``pagerank``, ``personalized_pagerank`` over 64 vertices, ``hits`` (tol
   0), ``bfs`` from the top out-degree vertex (K2 (max, left), K3) and
   from 32 sources (K4), ``sssp`` (K2 (min, add), K3),
   ``weakly_connected_components`` (K2 (min, left)),
   ``betweenness_centrality(k=32)`` on a ``CuGraphRandomState`` (K4),
   ``homogeneous_uniform_neighbor_sample`` from 4,096 seeds in 4 labels
   ([10, 10], renumbered to CSR, seeds retained, a state),
   ``uniform_random_walks`` (4,096 x 16, a state), ``generate_rmat_edgelist``
   at scale 20, ``degrees`` and ``decompress_to_edgelist``; a symmetric
   ``SGGraph`` of netscience with ``louvain``, ``leiden`` (a state),
   ``ecg``, ``jaccard_coefficients``, ``triangle_count``, ``core_number``
   and ``k_truss_subgraph(5)``.  Checks both graphs against the Graphs of
   the same arrays, each call against the top-level function on them bit
   for bit, the 32-source ``bfs`` against NumPy's per-vertex argmin over
   the ``multi_source_bfs`` frame, ``sssp``'s distances against ``bfs``'s,
   the sampler's offsets, renumber map and minors against a NumPy
   re-derivation from the plain frame sampled on the state's seed, every
   walk step against the CSR, the generator against ``rmat``, the degrees
   against NumPy and the decompressed keys against the input COO's, and
   that K1, K2, K3 and K4 launched;
14. runs the multi-device layer (``cugraph_tpu_torch.parallel``) on a
   one-rank NCCL mesh brought up in this process (a ``HashStore``, no
   port): ``build_dist_graph`` of the PageRank cell's COO (pull and push)
   and of the Graph500 construction, then ``mg_pagerank``,
   ``mg_katz_centrality``, ``mg_hits`` (K1 mul), ``mg_eigenvector_
   centrality`` on the Graph500 one (K1 mul), ``mg_degrees``, ``mg_bfs``
   from the 8 keys (K2 (max, left) int32), ``mg_sssp`` from the first
   SSSP key (K2 (min, add)), ``mg_wcc`` (K2 (min, left) int32) and 5 Adam
   steps of MG GraphSAGE(128, 256, 172) (``make_mg_train_step``: K4 and
   its VJP), each with the launch counts set to 0 just before and read
   just after.  Checks the power methods against the float64 references
   of phases 4 and 7 (the same iterations, L1 1e-5), the degrees against
   the host counts, BFS against scipy and the single-device port bit for
   bit, SSSP within rtol 1e-6 of the single-device port with the largest
   exact-equality predecessors, WCC against scipy and the port, and the
   first MG GraphSAGE step against the single-device port's on the same
   weights (loss rtol 1e-5, gradients' relative L2 1e-4); times MG
   PageRank per iteration beside the single-device port's, in turns,
   and profiles one MG PageRank iteration by kernel (busy and idle share);
15. times the power iteration, bfs, sssp, wcc, the component, core and
   power-method calls, the analytics calls and a training step of each
   GNN, each kernel mode, its plain version and a
   PyTorch library call for the same work (CUDA events, after a warm-up),
   beside the least time the card could take for the same bytes and
   operations, and profiles one power iteration, one bfs, one betweenness
   call and a training step of each GNN by kernel; times K4 at F = 40 and
   K1, K4, K2 (min, add), K3 eqsel_rel and K5 (min, add) with their
   heaviest rows emptied; and sweeps the spans of K1, K4, K2, K3 and K5,
   from which the wrappers' spans were chosen; times each sampler, walk
   and negative sampler (with the device's share of one profiled call),
   ``per_v_random_select``, the bulk route and the gather and select rates
   that set its crossover, a ``make_batches`` batch, a sampled GraphSAGE
   step and eval forward, and a link-prediction step; each netscience call
   (median of 3), each RMAT community and similarity call (one run), the
   card probe's probes per second, one profiled ``jaccard`` and
   ``louvain`` at RMAT-20, and one torch local-moving sweep on the card
   beside one native sweep; each masked sampler (median of 3, rows/s), the
   lookup table's build and queries, the MultiGraph's set-up, PageRank
   and count, and one profiled ``heterogeneous_biased_temporal_neighbor_
   sample`` call with a cProfile of its host time by function;
16. prints one ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``cugraph_tpu``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SCALE = 20
EDGE_FACTOR = 16
RMAT_ABC = (0.57, 0.19, 0.19)
SEED = 7
# tolerances: the kernel sums in fp32 over a fixed order, the plain version
# in float64; the power iterations are held to a float64 reference
RTOL, ATOL_REL = 1e-5, 1e-6
L1_TOL = 1e-5
HITS_ITERS = 20
PAGERANK_TIMED_ITERS = 200  # N; N and 2N iterations are timed
TIMED_PAIRS = 5
KERNEL_TIMED_LAUNCHES = 100
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SOURCE = "cugraph_tpu_torch/kernels/csrc/spmv_csr.cu"
REPLACES = "cugraph_tpu/kernels/spmv_onehot.py:398"
# the traversal phases (benchmarks/graph500_bfs.py:468-498)
BFS_KEYS = 8
SSSP_KEYS = 4
WEIGHT_SEED = 11
KEY_SEED = 7
# float32 distances summed along a path of a few tens of edges, each sum
# rounded once (2^-24 relative): well inside 1e-6 of float64 Dijkstra
SSSP_RTOL = 1e-6


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels():
    """Every CUDA kernel with nvcc and the native host library with g++,
    all processes started together."""
    from cugraph_tpu_torch.core import native
    from cugraph_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    host_job = native.start_build()
    names = _build.sources()
    _build.build(names)
    native.finish_build(host_job)
    native.get_lib()
    print(f"built {names} and the native host library "
          f"({' '.join([native.CXX, *native.CXX_FLAGS])} -> "
          f"{os.path.relpath(native.library_path())}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.BUILD_LOG.get(name, f"{name}: already built").strip())
        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                                 "cuobjdump")
        if os.path.exists(cuobjdump):
            elf = subprocess.run([cuobjdump, "--list-elf",
                                  _build.library_path(name)],
                                 capture_output=True, text=True, timeout=60)
            print(elf.stdout.strip())


# -- phase 3: each kernel against its plain version --------------------------

def _case(n, src, dst, w, device):
    from cugraph_tpu_torch.core.structure import build_structure

    return build_structure(src, dst, w, n, device)


def small_cases(device):
    """(name, GraphStructure) edge cases: self-loops and parallel edges,
    isolated vertices, no edges, no vertices.  The kernel checks run over
    the CSC, K4's VJP over the CSC and the CSR."""
    rng = np.random.default_rng(0)
    n_iso = 50
    src_iso = rng.integers(0, 10, 200)
    dst_iso = rng.integers(0, 10, 200)
    return [
        ("tiny", _case(3, np.array([0, 0, 0, 2, 2, 1]),
                       np.array([1, 1, 0, 2, 2, 1]),
                       np.arange(1, 7, dtype=np.float32), device)),
        ("isolated", _case(n_iso, src_iso, dst_iso,
                           rng.random(200).astype(np.float32), device)),
        ("random", _case(300, rng.integers(0, 300, 2000),
                         rng.integers(0, 300, 2000),
                         rng.random(2000).astype(np.float32), device)),
        ("empty", _case(7, np.zeros(0, np.int64), np.zeros(0, np.int64),
                        None, device)),
        ("no_vertices", _case(0, np.zeros(0, np.int64),
                              np.zeros(0, np.int64), None, device)),
    ]


def check_kernel(name, adj, combine, weights=None, seed=0):
    """Kernel vs plain version on the card; returns the max abs error."""
    import torch

    from cugraph_tpu_torch.kernels.spmv import spmv_csr, spmv_csr_reference

    w = adj.weights if weights is None else weights
    x = torch.from_numpy(np.random.default_rng(seed).random(
        adj.num_vertices, dtype=np.float32)).to(adj.device)
    y1 = spmv_csr(adj.offsets, adj.indices, w, x, combine)
    y2 = spmv_csr(adj.offsets, adj.indices, w, x, combine)
    ref = spmv_csr_reference(adj.offsets, adj.indices, w, x, combine)
    torch.cuda.synchronize()
    if not torch.equal(y1.view(torch.int32), y2.view(torch.int32)):
        raise AssertionError(f"{name}/{combine}: two launches differ")
    if y1.shape != ref.shape or not bool(torch.isfinite(y1).all()):
        raise AssertionError(f"{name}/{combine}: bad output")
    err = (y1 - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    bad = err > RTOL * ref.abs() + ATOL_REL * scale
    if bool(bad.any()):
        raise AssertionError(
            f"{name}/{combine}: {int(bad.sum())} rows off, max err "
            f"{float(err.max()):.3e} (max|y| {scale:.3e})")
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"kernel check {name:>12s} {combine:4s}: n={adj.num_vertices} "
          f"m={adj.num_edges} max_abs_err={max_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL_REL}*max|y|={ATOL_REL * scale:.3e}), "
          "two launches bit-identical")
    return max_err


# -- phase 4: the main path and its float64 reference ------------------------

def build_graph(device):
    from cugraph_tpu_torch import Graph, rmat

    t0 = time.perf_counter()
    a, b, c = RMAT_ABC
    edges = rmat(SCALE, EDGE_FACTOR << SCALE, a=a, b=b, c=c, seed=SEED)
    t1 = time.perf_counter()
    G = Graph(directed=True, device=device)
    G.from_edgelist(edges, "src", "dst")
    t2 = time.perf_counter()
    g = G.structure
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"RMAT-{SCALE} ef{EDGE_FACTOR} seed {SEED}: n={g.num_vertices} "
          f"m={g.num_edges} max in-degree {int(g.in_degrees().max())}; "
          f"host set-up: rmat {t1 - t0:.1f} s, Graph {t2 - t1:.1f} s, "
          f"CSR/CSC on {device} {t3 - t2:.1f} s")
    return G, edges


def reference_matrix(G):
    import scipy.sparse as sp

    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    vals = np.ones(len(src)) if w is None else w.astype(np.float64)
    return sp.csr_matrix((vals, (src, dst)), shape=(n, n))


def pagerank_reference(A, max_iter, tol, alpha=0.85):
    """float64 power iteration with pagerank's loop and stopping rule;
    returns (p, iterations)."""
    n = A.shape[0]
    At = A.T.tocsr()
    out_w = np.asarray(A.sum(axis=1)).ravel()
    dangling = out_w <= 0
    inv_out = np.divide(1.0, out_w, out=np.zeros(n), where=~dangling)
    reset = np.full(n, 1.0 / n)
    p, err, it = reset.copy(), np.inf, 0
    while err >= tol and it < max_iter:
        p_new = alpha * (At @ (p * inv_out) + p[dangling].sum() * reset) \
            + (1 - alpha) * reset
        err = np.abs(p_new - p).sum()
        p, it = p_new, it + 1
    return p, it


def hits_reference(A, max_iter, tol):
    n = A.shape[0]
    At = A.T.tocsr()
    h, a = np.full(n, 1.0 / n), np.zeros(n)
    err, it = np.inf, 0
    while err >= tol and it < max_iter:
        a = At @ h
        a /= max(np.abs(a).max(), 1e-30)
        h_new = A @ a
        h_new /= max(np.abs(h_new).max(), 1e-30)
        err = np.abs(h_new - h).sum()
        h, it = h_new, it + 1
    return h / max(h.sum(), 1e-30), a / max(a.sum(), 1e-30), it


def _by_internal_id(G, df, col):
    out = np.zeros(G.number_of_vertices())
    out[G.lookup_internal_vertex_id(df["vertex"].to_numpy())] = \
        df[col].to_numpy()
    return out


def _hold(label, got, want):
    l1 = float(np.abs(got - want).sum())
    if not (np.isfinite(got).all() and l1 <= L1_TOL):
        raise AssertionError(f"{label}: L1 {l1:.3e} > {L1_TOL}")
    print(f"{label}: L1 vs float64 reference {l1:.3e} (<= {L1_TOL}), "
          f"sum {got.sum():.7f}")
    return l1


def main_path(G):
    """Runs pagerank twice and hits, with the launch counts set to 0 just
    before and read just after; returns the counts by combine mode and the
    float64 references (for the multi-device phase)."""
    from cugraph_tpu_torch import hits, pagerank
    from cugraph_tpu_torch.kernels import spmv

    spmv.LAUNCHES = 0
    spmv.LAUNCHES_BY_COMBINE.update(mul=0, left=0)
    pr_default = pagerank(G)
    k_default = spmv.LAUNCHES
    pr_100, converged = pagerank(G, max_iter=100, tol=0.0,
                                 fail_on_nonconvergence=False)
    k_100 = spmv.LAUNCHES - k_default
    # tol=0 fixes the iteration count: at this size the float32 L1 change
    # of the max-normalized hubs stays above the default tol of 1e-5
    hub_auth = hits(G, max_iter=HITS_ITERS, tol=0.0)
    k_hits = spmv.LAUNCHES - k_default - k_100
    counts = dict(spmv.LAUNCHES_BY_COMBINE)

    A = reference_matrix(G)
    p_ref, it_ref = pagerank_reference(A, 100, float(np.float32(1e-5)))
    if k_default != it_ref:
        raise AssertionError(f"pagerank(G): {k_default} launches, the "
                             f"reference converged in {it_ref} iterations")
    pr = _by_internal_id(G, pr_default, "pagerank")
    _hold(f"pagerank(G) default tol, {k_default} iterations = launches",
          pr, p_ref)
    if abs(pr.sum() - 1.0) > L1_TOL:
        raise AssertionError(f"pagerank sums to {pr.sum()}")
    if k_100 != 100 or converged:
        raise AssertionError(f"pagerank(max_iter=100, tol=0): {k_100} "
                             f"launches, converged={converged}")
    refs = {"pagerank": (p_ref, it_ref)}
    p_ref, _ = pagerank_reference(A, 100, 0.0)
    _hold("pagerank(G, max_iter=100, tol=0), 100 iterations = launches",
          _by_internal_id(G, pr_100, "pagerank"), p_ref)
    h_ref, a_ref, it_h = hits_reference(A, HITS_ITERS, 0.0)
    if k_hits != 2 * it_h:
        raise AssertionError(f"hits: {k_hits} launches for {it_h} "
                             "iterations, expected 2 per iteration")
    _hold(f"hits(G, max_iter={HITS_ITERS}, tol=0) hubs, {it_h} iterations, "
          f"{k_hits} launches", _by_internal_id(G, hub_auth, "hubs"), h_ref)
    _hold("hits authorities", _by_internal_id(G, hub_auth, "authorities"),
          a_ref)
    print(f"main-path launches by mode: {counts} "
          f"(pagerank {k_default} + {k_100}, hits {k_hits})")
    refs["hits"] = (h_ref, a_ref)
    return counts, refs


# -- phase 5: timing ----------------------------------------------------------

def _cuda_ms(fn, repeats):
    """Mean ms of ``fn`` over ``repeats`` calls, CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def time_power_iteration(G, card):
    n_it = PAGERANK_TIMED_ITERS
    m = G.number_of_edges()
    run = functools.partial(_pagerank_call, G)
    # the difference cancels the per-call set-up; the median of the pairs
    # resists the host's jitter, which the per-iteration .item() exposes
    diffs = []
    for _ in range(TIMED_PAIRS):
        t1 = _cuda_ms(run(n_it), 1)
        t2 = _cuda_ms(run(2 * n_it), 1)
        diffs.append((t2 - t1) / n_it)
    per_iter = float(np.median(diffs))
    row = {"metric": f"pagerank_rmat{SCALE}_ef{EDGE_FACTOR}_ms_per_iteration",
           "ms_per_iteration": per_iter, "ms_per_iteration_runs": diffs,
           "edges_per_s": m / (per_iter * 1e-3),
           "generated_edges_per_s": (EDGE_FACTOR << SCALE) / (per_iter * 1e-3),
           "n": G.number_of_vertices(), "m": m, "card": card}
    print(json.dumps(row))
    return row


def _device_ms_by_name(fn):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    and the host's ms for the same window, from a synchronised start to the
    synchronised end of the call: an idle share reads both, so that the
    profiler's own cost is on both sides."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = evt.name[:60]
            by_name[key] = by_name.get(key, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    return by_name, window_ms


def _pagerank_call(G, iters):
    from cugraph_tpu_torch import pagerank

    return lambda: pagerank(G, max_iter=iters, tol=0.0,
                            fail_on_nonconvergence=False)


def profile_power_iteration(G, card, ms_per_iteration, call=None,
                            label=None):
    """Device time per power iteration by kernel name, as the difference of
    a 2N- and an N-iteration call (which cancels the per-call set-up), and
    the device's idle share against the same difference of the profiled
    windows.  ``call(iters)`` gives the call to profile: the single-device
    ``pagerank`` unless given."""
    call = call or functools.partial(_pagerank_call, G)
    n_it = 20
    _device_ms_by_name(call(2))  # warm-up
    one, win1 = _device_ms_by_name(call(n_it))
    two, win2 = _device_ms_by_name(call(2 * n_it))
    per_iter = {k: (two.get(k, 0.0) - one.get(k, 0.0)) / n_it
                for k in set(one) | set(two)}
    busy = sum(per_iter.values())
    window = (win2 - win1) / n_it
    top = dict(sorted(per_iter.items(), key=lambda kv: -kv[1])[:8])
    seen = bool(one and two)
    row = {"profile": label or f"pagerank_rmat{SCALE}_ef{EDGE_FACTOR}",
           "iterations": [n_it, 2 * n_it],
           "device_ms_per_iteration": busy if seen else "not measured",
           "device_ms_per_iteration_by_kernel": top,
           "ms_per_iteration_profiled": window,
           "ms_per_iteration_unprofiled": ms_per_iteration,
           "device_idle_share": (1 - busy / window) if seen
           else "not measured", "card": card}
    print(json.dumps(row))
    return row


def bound_ms(n, m, combine):
    """Least time for one launch: each input read once and the output
    written once at the HBM rate, or the flops at the fp32 rate."""
    bytes_moved = (8 if combine == "mul" else 4) * m + 12 * n
    flops = (2 if combine == "mul" else 1) * m
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S) * 1e3


def time_kernel(adj, combine, card):
    import torch

    from cugraph_tpu_torch.kernels.spmv import spmv_csr, spmv_csr_reference

    n, m = adj.num_vertices, adj.num_edges
    x = torch.from_numpy(np.random.default_rng(1).random(
        n, dtype=np.float32)).to(adj.device)
    w = adj.weights if combine == "mul" else None
    ms = _cuda_ms(lambda: spmv_csr(adj.offsets, adj.indices, w, x, combine),
                  KERNEL_TIMED_LAUNCHES)
    plain_ms = _cuda_ms(lambda: spmv_csr_reference(
        adj.offsets, adj.indices, adj.weights, x, combine), 10)
    values = adj.weights if combine == "mul" else torch.ones_like(adj.weights)
    with warnings.catch_warnings():  # "beta" and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(adj.offsets, adj.indices, values, (n, n),
                                    check_invariants=False)
    library_ms = _cuda_ms(lambda: A @ x, KERNEL_TIMED_LAUNCHES)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(n, m, combine),
           "bound_by": "bytes", "library_ms": library_ms}
    print(f"spmv_csr_sum_{combine} at the pull shape n={n} m={m}: "
          + json.dumps(row) + f" [{card}]")
    return row


# -- K2 and K3: the min/max SpMV and the argmax select ------------------------

SEMIRING_SOURCE = "cugraph_tpu_torch/kernels/csrc/spmv_semiring.cu"
SELECT_SOURCE = "cugraph_tpu_torch/kernels/csrc/spmv_select.cu"
SEMIRING_REPLACES = "cugraph_tpu/kernels/spmv_onehot.py:565"
SELECT_REPLACES = {"eqsel_rel": "cugraph_tpu/kernels/spmv_onehot.py:541",
                   "eqsel_rel_unit": "cugraph_tpu/kernels/spmv_onehot.py:541",
                   "eqsel": "cugraph_tpu/kernels/spmv_onehot.py:531"}
# every K2 mode as (reduce, combine, int32 payload); the first three are on
# the traversal paths (BFS dense levels, SSSP dense sweeps, WCC)
SEMIRING_MODES = [("max", "left", True), ("min", "add", False),
                  ("min", "left", True), ("min", "left", False),
                  ("max", "left", False), ("max", "add", False),
                  ("min", "mul", False), ("max", "mul", False),
                  ("min", "right", False), ("max", "right", False)]
SELECT_MODES = ["eqsel_rel_unit", "eqsel_rel", "eqsel"]


def _semiring_key(reduce, combine, is_int):
    return f"{reduce}_{combine}" + ("_i32" if is_int else "")


def _semiring_inputs(adj, combine, is_int, seed):
    """x (some entries at 1e30, the unreached) and weights for one K2
    mode, on the card."""
    import torch

    rng = np.random.default_rng(seed)
    n = adj.num_vertices
    if is_int:
        x = rng.permutation(n).astype(np.int32)
        x[::3] = -1
    else:
        x = (rng.random(n) * 10).astype(np.float32)
        x[::7] = 1e30
    w = torch.from_numpy(rng.uniform(0.5, 1.5, adj.num_edges).astype(
        np.float32)).to(adj.device)
    return torch.from_numpy(x).to(adj.device), \
        None if combine == "left" else w


def _select_inputs(adj, mode, seed):
    """x and weights for one K3 mode, built so that many edges pass: small
    integer distances with weights of 0.5 or 1.0 for eqsel_rel, and for
    eqsel the rows' largest priority, from K2 (max, right)."""
    import torch

    from cugraph_tpu_torch.kernels.semiring import spmv_semiring

    rng = np.random.default_rng(seed)
    n, m, dev = adj.num_vertices, adj.num_edges, adj.device
    if mode == "eqsel":
        w = torch.from_numpy(rng.random(m).astype(np.float32)).to(dev)
        x = spmv_semiring(adj.offsets, adj.indices, w,
                          torch.zeros(n, device=dev), "max", "right")
        return x, w, 0.0, 0.0
    x = torch.from_numpy((rng.integers(0, 8, n) * 0.5).astype(
        np.float32)).to(dev)
    x[::11] = 1e30
    if mode == "eqsel_rel_unit":
        return x, None, 0.25, 0.0
    w = torch.from_numpy((rng.integers(1, 3, m) * 0.5).astype(
        np.float32)).to(dev)
    return x, w, 1e-6, 2e-5


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _hold_exact(label, y1, y2, ref):
    """Two launches bit-identical, and the kernel equal to its plain
    version bit for bit, a NaN matching any NaN (the kernel writes the
    canonical one)."""
    import torch

    from cugraph_tpu_torch.testing import bit_mismatches

    torch.cuda.synchronize()
    if not torch.equal(_bits(y1), _bits(y2)):
        raise AssertionError(f"{label}: two launches differ")
    diff = bit_mismatches(y1, ref) if y1.shape == ref.shape else "shape"
    if diff:
        raise AssertionError(f"{label}: differs from its plain version "
                             f"({diff} entries)")


def check_semiring_and_select(name, adj, modes=None):
    """Every K2 and K3 mode (or those in ``modes``) against its plain
    version on one CSR, bit for bit, and two launches bit-identical;
    returns {mode key: max abs error} (0.0 when exact)."""
    from cugraph_tpu_torch.kernels.semiring import (spmv_select,
                                                    spmv_select_reference,
                                                    spmv_semiring,
                                                    spmv_semiring_reference)

    errs = {}
    for i, (reduce, combine, is_int) in enumerate(SEMIRING_MODES):
        key = _semiring_key(reduce, combine, is_int)
        if modes is not None and key not in modes:
            continue
        x, w = _semiring_inputs(adj, combine, is_int, i)
        args = (adj.offsets, adj.indices, w, x, reduce, combine)
        _hold_exact(f"{name}/spmv_semiring_{key}", spmv_semiring(*args),
                    spmv_semiring(*args), spmv_semiring_reference(*args))
        errs[key] = 0.0
    for i, mode in enumerate(SELECT_MODES):
        if modes is not None and mode not in modes:
            continue
        x, w, atol, rtol = _select_inputs(adj, mode, 100 + i)
        kind = "eqsel" if mode == "eqsel" else "eqsel_rel"
        args = (adj.offsets, adj.indices, w, x, kind, atol, rtol)
        y = spmv_select(*args)
        _hold_exact(f"{name}/spmv_select_{mode}", y, spmv_select(*args),
                    spmv_select_reference(*args))
        if adj.num_edges >= 1000 and not bool((y >= 0).any()):
            raise AssertionError(f"{name}/spmv_select_{mode}: no row "
                                 "selected anything; the check is vacuous")
        errs[mode] = 0.0
    print(f"kernel check {name:>12s} K2/K3: n={adj.num_vertices} "
          f"m={adj.num_edges} {sorted(errs)} bit-identical to the plain "
          "versions, two launches bit-identical", flush=True)
    return errs


def semiring_bound_ms(n, m, combine, hits=0):
    """Least time for one K2 launch, or K3 with ``combine`` its mode: bytes
    (each input read once, the output written once) at the HBM rate, or ~2
    operations per edge at the fp32 rate.  "left" and unit-weight
    eqsel_rel read 4 B per edge (the index), "right" 4 B (the weight; no
    index, no x), eqsel 4 B (the weight) plus 4 B for each of its ``hits``
    (the index of a selected edge, loaded only on a hit), the rest 8 B;
    every vertex costs 4 B of offsets and 4 B of output, plus 4 B of x
    except under "right"."""
    per_edge = 4 if combine in ("left", "right", "eqsel_rel_unit",
                                "eqsel") else 8
    per_vertex = 8 if combine == "right" else 12
    bytes_moved = per_edge * m + per_vertex * n + 4 * hits
    return max(bytes_moved / PEAK_BYTES_PER_S,
               2 * m / PEAK_FP32_PER_S) * 1e3


# -- phase 5: the traversal paths --------------------------------------------

def build_graph500_graph(edges, device, scale=None):
    """The undirected, weighted graph of benchmarks/graph500_bfs.py:468-490
    on RMAT-``scale`` edges (the PageRank phase's by default): uniform
    (0, 1] weights from seed 11, reduced to the minimum per undirected
    pair; and the search keys among vertices of degree >= 1, from seed 7
    (:494-498)."""
    from cugraph_tpu_torch import Graph

    scale = SCALE if scale is None else scale
    t0 = time.perf_counter()
    src = edges["src"].to_numpy()
    dst = edges["dst"].to_numpy()
    w = (1.0 - np.random.default_rng(WEIGHT_SEED).random(len(src))).astype(
        np.float32)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    key = lo.astype(np.int64) * (1 << scale) + hi
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    wmin = np.minimum.reduceat(w[order], np.flatnonzero(first))
    lo, hi = lo[order][first], hi[order][first]
    G = Graph(directed=False, device=device)
    G.from_edgelist(lo, hi, wmin)
    present = np.unique(np.concatenate([src, dst]))
    keys = np.random.default_rng(KEY_SEED).choice(present, size=BFS_KEYS,
                                                  replace=False)
    g = G.structure
    print(f"Graph500 undirected RMAT-{scale}: n={g.num_vertices} "
          f"stored m={g.num_edges} ({len(lo)} undirected pairs), "
          f"max degree {int(g.in_degrees().max())}, keys {keys.tolist()}; "
          f"host set-up {time.perf_counter() - t0:.1f} s", flush=True)
    return G, lo, hi, wmin, keys


def _reset_counts():
    from cugraph_tpu_torch.algos import traversal
    from cugraph_tpu_torch.kernels import semiring, spmv

    spmv.LAUNCHES = 0
    spmv.LAUNCHES_BY_COMBINE.update(mul=0, left=0)
    for counts in (semiring.SEMIRING_LAUNCHES, semiring.SELECT_LAUNCHES):
        for key in counts:
            counts[key] = 0
    traversal.PRED_STRAGGLERS = 0


def _read_counts():
    from cugraph_tpu_torch.kernels import semiring, spmv

    out = {f"spmv_csr_sum_{k}": v for k, v in
           spmv.LAUNCHES_BY_COMBINE.items()}
    out.update({f"spmv_semiring_{k}": v for k, v in
                semiring.SEMIRING_LAUNCHES.items()})
    out.update({f"spmv_select_{k}": v for k, v in
                semiring.SELECT_LAUNCHES.items()})
    return out


def traversal_paths(Gu, G, keys):
    """bfs from BFS_KEYS keys and sssp from SSSP_KEYS on the undirected
    graph, wcc on the directed one, each with the launch counts set to 0
    just before and read just after; returns the frames and the counts."""
    from cugraph_tpu_torch import bfs, sssp, weakly_connected_components
    from cugraph_tpu_torch.algos import components, traversal

    _reset_counts()
    bfs_out = []
    for key in keys[:BFS_KEYS]:
        bfs_out.append((int(key), bfs(Gu, int(key)),
                        dict(traversal.LAST_RUN)))
    c_bfs = _read_counts()
    _reset_counts()
    sssp_out = []
    for key in keys[:SSSP_KEYS]:
        sssp_out.append((int(key), sssp(Gu, int(key)),
                         dict(traversal.LAST_RUN)))
    stragglers = traversal.PRED_STRAGGLERS
    c_sssp = _read_counts()
    _reset_counts()
    wcc = weakly_connected_components(G)
    sweeps = components.LAST_SWEEPS
    c_wcc = _read_counts()

    def need(counts, key, label, exact=None):
        got = counts[key]
        if got == 0 or (exact is not None and got != exact):
            raise AssertionError(f"{label} launched {key} {got} times"
                                 + (f", expected {exact}" if exact else ""))

    need(c_bfs, "spmv_semiring_max_left_i32", "bfs (dense levels)")
    need(c_bfs, "spmv_select_eqsel_rel_unit", "bfs (predecessors)",
         BFS_KEYS)
    need(c_sssp, "spmv_semiring_min_add", "sssp (dense relaxations)")
    need(c_sssp, "spmv_select_eqsel_rel", "sssp (predecessors)", SSSP_KEYS)
    need(c_wcc, "spmv_semiring_min_left_i32", "wcc", 2 * sweeps)
    if stragglers:
        raise AssertionError(f"sssp fell back to the host matcher "
                             f"{stragglers} times (PRED_STRAGGLERS)")
    for label, runs in (("bfs", bfs_out), ("sssp", sssp_out)):
        for key, _, run in runs:
            print(f"{label} key {key}: {run}")
    print(f"wcc: {sweeps} sweeps, {wcc['labels'].nunique()} components")
    for label, counts in (("bfs", c_bfs), ("sssp", c_sssp), ("wcc", c_wcc)):
        print(f"{label} path launches: "
              f"{ {k: v for k, v in counts.items() if v} }")
    print(f"PRED_STRAGGLERS over the sssp path: {stragglers}", flush=True)
    paths = {"bfs": c_bfs, "sssp": c_sssp, "wcc": c_wcc}
    return bfs_out, sssp_out, (wcc, sweeps), paths


def _internal(G, ext_ids):
    """External ids to internal ones; -1 stays -1."""
    ext_ids = np.asarray(ext_ids)
    out = np.full(len(ext_ids), -1, np.int64)
    ok = ext_ids >= 0
    out[ok] = G.lookup_internal_vertex_id(ext_ids[ok])
    return out


def check_traversal(Gu, G, lo, hi, wmin, bfs_out, sssp_out, wcc_out):
    """The paths' results against float64 scipy.sparse.csgraph, the
    Graph500 validators (their edge keys sorted once per graph, then
    checked for every key) and a NumPy max-id predecessor pass.  Returns
    scipy's BFS hops and weak component labels, which the multi-device
    phase reuses."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from cugraph_tpu_torch.testing import graph500

    int_inf = np.iinfo(np.int32).max
    f32_max = np.float64(np.finfo(np.float32).max)
    n = Gu.number_of_vertices()
    s, d, w = Gu.edgelist_arrays()  # internal ids, both directions
    A = sp.csr_matrix((w.astype(np.float64), (s, d)), shape=(n, n))

    keys = _internal(Gu, [k for k, _, _ in bfs_out])
    hops = csgraph.shortest_path(A, unweighted=True, indices=keys)
    # the validators' edge keys, sorted once for every key
    verts = bfs_out[0][1]["vertex"].to_numpy()
    edges = graph500._bfs_edges(lo, hi, len(verts), directed=False,
                                vertices=verts)
    for (key, df, _), ref in zip(bfs_out, hops):
        dist = df["distance"].to_numpy()
        want = np.where(np.isinf(ref), int_inf, ref).astype(np.int64)
        if not np.array_equal(dist, want):
            raise AssertionError(f"bfs {key}: {int((dist != want).sum())} "
                                 "distances differ from scipy")
        d64 = dist.astype(np.int64)
        match = (d64[s] < int_inf) & (d64[s] + 1 == d64[d])
        pred_want = np.full(n, -1, np.int64)
        np.maximum.at(pred_want, d[match], s[match])
        pred = _internal(Gu, df["predecessor"].to_numpy())
        if not np.array_equal(pred, pred_want):
            raise AssertionError(f"bfs {key}: predecessors differ from the "
                                 "max-id in-neighbour one level up")
        if not np.array_equal(df["vertex"].to_numpy(), verts):
            raise AssertionError(f"bfs {key}: another vertex order")
        graph500._check_bfs(edges, key, dist, df["predecessor"].to_numpy(),
                            directed=False)
    print(f"bfs: {len(bfs_out)} keys equal scipy's unweighted shortest "
          "paths, predecessors equal the max-id pass, Graph500 trees valid")

    keys = _internal(Gu, [k for k, _, _ in sssp_out])
    dij = csgraph.dijkstra(A, indices=keys)
    edges = graph500._sssp_edges(lo, hi, wmin, len(verts), directed=False,
                                 vertices=verts)
    worst = 0.0
    for (key, df, _), ref in zip(sssp_out, dij):
        dist = df["distance"].to_numpy()
        reached = dist < f32_max
        if not np.array_equal(reached, np.isfinite(ref)):
            raise AssertionError(f"sssp {key}: reachability differs")
        rel = np.abs(dist[reached] - ref[reached]) / np.maximum(
            ref[reached], 1e-30)
        worst = max(worst, float(rel.max()))
        if worst > SSSP_RTOL:
            raise AssertionError(f"sssp {key}: relative error {worst:.3e} "
                                 f"> {SSSP_RTOL} against float64 dijkstra")
        d32 = np.where(reached, dist, np.float32(f32_max)).astype(np.float32)
        ok = (d32[s] < f32_max / 2) & (d32[d] < f32_max / 2)
        tol = np.float32(1e-6) + np.float32(2e-5) * np.abs(d32[d])
        match = ok & (np.abs(d32[s] + w - d32[d]) <= tol) \
            & (d32[s] < d32[d])
        pred_want = np.full(n, -1, np.int64)
        np.maximum.at(pred_want, d[match], s[match])
        pred_want[_internal(Gu, [key])[0]] = -1
        pred = _internal(Gu, df["predecessor"].to_numpy())
        if not np.array_equal(pred, pred_want):
            raise AssertionError(f"sssp {key}: predecessors differ from the "
                                 "max-id strictly closer float32 match")
        if not np.array_equal(df["vertex"].to_numpy(), verts):
            raise AssertionError(f"sssp {key}: another vertex order")
        graph500._check_sssp(edges, key, dist, df["predecessor"].to_numpy(),
                             directed=False)
    print(f"sssp: {len(sssp_out)} keys within rtol {SSSP_RTOL} of float64 "
          f"dijkstra (max relative error {worst:.3e}), predecessors equal "
          "the max-id strictly closer pass, Graph500 trees valid")

    wcc, _ = wcc_out
    nd = G.number_of_vertices()
    s2, d2, _ = G.edgelist_arrays()
    B = sp.csr_matrix((np.ones(len(s2)), (s2, d2)), shape=(nd, nd))
    n_comp, comp = csgraph.connected_components(B, directed=True,
                                                connection="weak")
    minid = np.full(n_comp, nd, np.int64)
    np.minimum.at(minid, comp, np.arange(nd))
    got = _internal(G, wcc["labels"].to_numpy())
    if not np.array_equal(got, minid[comp]):
        raise AssertionError("wcc labels differ from scipy's components "
                             "mapped to their smallest internal id")
    print(f"wcc: {n_comp} components equal scipy's (weak), labels the "
          "smallest internal id", flush=True)
    return {"hops": hops, "wcc": minid[comp], "n_wcc": n_comp}


def _median_s(fn, repeats):
    """Median host seconds of ``fn`` (which ends in a host copy, so the
    device is done), after one warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)), out


def time_traversal(Gu, G, lo, hi, bfs_out, sssp_out, card):
    """Wall time per call (the frame on the host included), Graph500 TEPS,
    the regimes and syncs of each call, and a profile of one bfs."""
    import torch

    from cugraph_tpu_torch import bfs, sssp, weakly_connected_components
    from cugraph_tpu_torch.algos import traversal
    from cugraph_tpu_torch.testing import teps_summary

    g = Gu.structure
    key0 = bfs_out[0][0]
    s0 = int(_internal(Gu, [key0])[0])

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    # the level loops alone, synchronized: the rest of a call is the K3
    # pass, the argument checks and the frame on the host
    bfs_loop_s, _ = _median_s(synced(lambda: traversal._bfs_levels(
        g, s0, g.num_vertices, {"syncs": 0, "dense_levels": 0,
                                "sparse_levels": 0})), 3)
    delta_s, _ = _median_s(lambda: traversal._sssp_delta(Gu), 3)
    delta = np.float32(traversal._sssp_delta(Gu))
    sssp_loop_s, _ = _median_s(synced(lambda: traversal._sssp_nearfar(
        g, s0, delta, {"syncs": 0, "advances": 0, "sparse_iterations": 0,
                       "dense_iterations": 0})), 3)

    bfs(Gu, key0)  # warm-up
    secs, traversed, regimes = [], [], []
    for key, df, _ in bfs_out:
        reached = np.zeros(1 << SCALE, bool)
        reached[df["vertex"].to_numpy()[
            df["distance"].to_numpy() < np.iinfo(np.int32).max]] = True
        traversed.append(int(np.count_nonzero(reached[lo] & reached[hi])))
        t, _ = _median_s(lambda k=key: bfs(Gu, k), 3)
        secs.append(t)
        regimes.append(dict(traversal.LAST_RUN))
    row = {"metric": f"bfs_graph500_rmat{SCALE}_ef{EDGE_FACTOR}",
           "ms_per_call": float(np.median(secs)) * 1e3,
           "ms_per_call_by_key": [t * 1e3 for t in secs],
           "traversed_edges_by_key": traversed,
           **teps_summary(traversed, secs),
           "dense_levels_by_key": [r["dense_levels"] for r in regimes],
           "sparse_levels_by_key": [r["sparse_levels"] for r in regimes],
           "syncs_by_key": [r["syncs"] for r in regimes],
           "level_loop_ms_key0": bfs_loop_s * 1e3, "card": card}
    print(json.dumps(row))
    ssecs, iters = [], []
    for key, _, _ in sssp_out:
        t, _ = _median_s(lambda k=key: sssp(Gu, k), 3)
        ssecs.append(t)
        iters.append(dict(traversal.LAST_RUN))
    print(json.dumps({"metric": f"sssp_graph500_rmat{SCALE}_ef{EDGE_FACTOR}",
                      "ms_per_call": float(np.median(ssecs)) * 1e3,
                      "ms_per_call_by_key": [t * 1e3 for t in ssecs],
                      "runs_by_key": iters,
                      "iteration_loop_ms_key0": sssp_loop_s * 1e3,
                      "delta_heuristic_ms": delta_s * 1e3, "card": card}))
    from cugraph_tpu_torch.algos import components

    t, runs = _median_s(lambda: weakly_connected_components(G), 3)
    print(json.dumps({"metric": f"wcc_rmat{SCALE}_ef{EDGE_FACTOR}_directed",
                      "ms_per_call": t * 1e3,
                      "ms_per_call_runs": [r * 1e3 for r in runs],
                      "sweeps": components.LAST_SWEEPS, "card": card}))

    _device_ms_by_name(lambda: bfs(Gu, key0))  # warm-up
    by_name, window = _device_ms_by_name(lambda: bfs(Gu, key0))
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    print(json.dumps({"profile": f"bfs_graph500_rmat{SCALE} key {key0}",
                      "device_ms": busy if by_name else "not measured",
                      "device_ms_by_kernel": top,
                      "ms_per_call_profiled": window,
                      "ms_per_call_unprofiled": secs[0] * 1e3,
                      "device_idle_share": (1 - busy / window)
                      if by_name else "not measured",
                      "runs": regimes[0], "card": card}), flush=True)
    return row


def _semiring_shape(G, Gu, key):
    """The structure a K2 or K3 mode's path gives it: WCC's (min, left)
    int32 the directed CSC, per_v_random_select's (max, right) and eqsel
    the directed CSR, every other mode the undirected CSC."""
    if key == "min_left_i32":
        return G.structure.csc
    if key in ("max_right", "eqsel"):
        return G.structure.csr
    return Gu.structure.csc


def time_semiring_and_select(Gu, G, card):
    """Each K2 and K3 mode at the shape its path gives it
    (``_semiring_shape``), its plain version,
    and a library yardstick: for K2 the gather (and combine) then
    ``torch.segment_reduce``, since no single PyTorch call computes it,
    and for the int32 modes, which ``segment_reduce`` does not take, the
    gather then one ``scatter_reduce_`` (amin/amax) onto the identity;
    for K3, several calls: gather x, the test, ``torch.where`` to f32 ids
    (exact below 2^24) and ``torch.segment_reduce`` "max" onto -1, held
    equal to the kernel first."""
    import torch

    from cugraph_tpu_torch.kernels.semiring import (spmv_select,
                                                    spmv_select_reference,
                                                    spmv_semiring,
                                                    spmv_semiring_reference)

    rows = {}
    for i, (reduce, combine, is_int) in enumerate(SEMIRING_MODES):
        key = _semiring_key(reduce, combine, is_int)
        adj = _semiring_shape(G, Gu, key)
        n, m = adj.num_vertices, adj.num_edges
        x, w = _semiring_inputs(adj, combine, is_int, i)
        args = (adj.offsets, adj.indices, w, x, reduce, combine)
        ms = _cuda_ms(lambda: spmv_semiring(*args), KERNEL_TIMED_LAUNCHES)
        plain_ms = _cuda_ms(lambda: spmv_semiring_reference(*args), 5)
        idx = adj.indices.to(torch.int64)
        if is_int:
            rows_of = adj.row_ids()
            info = torch.iinfo(torch.int32)
            ident = info.max if reduce == "min" else info.min
            library_ms = _cuda_ms(lambda: torch.full(
                (n,), ident, dtype=torch.int32, device=x.device
            ).scatter_reduce_(0, rows_of, x[idx], f"a{reduce}"),
                KERNEL_TIMED_LAUNCHES // 10)
        else:
            off = adj.offsets.to(torch.int64)
            ident = 1e30 if reduce == "min" else -1e30

            def values():
                if combine == "right":
                    return w
                xv = x[idx]
                return xv if combine == "left" else (
                    xv + w if combine == "add" else xv * w)

            library_ms = _cuda_ms(lambda: torch.segment_reduce(
                values(), reduce, offsets=off, initial=ident),
                KERNEL_TIMED_LAUNCHES // 10)
        rows[key] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": semiring_bound_ms(n, m, combine),
                     "bound_by": "bytes", "library_ms": library_ms}
        print(f"spmv_semiring_{key} at n={n} m={m}: "
              + json.dumps(rows[key]) + f" [{card}]", flush=True)
    for i, mode in enumerate(SELECT_MODES):
        adj = _semiring_shape(G, Gu, mode)
        n, m = adj.num_vertices, adj.num_edges
        idx, rows_of = adj.indices.to(torch.int64), adj.row_ids()
        off, ids = adj.offsets.to(torch.int64), adj.indices.to(torch.float32)
        x, w, atol, rtol = _select_inputs(adj, mode, 100 + i)
        kind = "eqsel" if mode == "eqsel" else "eqsel_rel"
        args = (adj.offsets, adj.indices, w, x, kind, atol, rtol)

        def composite():
            xr = x[rows_of]
            if kind == "eqsel":
                hit = w == xr
            else:
                xu = x[idx]
                tol = atol + rtol * xr.abs()
                hit = ((xu + (1.0 if w is None else w) - xr).abs() <= tol) \
                    & (xu < xr)
            return torch.segment_reduce(torch.where(hit, ids, -1.0), "max",
                                        offsets=off, initial=-1.0)

        y = spmv_select(*args)
        if not torch.equal(composite().to(torch.int32), y):
            raise AssertionError(f"spmv_select_{mode}: the composite "
                                 "library route differs from the kernel")
        rows[mode] = {
            "ms": _cuda_ms(lambda: spmv_select(*args), KERNEL_TIMED_LAUNCHES),
            "plain_ms": _cuda_ms(lambda: spmv_select_reference(*args), 5),
            "bound_ms": semiring_bound_ms(n, m, mode, hits=int(
                (w == x[rows_of]).sum()) if mode == "eqsel" else 0),
            "bound_by": "bytes",
            "library_ms": _cuda_ms(composite, KERNEL_TIMED_LAUNCHES // 10),
            "library": "several calls: gather, test, where, segment_reduce"}
        print(f"spmv_select_{mode} at n={n} m={m}: "
              + json.dumps(rows[mode]) + f" [{card}]", flush=True)
    return rows


# -- K4 and K5: the sum and min/max SpMM; the analytics paths -----------------

SPMM_SOURCE = "cugraph_tpu_torch/kernels/csrc/spmm_csr.cu"
SPMM_SEMIRING_SOURCE = "cugraph_tpu_torch/kernels/csrc/spmm_semiring.cu"
SPMM_REPLACES = "cugraph_tpu/kernels/spmm_onehot.py:332"
SPMM_SEMIRING_REPLACES = "cugraph_tpu/kernels/spmm_onehot.py:365"
PANEL = 128  # the width of every panel on the analytics paths
SPMM_WIDTHS = (1, 3, 128, 130)
# every K5 mode; (min, add) is on the weighted OD path, the rest have no
# cugraph_tpu caller
SPMM_SEMIRING_MODES = [("min", "add"), ("max", "add"), ("min", "left"),
                       ("max", "left"), ("min", "mul"), ("max", "mul")]
BC_K, BC_SEED = 128, 0
MSBFS_SOURCES = 32
OD_ORIGINS = 128
OD_DIJKSTRA_ORIGINS = 8
OD_SEED, OD_DEST_SEED = 7, 8
# float32 distances summed along paths of tens of edges, one rounding of
# 2^-24 each, as SSSP_RTOL
OD_RTOL = 1e-6
# relative L1 of betweenness against the float64 Brandes: sigma and delta
# round once per level and operation in float32 (2^-24), over ~10 levels
BC_L1_TOL = 1e-5
NX_ATOL = 1e-4
NETSCIENCE = os.path.join("cugraph_tpu", "datasets", "data",
                          "netscience.csv")


def _spmm_mode_key(weighted):
    return "weighted" if weighted else "unit"


# the heavy-row cases: every width of the paths (GCN's 40, the hidden 256)
# and the ragged ones, on graphs cut at each kernel's span
HEAVY_WIDTHS = (1, 3, 40, 128, 130, 256)


def heavy_row_cases(device):
    """(name, span, GraphStructure) at the span of each kernel that splits
    rows (K1-K5) and at 32, from
    ``cugraph_tpu_torch.testing.heavy_rows``: rows of degree span - 1,
    span, span + 1, 2 span and 3 span + 5 (stars plus parallel edges), a
    heavy row on a span boundary, two back to back, empty rows between
    heavy rows, a heavy last row and m not a multiple of the span."""
    from cugraph_tpu_torch.kernels import semiring, spmm, spmv
    from cugraph_tpu_torch.testing.heavy_rows import heavy_row_edges

    by_span = {}
    for label, span in (("k1", spmv.SPMV_SPAN),
                        ("k2", semiring.SPMV_SEMIRING_SPAN),
                        ("k3", semiring.SPMV_SELECT_SPAN),
                        ("k4", spmm.SPMM_SPAN),
                        ("k5", spmm.SPMM_SEMIRING_SPAN), ("small", 32)):
        by_span.setdefault(span, []).append(label)
    out = []
    for span, labels in by_span.items():
        n, src, dst, w = heavy_row_edges(span, seed=span)
        out.append((f"heavy {'/'.join(labels)} T={span}", span,
                    _case(n, src, dst, w, device)))
    return out


def check_heavy_rows(device, hold_vjp):
    """K1 (both modes), K4 (unit and weighted), K4's VJP, and every K2, K3
    and K5 mode on the heavy-row cases, over the CSC and the CSR, against
    their plain versions, two launches bit-identical; K2, K3 and K5 also
    at the case's span and with NaNs and signed zeros.  Returns K1's and
    K4's max abs errors."""
    k1_err, k4_err = {}, {}
    for name, span, gs in heavy_row_cases(device):
        for side, adj in (("csc", gs.csc), ("csr", gs.csr)):
            for combine in ("mul", "left"):
                err = check_kernel(f"{name} {side}", adj, combine)
                k1_err[combine] = max(k1_err.get(combine, 0.0), err)
            for key, err in check_spmm(f"{name} {side}", adj,
                                       HEAVY_WIDTHS).items():
                k4_err[key] = max(k4_err.get(key, 0.0), err)
            check_min_max(f"{name} {side}", adj, span, HEAVY_WIDTHS)
        hold_vjp(name, gs, HEAVY_WIDTHS)
    return k1_err, k4_err


def check_min_max(name, adj, span, widths, seed=0):
    """Every K2 mode (int32 arms included), every K3 mode and every K5
    mode at each width on one CSR, through their launchers at the
    wrappers' spans and at ``span``, against the plain versions exactly
    (NaN matching NaN), two launches bit-identical; the fp32 K2 and K5
    modes also with the NaNs and signed zeros of
    ``testing.heavy_rows.nan_and_signed_zeros``, whose outputs must hold a
    NaN and give the zero row -0.0 for min and +0.0 for max, and K3 with
    those of ``select_nan_and_signed_zeros``, whose NaNs are never
    selected (``hold_select_specials``; a check that finds no NaN fails
    as vacuous)."""
    import torch

    from cugraph_tpu_torch.kernels import semiring, spmm
    from cugraph_tpu_torch.testing.heavy_rows import (
        hold_select_specials, nan_and_signed_zeros,
        select_nan_and_signed_zeros)

    off, idx = adj.offsets.cpu().numpy(), adj.indices.cpu().numpy()
    w_host = adj.weights.cpu().numpy()
    dev = adj.device

    def variants(x, combine):
        """(special rows or None, x, w), NumPy: the plain inputs, and in
        fp32 the NaNs and signed zeros."""
        yield None, x, w_host
        if x.dtype == np.float32:
            xs, ws, rows = nan_and_signed_zeros(off, idx, x, w_host, combine)
            yield rows, xs, ws

    def hold(label, launch, plain, args, reduce, rows):
        ref = plain(*args)
        _hold_exact(label, launch(*args), launch(*args), ref)
        if rows is not None:
            zero = ref[rows[2]]
            if not (bool(torch.isnan(ref[rows[0]]).any())
                    and bool(torch.isnan(ref[rows[1]]).any())):
                raise AssertionError(f"{label}: no NaN where one was put; "
                                     "the check is vacuous")
            if not bool(((zero == 0) & (torch.signbit(zero)
                                        == (reduce == "min"))).all()):
                raise AssertionError(f"{label}: the zero row is {zero}")

    n_checked = 0
    for i, (reduce, combine, is_int) in enumerate(SEMIRING_MODES):
        x, _ = _semiring_inputs(adj, combine, is_int, seed + i)
        for rows, xv, wv in variants(x.cpu().numpy(), combine):
            args = (adj.offsets, adj.indices,
                    None if combine == "left" else
                    torch.from_numpy(wv).to(dev),
                    torch.from_numpy(xv).to(dev), reduce, combine)
            for t in sorted({semiring.SPMV_SEMIRING_SPAN, span}):
                hold(f"{name}/spmv_semiring_"
                     f"{_semiring_key(reduce, combine, is_int)} T={t}"
                     + (" nan/zeros" if rows else ""),
                     functools.partial(semiring._launch_semiring, span=t),
                     semiring.spmv_semiring_reference, args, reduce, rows)
                n_checked += 1
    for i, mode in enumerate(SELECT_MODES):
        x, w, atol, rtol = _select_inputs(adj, mode, seed + 100 + i)
        x, w = x.cpu().numpy(), (w_host if w is None else w.cpu().numpy())
        kind = "eqsel" if mode == "eqsel" else "eqsel_rel"
        xs, ws, specials = select_nan_and_signed_zeros(off, idx, x, w, mode)
        for where, xv, wv in ((None, x, w), (specials, xs, ws)):
            args = (adj.offsets, adj.indices,
                    None if mode == "eqsel_rel_unit" else
                    torch.from_numpy(wv).to(dev),
                    torch.from_numpy(xv).to(dev), kind, atol, rtol)
            for t in sorted({semiring.SPMV_SELECT_SPAN, span}):
                label = (f"{name}/spmv_select_{mode} T={t}"
                         + (" nan/zeros" if where else ""))
                y = semiring._launch_select(*args, span=t)
                _hold_exact(label, y, semiring._launch_select(*args, span=t),
                            semiring.spmv_select_reference(*args))
                if where is not None:
                    hold_select_specials(y.cpu().numpy(), off, idx, xv, wv,
                                         mode, where, label)
                elif adj.num_edges and not bool((y >= 0).any()):
                    raise AssertionError(f"{label}: no row selected "
                                         "anything; the check is vacuous")
                n_checked += 1
    rng = np.random.default_rng(seed)
    for f in widths:
        x = (rng.random((adj.num_vertices, f)) * 10).astype(np.float32)
        x[::7] = 1e30  # unreached vertices
        for reduce, combine in SPMM_SEMIRING_MODES:
            for rows, xv, wv in variants(x, combine):
                args = (adj.offsets, adj.indices,
                        None if combine == "left" else
                        torch.from_numpy(wv).to(dev),
                        torch.from_numpy(xv).to(dev), reduce, combine)
                for t in sorted({spmm.SPMM_SEMIRING_SPAN, span}):
                    hold(f"{name}/spmm_semiring_{reduce}_{combine} F={f} "
                         f"T={t}" + (" nan/zeros" if rows else ""),
                         functools.partial(spmm._launch_semiring, span=t),
                         spmm.spmm_semiring_reference, args, reduce, rows)
                    n_checked += 1
    print(f"kernel check {name:>12s} K2/K3/K5: n={adj.num_vertices} "
          f"m={adj.num_edges} F={list(widths)} spans K2 "
          f"{sorted({semiring.SPMV_SEMIRING_SPAN, span})} K3 "
          f"{sorted({semiring.SPMV_SELECT_SPAN, span})} K5 "
          f"{sorted({spmm.SPMM_SEMIRING_SPAN, span})}: {n_checked} "
          "launch pairs equal to the plain versions (NaN matching NaN; "
          "the NaN and signed-zero cases hold their NaNs and -0.0/+0.0, "
          "K3 selects no NaN), two launches bit-identical", flush=True)


def check_spmm(name, adj, widths, seed=0):
    """K4 (weighted and unit) and every K5 mode against their plain
    versions on one CSR at each width: K4 within rtol 1e-5 (both sum in
    float64, in another order; the inputs are positive), K5 bit for bit;
    two launches bit-identical.  Returns {mode: max abs error}."""
    import torch

    from cugraph_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_reference,
                                                spmm_semiring,
                                                spmm_semiring_reference)

    errs = {}
    rng = np.random.default_rng(seed)
    for f in widths:
        x = torch.from_numpy((rng.random((adj.num_vertices, f)) * 10).astype(
            np.float32)).to(adj.device)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, adj.num_edges).astype(
            np.float32)).to(adj.device)
        for weights in (w, None):
            key = f"spmm_csr_sum_{_spmm_mode_key(weights is not None)}"
            args = (adj.offsets, adj.indices, weights, x)
            y1, y2 = spmm_csr(*args), spmm_csr(*args)
            ref = spmm_csr_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(y1.view(torch.int32), y2.view(torch.int32)):
                raise AssertionError(f"{name}/{key} F={f}: two launches "
                                     "differ")
            err = (y1 - ref).abs()
            if y1.shape != ref.shape or bool((err > RTOL * ref.abs()).any()):
                raise AssertionError(
                    f"{name}/{key} F={f}: off its plain version by "
                    f"{float(err.max()):.3e} (rtol {RTOL})")
            errs[key] = max(errs.get(key, 0.0),
                            float(err.max()) if err.numel() else 0.0)
        xs = x.clone()
        xs[::7] = 1e30  # unreached vertices
        for reduce, combine in SPMM_SEMIRING_MODES:
            key = f"spmm_semiring_{reduce}_{combine}"
            args = (adj.offsets, adj.indices,
                    None if combine == "left" else w, xs, reduce, combine)
            _hold_exact(f"{name}/{key} F={f}", spmm_semiring(*args),
                        spmm_semiring(*args), spmm_semiring_reference(*args))
            errs[key] = 0.0
    k4_err = max(errs["spmm_csr_sum_unit"], errs["spmm_csr_sum_weighted"])
    print(f"kernel check {name:>12s} K4/K5: n={adj.num_vertices} "
          f"m={adj.num_edges} F={list(widths)}: K4 within rtol {RTOL} "
          f"(max abs err {k4_err:.3e}), every K5 mode bit-identical, two "
          "launches bit-identical", flush=True)
    return errs


def _reset_spmm_counts():
    from cugraph_tpu_torch.kernels import spmm

    _reset_counts()
    for counts in (spmm.SPMM_LAUNCHES, spmm.SPMM_SEMIRING_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _read_spmm_counts():
    from cugraph_tpu_torch.kernels import spmm

    out = _read_counts()
    out.update({f"spmm_csr_sum_{k}": v for k, v in spmm.SPMM_LAUNCHES.items()})
    out.update({f"spmm_semiring_{k}": v for k, v in
                spmm.SPMM_SEMIRING_LAUNCHES.items()})
    return out


def analytics_inputs(G, Gu):
    """Origins: OD_ORIGINS vertices of out-degree >= 1 in the directed
    graph, from OD_SEED; the multi-source BFS sources are the first
    MSBFS_SOURCES of them.  Destinations: OD_ORIGINS vertices of degree
    >= 1, from OD_DEST_SEED.  External ids."""
    src, dst, _ = G.edgelist_arrays()
    n = G.number_of_vertices()
    out_deg = np.bincount(src, minlength=n)
    origins = np.random.default_rng(OD_SEED).choice(
        np.flatnonzero(out_deg > 0), size=OD_ORIGINS, replace=False)
    present = np.flatnonzero(np.bincount(np.concatenate([src, dst]),
                                         minlength=n) > 0)
    dests = np.random.default_rng(OD_DEST_SEED).choice(
        present, size=OD_ORIGINS, replace=False)
    ext = G.number_map.to_external
    return ext(origins), ext(dests)


def analytics_paths(G, Gu, origins, dests):
    """The four analytics calls through the public entry points, each with
    the launch counts set to 0 just before and read just after.  Brandes's
    K4 calls are also told apart by orientation (CSC pull, CSR push)."""
    from cugraph_tpu_torch import (betweenness_centrality,
                                   edge_betweenness_centrality,
                                   multi_source_bfs, od_shortest_distances)
    from cugraph_tpu_torch.algos import centrality, traversal

    g = G.structure
    by_orientation = {"csc": 0, "csr": 0}
    real = centrality.spmm_by_major

    def tally(adj, x, *, unit):
        by_orientation["csc" if adj is g.csc else "csr"] += 1
        return real(adj, x, unit=unit)

    out, counts, runs = {}, {}, {}
    centrality.spmm_by_major = tally
    try:
        for name, call in (
                ("betweenness_centrality", lambda: betweenness_centrality(
                    G, k=BC_K, seed=BC_SEED)),
                ("edge_betweenness_centrality",
                 lambda: edge_betweenness_centrality(G, k=BC_K,
                                                     seed=BC_SEED))):
            by_orientation.update(csc=0, csr=0)
            _reset_spmm_counts()
            out[name] = call()
            counts[name] = _read_spmm_counts()
            runs[name] = dict(centrality.LAST_RUN, **by_orientation)
            k4 = counts[name]["spmm_csr_sum_unit"]
            if by_orientation["csc"] == 0 or by_orientation["csr"] == 0 \
                    or k4 != by_orientation["csc"] + by_orientation["csr"]:
                raise AssertionError(
                    f"{name}: {k4} K4 unit launches for "
                    f"{by_orientation} calls on the CSC and the CSR")
    finally:
        centrality.spmm_by_major = real
    for name, call, graph in (
            ("multi_source_bfs", lambda: multi_source_bfs(
                G, origins[:MSBFS_SOURCES]), G),
            ("od_weighted", lambda: od_shortest_distances(Gu, origins,
                                                          dests), Gu),
            ("od_unweighted", lambda: od_shortest_distances(G, origins,
                                                            dests), G)):
        _reset_spmm_counts()
        out[name] = call()
        counts[name] = _read_spmm_counts()
        runs[name] = dict(traversal.LAST_RUN)
    for name, key in (("multi_source_bfs", "spmm_csr_sum_unit"),
                      ("od_weighted", "spmm_semiring_min_add"),
                      ("od_unweighted", "spmm_csr_sum_unit")):
        if counts[name][key] == 0:
            raise AssertionError(f"{name} launched {key} no time")
    for name in out:
        print(f"{name}: {runs[name]}; launches "
              f"{ {k: v for k, v in counts[name].items() if v} }",
              flush=True)
    return out, counts, runs


def _panel_brandes_f64(G, sources, edges):
    """The same panel Brandes in float64 with torch.sparse products: the
    check for betweenness on the card.  Returns (bc [n], edge
    dependencies [m] in CSR order) on the host, unscaled."""
    import torch

    g = G.structure
    n, dev = g.num_vertices, g.device
    ones = torch.ones(g.num_edges, dtype=torch.float64, device=dev)
    with warnings.catch_warnings():  # "beta" and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        pull, push = (torch.sparse_csr_tensor(adj.offsets.long(),
                                              adj.indices.long(), ones,
                                              (n, n))
                      for adj in (g.csc, g.csr))
    rows, cols = g.csr.row_ids(), g.csr.indices.long()
    bc = torch.zeros(n, dtype=torch.float64, device=dev)
    edep = torch.zeros(g.num_edges, dtype=torch.float64, device=dev)
    for i in range(0, len(sources), PANEL):
        src = torch.as_tensor(sources[i:i + PANEL], device=dev).long()
        onehot = torch.arange(n, device=dev)[:, None] == src[None, :]
        dist = torch.where(onehot, 0, -1)
        sigma = onehot.double()
        level = 0
        while True:
            sig_in = pull @ torch.where(dist == level, sigma, 0.0)
            newly = (dist == -1) & (sig_in > 0)
            dist.masked_fill_(newly, level + 1)
            sigma += torch.where(newly, sig_in, 0.0)
            level += 1
            if not bool(newly.any()):
                break
        delta = torch.zeros_like(sigma)
        for lv in range(level - 1, -1, -1):
            y = torch.where(dist == lv + 1, (1 + delta) / sigma.clamp(min=1),
                            0.0)
            a = torch.where(dist == lv, sigma, 0.0)
            delta += a * (push @ y)
            if edges:
                for e0 in range(0, g.num_edges, 1 << 19):
                    e1 = e0 + (1 << 19)
                    edep[e0:e1] += (a[rows[e0:e1]] * y[cols[e0:e1]]).sum(1)
        bc += torch.where(onehot, 0.0, delta).sum(1)
    return bc.cpu().numpy(), edep.cpu().numpy()


SCIPY_WORKERS = 8   # the chip host's cores


def _hops_chunk(args):
    """One worker's rows of ``unweighted_hops``."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    indptr, indices, n, sources = args
    A = sp.csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n))
    return csgraph.shortest_path(A, unweighted=True, indices=sources)


def unweighted_hops(A, sources):
    """scipy's unweighted shortest paths from each of ``sources`` over the
    CSR matrix ``A``, float64 [len(sources), n]: the rows of one
    ``csgraph.shortest_path`` call, with the sources split over
    SCIPY_WORKERS processes, since scipy's search holds the GIL and each
    source's is independent (the analytics' 128 sources on the host of
    the NVIDIA H100 machine: 33.2-35.5 s in one process over three runs,
    16.1-22.6 s in eight over four)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    chunks = np.array_split(np.asarray(sources), SCIPY_WORKERS)
    args = [(A.indptr, A.indices, A.shape[0], c) for c in chunks if len(c)]
    with ProcessPoolExecutor(len(args), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        return np.vstack(list(pool.map(_hops_chunk, args)))


def _rel_l1(got, want):
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-300))


def check_analytics(G, Gu, origins, dests, out):
    """The analytics results against independent references: scipy's
    unweighted shortest paths (multi-source BFS distances, the unweighted
    OD), float64 Dijkstra on OD_DIJKSTRA_ORIGINS origins (the weighted OD),
    a float64 panel Brandes with torch.sparse products (betweenness), and
    networkx on netscience."""
    import networkx as nx
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from cugraph_tpu_torch import Graph, betweenness_centrality
    from cugraph_tpu_torch.algos import centrality

    n = G.number_of_vertices()
    int_inf = np.iinfo(np.int32).max
    f32_max = np.float64(np.finfo(np.float32).max)
    s, d, _ = G.edgelist_arrays()
    A = sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    o_int = _internal(G, origins)
    d_int = _internal(G, dests)
    t0 = time.perf_counter()
    hops = unweighted_hops(A, o_int)
    t_scipy = time.perf_counter() - t0

    df = out["multi_source_bfs"]
    vid = _internal(G, df["vertex"].to_numpy())
    edge_keys = np.sort(s.astype(np.int64) * n + d)
    for b, src_ext in enumerate(origins[:MSBFS_SOURCES]):
        dist = np.empty(n, np.int64)
        dist[vid] = df[f"distance_{src_ext}"].to_numpy()
        want = np.where(np.isinf(hops[b]), int_inf, hops[b]).astype(np.int64)
        if not np.array_equal(dist, want):
            raise AssertionError(f"multi_source_bfs {src_ext}: "
                                 f"{int((dist != want).sum())} distances "
                                 "differ from scipy")
        pred = np.full(n, -1, np.int64)
        pred[vid] = _internal(G, df[f"predecessor_{src_ext}"].to_numpy())
        child = np.flatnonzero(pred >= 0)
        keys = pred[child] * n + child
        pos = np.minimum(np.searchsorted(edge_keys, keys), len(edge_keys) - 1)
        if not (np.array_equal(edge_keys[pos], keys)
                and np.array_equal(dist[pred[child]] + 1, dist[child])
                and np.array_equal(np.flatnonzero((dist > 0)
                                                  & (dist < int_inf)),
                                   child)):
            raise AssertionError(f"multi_source_bfs {src_ext}: a "
                                 "predecessor is not an in-neighbour one "
                                 "level up")
    print(f"multi_source_bfs: {MSBFS_SOURCES} sources equal scipy's "
          "unweighted shortest paths; every predecessor is an in-neighbour "
          f"one level up (scipy {t_scipy:.1f} s for {len(o_int)} sources)")
    # the device predecessor pass against the NumPy write it replaced
    from cugraph_tpu_torch.api.convenience import _predecessors_numpy

    s64, d64 = s.astype(np.int64), d.astype(np.int64)
    t0 = time.perf_counter()
    for src_ext in origins[:MSBFS_NUMPY_SOURCES]:
        dist = np.empty(n, np.int64)
        dist[vid] = df[f"distance_{src_ext}"].to_numpy()
        want = _predecessors_numpy(s64, d64,
                                   np.where(dist == int_inf, -1, dist))
        pred = np.full(n, -1, np.int64)
        pred[vid] = _internal(G, df[f"predecessor_{src_ext}"].to_numpy())
        if not np.array_equal(pred, want):
            raise AssertionError(f"multi_source_bfs {src_ext}: predecessors "
                                 "differ from the NumPy pass")
    print(f"multi_source_bfs: predecessors of {MSBFS_NUMPY_SOURCES} sources "
          "equal the NumPy pass bit for bit "
          f"({(time.perf_counter() - t0) / MSBFS_NUMPY_SOURCES:.2f} s per "
          "source on the host)", flush=True)

    def od_matrix(frame):
        return frame["distance"].to_numpy().reshape(len(origins), len(dests))

    got = od_matrix(out["od_unweighted"])
    want = np.where(np.isinf(hops[:, d_int]), f32_max, hops[:, d_int])
    if not np.array_equal(got, want):
        raise AssertionError(f"od unweighted: {int((got != want).sum())} "
                             "pairs differ from scipy")
    print(f"od_shortest_distances unweighted: {got.size} pairs equal "
          f"scipy's ({int((got == f32_max).sum())} unreachable)")

    su, du, wu = Gu.edgelist_arrays()
    nu = Gu.number_of_vertices()
    Au = sp.csr_matrix((wu.astype(np.float64), (su, du)), shape=(nu, nu))
    t0 = time.perf_counter()
    dij = csgraph.dijkstra(Au, indices=_internal(
        Gu, origins[:OD_DIJKSTRA_ORIGINS]))[:, _internal(Gu, dests)]
    t_dij = time.perf_counter() - t0
    got = od_matrix(out["od_weighted"])[:OD_DIJKSTRA_ORIGINS]
    reached = np.isfinite(dij)
    if not np.array_equal(got < f32_max, reached):
        raise AssertionError("od weighted: reachability differs from "
                             "dijkstra")
    rel = np.abs(got[reached] - dij[reached]) / np.maximum(dij[reached],
                                                          1e-30)
    od_err = float(rel.max()) if rel.size else 0.0
    if od_err > OD_RTOL:
        raise AssertionError(f"od weighted: relative error {od_err:.3e} > "
                             f"{OD_RTOL} against float64 dijkstra")
    print(f"od_shortest_distances weighted: {OD_DIJKSTRA_ORIGINS} origins x "
          f"{len(dests)} destinations within rtol {OD_RTOL} of float64 "
          f"dijkstra (max relative error {od_err:.3e}; dijkstra "
          f"{t_dij:.1f} s)")

    sources = centrality._sources(G, BC_K, BC_SEED)
    bc64, edep64 = _panel_brandes_f64(G, sources, edges=True)
    scale = centrality._bc_scale(G, len(sources), True, n)
    bc = _by_internal_id(G, out["betweenness_centrality"],
                         "betweenness_centrality")
    bc_l1 = _rel_l1(bc, bc64 * scale)
    e = out["edge_betweenness_centrality"]
    csr = G.structure.csr
    key = (csr.row_ids().cpu().numpy() * n + csr.indices.cpu().numpy())
    got_key = _internal(G, e["src"].to_numpy()) * n + _internal(
        G, e["dst"].to_numpy())
    order = np.argsort(got_key)
    if not np.array_equal(got_key[order], np.sort(key)):
        raise AssertionError("edge_betweenness_centrality: the edge set "
                             "differs from the CSR's")
    escale = 1.0 / (n * (n - 1)) * n / len(sources)
    ebc = e["betweenness_centrality"].to_numpy()[order]
    ebc_l1 = _rel_l1(ebc, (edep64 * escale)[np.argsort(key)])
    if not (bc_l1 <= BC_L1_TOL and ebc_l1 <= BC_L1_TOL):
        raise AssertionError(f"betweenness: relative L1 {bc_l1:.3e} "
                             f"(vertices), {ebc_l1:.3e} (edges) > "
                             f"{BC_L1_TOL} against the float64 Brandes")
    print(f"betweenness k={BC_K}: relative L1 against the float64 Brandes "
          f"{bc_l1:.3e} (vertices), {ebc_l1:.3e} (edges), <= {BC_L1_TOL}")

    a = np.loadtxt(NETSCIENCE)
    Gn = Graph(device=G.device).from_edgelist(a[:, 0].astype(np.int64),
                                              a[:, 1].astype(np.int64), None)
    got = betweenness_centrality(Gn)
    Gnx = nx.Graph()
    Gnx.add_edges_from(a[:, :2].astype(np.int64).tolist())
    ref = nx.betweenness_centrality(Gnx)
    worst = max(abs(v - ref[u]) for u, v in zip(
        got["vertex"].tolist(), got["betweenness_centrality"].tolist()))
    if worst > NX_ATOL:
        raise AssertionError(f"netscience betweenness: off networkx by "
                             f"{worst:.3e} > {NX_ATOL}")
    print(f"netscience betweenness ({Gn.number_of_vertices()} vertices, "
          f"{centrality.LAST_RUN['panels']} panels): within {worst:.3e} of "
          f"networkx (atol {NX_ATOL})", flush=True)
    return {"od_rel_err": od_err, "bc_rel_l1": bc_l1, "ebc_rel_l1": ebc_l1,
            "netscience_max_abs_err": worst}


def time_analytics(G, Gu, origins, dests, runs, card):
    """Wall time per call of the four analytics functions (the frame on the
    host included; the path runs were the warm-up), with their levels or
    iterations and syncs, and a profile of one betweenness call by kernel."""
    import torch

    from cugraph_tpu_torch import (betweenness_centrality,
                                   edge_betweenness_centrality,
                                   multi_source_bfs, od_shortest_distances)

    calls = {
        "betweenness_centrality": (lambda: betweenness_centrality(
            G, k=BC_K, seed=BC_SEED), 3),
        "edge_betweenness_centrality": (lambda: edge_betweenness_centrality(
            G, k=BC_K, seed=BC_SEED), 2),
        "multi_source_bfs": (lambda: multi_source_bfs(
            G, origins[:MSBFS_SOURCES]), 1),
        "od_weighted": (lambda: od_shortest_distances(Gu, origins, dests),
                        2),
        "od_unweighted": (lambda: od_shortest_distances(G, origins, dests),
                          2),
    }
    wall = {}
    for name, (call, repeats) in calls.items():
        out = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            out.append(time.perf_counter() - t0)
        wall[name] = float(np.median(out)) * 1e3
        print(json.dumps({"metric": f"{name}_rmat{SCALE}_ef{EDGE_FACTOR}",
                          "ms_per_call": wall[name],
                          "ms_per_call_runs": [t * 1e3 for t in out],
                          "run": runs[name], "card": card}), flush=True)
    for name, label in (("betweenness_centrality", f"k={BC_K}"),
                        ("multi_source_bfs", f"{MSBFS_SOURCES} sources")):
        by_name, window = _device_ms_by_name(calls[name][0])
        busy = sum(by_name.values())
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
        print(json.dumps({"profile": f"{name}_rmat{SCALE} {label}",
                          "device_ms": busy if by_name else "not measured",
                          "device_ms_by_kernel": top,
                          "ms_per_call_profiled": window,
                          "ms_per_call_unprofiled": wall[name],
                          "device_idle_share": (1 - busy / window)
                          if by_name else "not measured",
                          "run": runs[name], "card": card}), flush=True)
    return wall


def spmm_bound_ms(n, m, f, weighted):
    """Least time for one K4 or K5 launch: bytes (offsets, indices, the
    weights if read, X and Y, each once) at the HBM rate, or 2 m F
    operations at the fp32 rate."""
    bytes_moved = 4 * (n + 1) + (8 if weighted else 4) * m + 8 * n * f
    return max(bytes_moved / PEAK_BYTES_PER_S,
               2 * m * f / PEAK_FP32_PER_S) * 1e3


def time_spmm(G, Gu, card):
    """K4 (unit on the directed CSC, the Brandes pull and BFS panel shape;
    weighted on the same CSC with random weights) and every K5 mode on the
    undirected CSC (the weighted OD shape), at F = 128: the kernel, its
    plain version, and a library yardstick: for K4 one torch.sparse CSR
    product, for K5 gather, combine and ``torch.segment_reduce`` in feature
    chunks (several calls; no single PyTorch call computes it)."""
    import torch

    from cugraph_tpu_torch.kernels import spmm

    rows = {}
    rng = np.random.default_rng(3)
    adj = G.structure.csc
    n, m = adj.num_vertices, adj.num_edges
    x = torch.from_numpy(rng.random((n, PANEL), dtype=np.float32)).to(
        adj.device)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(np.float32)).to(
        adj.device)
    for weighted in (False, True):
        weights = w if weighted else None
        args = (adj.offsets, adj.indices, weights, x)
        values = w if weighted else torch.ones_like(w)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(adj.offsets, adj.indices, values,
                                        (n, n), check_invariants=False)
        key = f"spmm_csr_sum_{_spmm_mode_key(weighted)}"
        rows[key] = {
            "ms": _cuda_ms(lambda: spmm.spmm_csr(*args), 10),
            "plain_ms": _cuda_ms(lambda: spmm.spmm_csr_reference(*args), 2),
            "bound_ms": spmm_bound_ms(n, m, PANEL, weighted),
            "bound_by": "bytes",
            "library_ms": _cuda_ms(lambda: A @ x, 10)}
        print(f"{key} at n={n} m={m} F={PANEL}: " + json.dumps(rows[key])
              + f" [{card}]", flush=True)
    adj = Gu.structure.csc
    n, m = adj.num_vertices, adj.num_edges
    x = torch.from_numpy((rng.random((n, PANEL)) * 10).astype(
        np.float32)).to(adj.device)
    x[::7] = 1e30
    idx = adj.indices.to(torch.int64)
    off = adj.offsets.to(torch.int64)
    for reduce, combine in SPMM_SEMIRING_MODES:
        weights = None if combine == "left" else adj.weights
        args = (adj.offsets, adj.indices, weights, x, reduce, combine)
        ident = 1e30 if reduce == "min" else -1e30

        def library():
            for f0, f1 in spmm._feature_chunks(PANEL, m, 4):
                vals = x[:, f0:f1].index_select(0, idx)
                if combine == "add":
                    vals.add_(weights[:, None])
                elif combine == "mul":
                    vals.mul_(weights[:, None])
                torch.segment_reduce(vals, reduce, offsets=off, axis=0,
                                     initial=ident)

        key = f"spmm_semiring_{reduce}_{combine}"
        rows[key] = {
            "ms": _cuda_ms(lambda: spmm.spmm_semiring(*args), 10),
            "plain_ms": _cuda_ms(
                lambda: spmm.spmm_semiring_reference(*args), 2),
            "bound_ms": spmm_bound_ms(n, m, PANEL, combine != "left"),
            "bound_by": "bytes", "library_ms": _cuda_ms(library, 2),
            "library": "several calls: gather, combine, segment_reduce "
                       "in feature chunks"}
        print(f"{key} at n={n} m={m} F={PANEL}: " + json.dumps(rows[key])
              + f" [{card}]", flush=True)
    return rows


# -- K4's VJP and the GNN training path ---------------------------------------

VJP_REPLACES = "cugraph_tpu/kernels/spmm_onehot.py:529"
VJP_WIDTHS = (1, 3, 40, 128, 130)
# BASELINE.json's GNN row at ogbn-arxiv's widths: 128 features, 40 classes;
# hidden 256 (the OGB arxiv example), 2 layers
GNN_IN, GNN_HIDDEN, GNN_CLASSES = 128, 256, 40
GNN_SEED = 0
GNN_LR = 1e-2
SAGE_STEPS, GCN_STEPS = 5, 2
GNN_TIMED_STEPS = 10
# first step against a float64 model with the same weights: K4 rounds its
# float64 sums once (2^-24); the float32 GEMMs sum over K <= 256 forward
# (~1e-7 relative); but a weight gradient sums n = 646 k terms of mixed
# sign, whose cancellation magnifies float32 rounding: a few 1e-5
# relative L2 on the first layer's; the loss is a mean of n/2 positive
# terms
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_RTOL = 1e-4  # relative L2, per gradient


def check_spmm_vjp(name, g, widths, seed=0):
    """K4's VJP through ``get_structure_spmm_fn``: Y = A·X against the
    plain K4 over the CSC, and the gradient of <Y, G> against the plain K4
    over the CSR applied to G, within rtol 1e-5 (both sum in float64); two
    backward launches bit-identical and counted.  Returns the max abs
    errors of Y and of the gradient."""
    import torch

    from cugraph_tpu_torch.kernels import spmm

    csr, n = g.csr, g.num_vertices
    pair = spmm.get_structure_spmm_fn(g)
    rng = np.random.default_rng(seed)
    worst = worst_y = 0.0
    for f in widths:
        x = torch.from_numpy(rng.random((n, f), dtype=np.float32)).to(
            g.device).requires_grad_(True)
        gy = torch.from_numpy((rng.random((n, f)) * 10).astype(
            np.float32)).to(g.device)
        before = spmm.SPMM_LAUNCHES["weighted_vjp"]
        y = pair(x)
        (gx1,) = torch.autograd.grad(y, x, gy)
        (gx2,) = torch.autograd.grad((pair(x) * gy).sum(), x)
        y_ref = spmm.spmm_csr_reference(g.csc.offsets, g.csc.indices,
                                        g.csc.weights, x.detach())
        ref = spmm.spmm_csr_reference(csr.offsets, csr.indices, csr.weights,
                                      gy)
        torch.cuda.synchronize()
        y_err = (y.detach() - y_ref).abs()
        if bool((y_err > RTOL * y_ref.abs()).any()):
            raise AssertionError(f"{name} K4 F={f}: off its plain version "
                                 f"by {float(y_err.max()):.3e}")
        worst_y = max(worst_y, float(y_err.max()) if y_err.numel() else 0.0)
        launched = spmm.SPMM_LAUNCHES["weighted_vjp"] - before
        if launched != (2 if n * f else 0):
            raise AssertionError(f"{name} VJP F={f}: {launched} backward "
                                 "launches for two backward passes")
        if not torch.equal(gx1.view(torch.int32), gx2.view(torch.int32)):
            raise AssertionError(f"{name} VJP F={f}: two launches differ")
        err = (gx1 - ref).abs()
        if gx1.shape != ref.shape or bool((err > RTOL * ref.abs()).any()):
            raise AssertionError(f"{name} VJP F={f}: off K4 over the CSR "
                                 f"by {float(err.max()):.3e} (rtol {RTOL})")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    print(f"kernel check {name:>12s} K4 VJP: n={n} m={g.num_edges} "
          f"F={list(widths)}: A·X (K4 over the CSC) and the gradient of "
          f"<A·X, G> (K4 over the CSR) within rtol {RTOL} of the plain "
          f"versions (max abs err {worst_y:.3e}, {worst:.3e}), two backward "
          "launches bit-identical", flush=True)
    return worst_y, worst


def gnn_inputs(G):
    """X [n, 128] N(0, 1) from GNN_SEED; 40 labels by a fixed linear rule,
    argmax(X·R) for R [128, 40] N(0, 1) from the same seed, which the
    self-weights can learn; a train mask of half the vertices."""
    import torch

    n = G.number_of_vertices()
    rng = np.random.default_rng(GNN_SEED)
    x = rng.standard_normal((n, GNN_IN), dtype=np.float32)
    rule = rng.standard_normal((GNN_IN, GNN_CLASSES), dtype=np.float32)
    labels = np.argmax(x @ rule, axis=1)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n // 2]] = True
    dev = G.device
    return (torch.from_numpy(x).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(mask).to(dev))


def gnn_path(G, x, labels, mask):
    """GraphSAGE(128, 256, 40): SAGE_STEPS Adam steps and one eval forward
    under no_grad; then GCN(128, 256, 40): GCN_STEPS steps; through the
    public entry points, each with the launch counts set to 0 just before
    and read just after.  Returns, per model, its initial weights, losses,
    first-step gradients, launch counts, and the model and step for the
    timing phase."""
    import torch

    from cugraph_tpu_torch.nn import GCN, GraphSAGE, accuracy, make_train_step

    g = G.structure
    runs = {}
    for name, cls, steps in (("graphsage", GraphSAGE, SAGE_STEPS),
                             ("gcn", GCN, GCN_STEPS)):
        model = cls(GNN_IN, GNN_HIDDEN, GNN_CLASSES, device=G.device,
                    generator=torch.Generator().manual_seed(GNN_SEED))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                       lr=GNN_LR))
        _reset_spmm_counts()
        losses, grads = [], None
        for _ in range(steps):
            losses.append(step(g, x, labels, mask))
            if grads is None:
                grads = {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}
        if name == "graphsage":
            with torch.no_grad():
                logits = model(g, x)
        counts = _read_spmm_counts()
        runs[name] = {"init": init, "losses": [float(v) for v in losses],
                      "grads": grads, "counts": counts, "model": model,
                      "step": step}
        print(f"{name} {GNN_IN}-{GNN_HIDDEN}-{GNN_CLASSES}: losses "
              f"{runs[name]['losses']}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    want = {"graphsage": (2 * SAGE_STEPS + 2, SAGE_STEPS),
            "gcn": (2 * GCN_STEPS, 2 * GCN_STEPS)}
    for name, (fwd, bwd) in want.items():
        c = runs[name]["counts"]
        got = (c["spmm_csr_sum_weighted"], c["spmm_csr_sum_weighted_vjp"])
        others = {k: v for k, v in c.items() if v and k not in (
            "spmm_csr_sum_weighted", "spmm_csr_sum_weighted_vjp")}
        if got != (fwd, bwd) or others:
            raise AssertionError(f"{name}: K4 forward/VJP launches {got}, "
                                 f"expected {(fwd, bwd)}; others {others}")
    losses = runs["graphsage"]["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"graphsage losses {losses}: the last is not "
                             "below the first")
    if logits.shape != (G.number_of_vertices(), GNN_CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"eval logits: shape {tuple(logits.shape)}, "
                             "or not finite")
    held_out = float(accuracy(logits, labels, ~mask))
    print(f"graphsage eval forward: logits {tuple(logits.shape)} finite; "
          f"held-out accuracy {held_out:.4f} after {SAGE_STEPS} steps "
          f"(chance {1 / GNN_CLASSES:.3f})", flush=True)
    return runs


def _aggregate_f64(g):
    """Y = A·H in float64 over the CSC's edges, by gathers and
    ``index_add`` in feature chunks; autograd differentiates it (the
    transpose comes from autograd, not from the CSR).  Also returns the
    float64 weighted in-degree."""
    import torch

    from cugraph_tpu_torch.kernels.spmm import _feature_chunks

    rows, cols = g.csc.row_ids(), g.csc.indices.long()
    w = g.csc.weights.double()
    n = g.num_vertices

    def agg(h):
        parts = []
        for f0, f1 in _feature_chunks(h.shape[1], len(cols), 8):
            vals = h[:, f0:f1].index_select(0, cols) * w[:, None]
            parts.append(torch.zeros(n, f1 - f0, dtype=h.dtype,
                                     device=h.device).index_add(0, rows,
                                                                vals))
        return torch.cat(parts, 1)

    deg = torch.zeros(n, dtype=torch.float64, device=g.device).index_add(
        0, rows, w)
    return agg, deg


def _gnn_forward_f64(name, p, x, agg, deg):
    """The same 2-layer GraphSAGE or GCN in float64, written out from the
    papers' formulas over the state_dict's weights."""
    import torch

    h = x
    for i in range(2):
        def w(key):
            return p[f"layers.{i}.{key}"]

        if name == "graphsage":
            nbr = agg(h) / torch.clamp(deg, min=1e-12)[:, None]
            h = h @ w("w_self.weight").T + nbr @ w("w_nbr.weight").T + w("b")
        else:
            inv = torch.rsqrt(deg + 1)[:, None]
            t = (h @ w("w.weight").T) * inv
            h = (agg(t) + t) * inv + w("b")
        if i == 0:
            h = torch.relu(h)
    return h


def check_gnn(G, x, labels, mask, runs):
    """Each model's first loss and parameter gradients against the float64
    model with the same initial weights."""
    import torch
    import torch.nn.functional as F

    agg, deg = _aggregate_f64(G.structure)
    x64 = x.double()
    out = {}
    for name, run in runs.items():
        p = {k: v.double().requires_grad_(True)
             for k, v in run["init"].items()}
        logits = _gnn_forward_f64(name, p, x64, agg, deg)
        loss = F.cross_entropy(logits[mask], labels[mask])
        grads = torch.autograd.grad(loss, list(p.values()))
        loss_err = abs(run["losses"][0] - loss.item()) / abs(loss.item())
        grad_err = {}
        for key, want in zip(p, grads):
            got = run["grads"][key].double()
            grad_err[key] = float(torch.linalg.vector_norm(got - want)
                                  / torch.linalg.vector_norm(want))
        worst = max(grad_err.values())
        if not (loss_err <= GNN_LOSS_RTOL and worst <= GNN_GRAD_RTOL):
            raise AssertionError(
                f"{name} first step against float64: loss relative error "
                f"{loss_err:.3e} (limit {GNN_LOSS_RTOL}), gradients "
                f"{grad_err} (limit {GNN_GRAD_RTOL})")
        print(f"{name} first step against float64: loss {loss.item():.9f}, "
              f"relative error {loss_err:.3e} (<= {GNN_LOSS_RTOL}); "
              f"gradients' relative L2 {grad_err} (<= {GNN_GRAD_RTOL})",
              flush=True)
        out[name] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err}
        del logits, loss, grads, p
    return out


def time_gnn(G, x, labels, mask, runs, card):
    """ms per training step (CUDA events around each step, median of
    GNN_TIMED_STEPS after a warm-up step) and the peak memory of those
    steps, ms per eval forward, and the device time of a step by kernel,
    for each model."""
    import torch

    g = G.structure
    wall = {}
    for name, run in runs.items():
        step, model = run["step"], run["model"]
        step(g, x, labels, mask)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(GNN_TIMED_STEPS)]
        for start, end in events:
            start.record()
            step(g, x, labels, mask)
            end.record()
        torch.cuda.synchronize()
        steps = [s.elapsed_time(e) for s, e in events]
        with torch.no_grad():
            eval_ms = _cuda_ms(lambda: model(g, x), 5)
        wall[name] = float(np.median(steps))
        print(json.dumps({
            "metric": f"{name}_rmat{SCALE}_ef{EDGE_FACTOR}_train_step",
            "ms_per_step": wall[name], "ms_per_step_runs": steps,
            "eval_forward_ms": eval_ms,
            "widths": [GNN_IN, GNN_HIDDEN, GNN_CLASSES],
            "n": g.num_vertices, "m": g.num_edges,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card}), flush=True)
        def steps(k):
            def run():
                for _ in range(k):
                    step(g, x, labels, mask)
            return run

        # per step as (3 steps - 1 step) / 2: a profile window can miss
        # its first kernel, which the difference cancels
        _device_ms_by_name(steps(1))  # warm-up
        (one, win1), (three, win3) = (_device_ms_by_name(steps(1)),
                                      _device_ms_by_name(steps(3)))
        by_name = {k: (three.get(k, 0.0) - one.get(k, 0.0)) / 2
                   for k in set(one) | set(three)}
        busy = sum(by_name.values())
        window = (win3 - win1) / 2
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
        seen = bool(one and three)
        print(json.dumps({
            "profile": f"{name}_rmat{SCALE} training step", "steps": [1, 3],
            "device_ms_per_step": busy if seen else "not measured",
            "device_ms_per_step_by_kernel": top,
            "ms_per_step_profiled": window,
            "ms_per_step_unprofiled": wall[name],
            "device_idle_share": (1 - busy / window) if seen
            else "not measured", "card": card}), flush=True)
    return wall


def time_gnn_spmm(g, card):
    """K4 weighted over the CSC and K4's VJP over the CSR at F = 256, the
    shape of the hidden layer's aggregation and its backward: the kernel,
    its plain version and one torch.sparse CSR product over the same
    CSR."""
    import torch

    from cugraph_tpu_torch.kernels import spmm

    n, rows = g.num_vertices, {}
    y = torch.from_numpy(np.random.default_rng(4).random(
        (n, GNN_HIDDEN), dtype=np.float32)).to(g.device)
    for key, side, adj in (("weighted", "CSC", g.csc),
                           ("weighted_vjp", "CSR", g.csr)):
        args = (adj.offsets, adj.indices, adj.weights, y)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(adj.offsets, adj.indices,
                                        adj.weights, (n, n),
                                        check_invariants=False)
        rows[key] = {
            # over the CSR, the launch that the backward makes
            "ms": _cuda_ms(lambda: spmm.spmm_csr(*args), 10),
            "plain_ms": _cuda_ms(lambda: spmm.spmm_csr_reference(*args), 2),
            "bound_ms": spmm_bound_ms(n, adj.num_edges, GNN_HIDDEN, True),
            "bound_by": "bytes",
            "library_ms": _cuda_ms(lambda: A @ y, 10)}
        print(f"spmm_csr_sum_{key} over the {side} at n={n} "
              f"m={adj.num_edges} F={GNN_HIDDEN}: "
              + json.dumps(rows[key]) + f" [{card}]", flush=True)
    return rows


def time_spmm_classes(g, card):
    """Diagnostic: K4 weighted over the CSC at F = GNN_CLASSES, the shape
    of GCN's second-layer aggregation, beside its bound and one
    torch.sparse CSR product."""
    import torch

    from cugraph_tpu_torch.kernels import spmm

    adj, n = g.csc, g.num_vertices
    x = torch.from_numpy(np.random.default_rng(5).random(
        (n, GNN_CLASSES), dtype=np.float32)).to(g.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(adj.offsets, adj.indices, adj.weights,
                                    (n, n), check_invariants=False)
    print(json.dumps({
        "diagnostic": f"spmm_csr_sum_weighted over the CSC at "
                      f"F={GNN_CLASSES}",
        "ms": _cuda_ms(lambda: spmm.spmm_csr(adj.offsets, adj.indices,
                                             adj.weights, x), 10),
        "bound_ms": spmm_bound_ms(n, adj.num_edges, GNN_CLASSES, True),
        "library_ms": _cuda_ms(lambda: A @ x, 10), "card": card}),
        flush=True)


# the spans timed by sweep_spans: T of K4 and T1 of K1
K4_SPANS = (256, 512, 1024, 2048)
K1_SPANS = (256, 512, 1024, 2048, 4096)


def sweep_spans(g, card):
    """Diagnostic: K4 and K1 at every span on the directed RMAT-20 ``g``,
    from which SPMM_SPAN and SPMV_SPAN were chosen: K4 unit at F = 128 and
    K4 weighted at F = 256 over the CSC (the shapes of the Brandes panel
    and the GNN's hidden layer), K1 mul over the CSC."""
    import torch

    from cugraph_tpu_torch.kernels import spmm, spmv

    rng = np.random.default_rng(6)
    n = g.num_vertices
    for label, w, f in (("unit", None, PANEL),
                        ("weighted", g.csc.weights, GNN_HIDDEN)):
        x = torch.from_numpy(rng.random((n, f), dtype=np.float32)).to(
            g.device)
        ms = {f"T={span}": _cuda_ms(
            lambda: spmm._spmm_csr(g.csc.offsets, g.csc.indices, w, x, label,
                                   span=span), 10)
            for span in K4_SPANS}
        print(json.dumps({"diagnostic": f"spmm_csr_sum_{label} csc F={f} "
                          "by span", "ms": ms,
                          "chosen": f"T={spmm.SPMM_SPAN}", "card": card}),
              flush=True)
        del x
    x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(g.device)
    ms = {f"T1={span}": _cuda_ms(
        lambda: spmv._launch(g.csc.offsets, g.csc.indices, g.csc.weights, x,
                             "mul", span=span), KERNEL_TIMED_LAUNCHES)
        for span in K1_SPANS}
    print(json.dumps({"diagnostic": "spmv_csr_sum_mul csc by span", "ms": ms,
                      "chosen": f"T1={spmv.SPMV_SPAN}", "card": card}),
          flush=True)


# the spans timed by sweep_min_max_spans: T of K5 and of K2
K5_SPANS = (256, 512, 1024, 2048)
K2_SPANS = (256, 512, 1024, 2048)


def sweep_min_max_spans(gu, card):
    """Diagnostic: K5 (min, add) at F = 128 and K2 (min, add) and (max,
    left) int32 at every span over the undirected RMAT-20 CSC ``gu.csc``,
    which carries the weighted OD, BFS and SSSP launches;
    SPMM_SEMIRING_SPAN and SPMV_SEMIRING_SPAN were chosen from it."""
    import torch

    from cugraph_tpu_torch.kernels import semiring, spmm

    adj = gu.csc
    n = adj.num_vertices
    x = torch.from_numpy((np.random.default_rng(8).random((n, PANEL))
                          * 10).astype(np.float32)).to(adj.device)
    ms = {f"T={span}": _cuda_ms(lambda: spmm._launch_semiring(
        adj.offsets, adj.indices, adj.weights, x, "min", "add", span=span),
        10) for span in K5_SPANS}
    print(json.dumps({"diagnostic": f"spmm_semiring_min_add csc F={PANEL} "
                      "by span", "ms": ms,
                      "chosen": f"T={spmm.SPMM_SEMIRING_SPAN}",
                      "card": card}), flush=True)
    del x
    for reduce, combine, is_int in (("min", "add", False),
                                    ("max", "left", True)):
        x, w = _semiring_inputs(adj, combine, is_int, 9)
        if w is not None:
            w = adj.weights
        ms = {f"T={span}": _cuda_ms(
            lambda: semiring._launch_semiring(
                adj.offsets, adj.indices, w, x, reduce, combine, span=span),
            KERNEL_TIMED_LAUNCHES) for span in K2_SPANS}
        print(json.dumps({
            "diagnostic": "spmv_semiring_"
                          f"{_semiring_key(reduce, combine, is_int)} csc by "
                          "span", "ms": ms,
            "chosen": f"T={semiring.SPMV_SEMIRING_SPAN}", "card": card}),
            flush=True)


# the spans timed by sweep_select_spans, T of K3
K3_SPANS = (256, 512, 1024, 2048)


def sweep_select_spans(gu, card):
    """Diagnostic: every K3 mode at every span over the undirected RMAT-20
    CSC ``gu.csc``, which carries all of K3's launches on the paths (BFS
    and SSSP predecessors); SPMV_SELECT_SPAN was chosen from it, weighted
    by those launches (eqsel has none)."""
    from cugraph_tpu_torch.kernels import semiring

    adj = gu.csc
    for i, mode in enumerate(SELECT_MODES):
        x, w, atol, rtol = _select_inputs(adj, mode, 100 + i)
        kind = "eqsel" if mode == "eqsel" else "eqsel_rel"
        ms = {f"T={span}": _cuda_ms(
            lambda: semiring._launch_select(adj.offsets, adj.indices, w, x,
                                            kind, atol, rtol, span=span),
            KERNEL_TIMED_LAUNCHES) for span in K3_SPANS}
        print(json.dumps({"diagnostic": f"spmv_select_{mode} csc by span",
                          "ms": ms,
                          "chosen": f"T={semiring.SPMV_SELECT_SPAN}",
                          "card": card}), flush=True)


# -- the host engines; components, cores and the K1 power methods ------------

PATH_SEED = 0  # MIS and coloring priorities
MSBFS_NUMPY_SOURCES = 4  # sources held against the NumPy predecessor pass


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


HOST_SETUP_CHECK_SCALE = 18  # the NumPy plain versions, cut from RMAT-20


def time_host_setup(G):
    """The directed graph's host set-up on the native engines (R-MAT
    generation, renumbering and de-duplication), held equal bit for bit to
    the graph's own edge list and vertex map; and the same set-up at
    RMAT-HOST_SETUP_CHECK_SCALE on the native engines and on their NumPy
    plain versions (the set-up before the native engines), held equal bit
    for bit, both timed (cut from RMAT-20 for the time limit)."""
    from cugraph_tpu_torch.core import preprocess, renumber
    from cugraph_tpu_torch.generators import rmat as rmat_module

    a, b, c = RMAT_ABC
    routes = {
        "native": (rmat_module._rmat_host, renumber._dense_ids,
                   preprocess.remove_multi_edges),
        "numpy": (rmat_module._rmat_numpy, renumber._dense_ids_numpy,
                  preprocess._remove_multi_edges_numpy)}

    def run(route, scale):
        gen, ids, dedupe = routes[route]
        t0 = time.perf_counter()
        src, dst = gen(scale, EDGE_FACTOR << scale, a, b, c, SEED, False)
        t1 = time.perf_counter()
        with _patched(renumber, "_dense_ids", ids):
            s_i, d_i, nmap = renumber.renumber_edgelist(src, dst)
        t2 = time.perf_counter()
        s_i, d_i, _ = dedupe(s_i, d_i, None)
        t3 = time.perf_counter()
        return ({"rmat_s": t1 - t0, "renumber_s": t2 - t1,
                 "dedupe_s": t3 - t2, "total_s": t3 - t0},
                (src, dst, s_i, d_i,
                 nmap.to_external(np.arange(nmap.num_vertices))))

    def hold(got, want, label):
        for x, y in zip(got, want):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"the native host set-up differs from "
                                     f"{label}")

    secs = {}
    secs["native"], out = run("native", SCALE)
    gs, gd, _ = G.edgelist_arrays()
    hold(out[2:], (gs, gd, G.number_map.to_external(
        np.arange(G.number_of_vertices()))), "the graph's own edge list")
    secs[f"native_rmat{HOST_SETUP_CHECK_SCALE}"], got = run(
        "native", HOST_SETUP_CHECK_SCALE)
    secs[f"numpy_rmat{HOST_SETUP_CHECK_SCALE}"], want = run(
        "numpy", HOST_SETUP_CHECK_SCALE)
    hold(got, want, "its NumPy plain version")
    print(json.dumps({"metric": f"host_setup_rmat{SCALE}_ef{EDGE_FACTOR}",
                      **secs, "equal_bit_for_bit": True}), flush=True)
    return secs


def component_paths(G, Gu):
    """SCC, katz (default alpha), degree centrality and the hybrid WCC on
    the directed graph; eigenvector, MIS, coloring, core_number and k_core
    (largest k) on the undirected one; each through the public entry
    points with the launch counts set to 0 just before and read just
    after.  Returns the outputs, the counts, the runs and the seconds."""
    from cugraph_tpu_torch import (core_number, degree_centrality,
                                   eigenvector_centrality, k_core,
                                   katz_centrality, maximal_independent_set,
                                   strongly_connected_components,
                                   vertex_coloring,
                                   weakly_connected_components)
    from cugraph_tpu_torch.algos import centrality, components

    def hybrid_wcc():
        os.environ["CUGRAPH_TPU_WCC_HYBRID"] = "1"
        try:
            return weakly_connected_components(G)
        finally:
            del os.environ["CUGRAPH_TPU_WCC_HYBRID"]

    calls = {
        "scc": (strongly_connected_components, G, components),
        "katz": (katz_centrality, G, centrality),
        "degree_centrality": (degree_centrality, G, None),
        "wcc_hybrid": (lambda _: hybrid_wcc(), G, components),
        "eigenvector": (eigenvector_centrality, Gu, centrality),
        "mis": (lambda g: maximal_independent_set(g, seed=PATH_SEED), Gu,
                components),
        "coloring": (lambda g: vertex_coloring(g, seed=PATH_SEED), Gu,
                     components),
        "core_number": (core_number, Gu, None),
        "k_core": (k_core, Gu, None),
    }
    out, counts, runs, secs = {}, {}, {}, {}
    for name, (call, graph, module) in calls.items():
        _reset_counts()
        torch_sync()
        t0 = time.perf_counter()
        out[name] = call(graph)
        torch_sync()
        secs[name] = time.perf_counter() - t0
        counts[name] = _read_counts()
        runs[name] = dict(module.LAST_RUN) if module is not None else {}

    def need(name, key, exact):
        got = counts[name][key]
        if got == 0 or got != exact:
            raise AssertionError(f"{name} launched {key} {got} times, "
                                 f"expected {exact}")

    need("scc", "spmv_semiring_max_left_i32", runs["scc"]["forward_sweeps"])
    need("scc", "spmv_semiring_min_left_i32",
         runs["scc"]["backward_sweeps"])
    need("katz", "spmv_csr_sum_mul", runs["katz"]["iterations"])
    need("wcc_hybrid", "spmv_semiring_max_left",
         2 * runs["wcc_hybrid"]["mask_sweeps"])
    need("eigenvector", "spmv_csr_sum_mul",
         runs["eigenvector"]["iterations"])
    for name in ("mis", "coloring"):
        need(name, "spmv_semiring_max_left_i32",
             2 * runs[name]["luby_rounds"])
    for name in ("degree_centrality", "core_number", "k_core"):
        if any(counts[name].values()):
            raise AssertionError(f"{name} launched a kernel: host code")
    for name in calls:
        print(f"{name}: {secs[name]:.3f} s, {runs[name]}; launches "
              f"{ {k: v for k, v in counts[name].items() if v} }",
              flush=True)
    return out, counts, runs, secs


def torch_sync():
    import torch

    torch.cuda.synchronize()


def _power_reference(step, x, tol, max_iter):
    """float64 power iteration with the port's loop and stopping rule (L1
    change below tol); returns (x, iterations)."""
    err, it = np.inf, 0
    while err >= tol and it < max_iter:
        x_new = step(x)
        err = np.abs(x_new - x).sum()
        x, it = x_new, it + 1
    return x, it


def _h_index_cores(g):
    """Core numbers of an undirected structure as the h-index fixpoint of
    cugraph_tpu/algos/cores.py:27-76 in plain torch on the card: from c =
    degree, c[v] <- the largest h <= c[v] with at least h neighbours u of
    c[u] >= h, by binary search, until nothing changes.  An independent
    computation of what the native peel gives."""
    import torch

    rows = g.csr.row_ids()
    cols = g.csr.indices.to(torch.int64)
    c = g.csr.degrees().to(torch.int32)
    steps = int(c.max()).bit_length() + 1 if c.numel() else 0
    rounds = 0
    while True:
        lo, hi = torch.zeros_like(c), c.clone()
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            cnt = torch.zeros_like(c).index_add_(
                0, rows, (c[cols] >= mid[rows]).to(torch.int32))
            ok, act = cnt >= mid, lo < hi
            lo = torch.where(act & ok, mid, lo)
            hi = torch.where(act & ~ok, mid - 1, hi)
        rounds += 1
        if torch.equal(lo, c):
            return c, rounds
        c = lo


def check_component_paths(G, Gu, out, runs, wcc_labels):
    """The component, core and power-method results against independent
    references: scipy's strong components (the partition and the largest
    internal id of each), float64 scipy iterations of Katz and eigenvector
    with the same stopping rule, the host degrees, the structure of the
    MIS and the coloring, the h-index fixpoint on the card, the k-core's
    definition, and the default WCC's labels.  Returns the Katz and
    eigenvector references, which the multi-device phase reuses."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    n = G.number_of_vertices()
    s, d, _ = G.edgelist_arrays()
    A = sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    t0 = time.perf_counter()
    n_comp, comp = csgraph.connected_components(A, directed=True,
                                                connection="strong")
    t_scipy = time.perf_counter() - t0
    top = np.full(n_comp, -1, np.int64)
    np.maximum.at(top, comp, np.arange(n))
    got = np.empty(n, np.int64)
    got[_internal(G, out["scc"]["vertex"].to_numpy())] = _internal(
        G, out["scc"]["labels"].to_numpy())
    if not np.array_equal(got, top[comp]):
        raise AssertionError("scc: the partition or its labels differ from "
                             "scipy's strong components")
    print(f"scc: {n_comp} SCCs equal scipy's (strong, {t_scipy:.1f} s), "
          "each labelled with its largest internal id", flush=True)

    At = A.T.tocsr()
    alpha = 1.0 / (int(np.bincount(d, minlength=n).max()) + 1)
    x, it = _power_reference(lambda x: alpha * (At @ x) + 1.0,
                             np.zeros(n), n * 1e-6, 100)
    refs = {"katz": (alpha, x, it)}
    _hold_power("katz", G, out["katz"], "katz_centrality",
                               x / np.linalg.norm(x), it,
                               runs["katz"]["iterations"])
    deg = (np.bincount(s, minlength=n) + np.bincount(d, minlength=n)) \
        / (n - 1)
    got = np.zeros(n)
    got[_internal(G, out["degree_centrality"]["vertex"].to_numpy())] = \
        out["degree_centrality"]["degree_centrality"].to_numpy()
    if not np.array_equal(got, deg):
        raise AssertionError("degree_centrality differs from the host "
                             "degrees over n - 1")
    print("degree_centrality: equal to the host in + out degrees over n - 1")
    if not np.array_equal(out["wcc_hybrid"]["labels"].to_numpy(),
                          wcc_labels):
        raise AssertionError("the hybrid WCC's labels differ from "
                             "weakly_connected_components'")
    print(f"wcc hybrid: labels equal the default WCC's bit for bit "
          f"({runs['wcc_hybrid']})")

    nu = Gu.number_of_vertices()
    su, du, wu = Gu.edgelist_arrays()
    Au = sp.csr_matrix((wu.astype(np.float64), (su, du)), shape=(nu, nu))
    AuT = Au.T.tocsr()

    def shifted(x):
        y = AuT @ x + x
        return y / max(np.linalg.norm(y), 1e-30)

    x, it = _power_reference(shifted, np.full(nu, 1 / np.sqrt(nu)),
                             nu * 1e-6, 100)
    _hold_power(
        "eigenvector", Gu, out["eigenvector"], "eigenvector_centrality", x,
        it, runs["eigenvector"]["iterations"])
    refs["eigenvector"] = (x, it)

    loop = su == du
    a, b = su[~loop], du[~loop]
    in_set = np.zeros(nu, bool)
    in_set[_internal(Gu, out["mis"]["vertex"].to_numpy())] = True
    dominated = in_set.copy()
    dominated[b[in_set[a]]] = True
    if (in_set[a] & in_set[b]).any() or not dominated.all():
        raise AssertionError("mis: not independent or not maximal")
    color = np.empty(nu, np.int64)
    color[_internal(Gu, out["coloring"]["vertex"].to_numpy())] = \
        out["coloring"]["color"].to_numpy()
    if (color < 0).any() or (color[a] == color[b]).any():
        raise AssertionError("coloring: a vertex uncoloured or an edge "
                             "with one colour at both ends")
    print(f"mis: {int(in_set.sum())} vertices, independent and maximal; "
          f"coloring: {int(color.max()) + 1} colours, proper, every vertex "
          "coloured", flush=True)

    core = np.empty(nu, np.int64)
    core[_internal(Gu, out["core_number"]["vertex"].to_numpy())] = \
        out["core_number"]["core_number"].to_numpy()
    t0 = time.perf_counter()
    want, rounds = _h_index_cores(Gu.structure)
    t_h = time.perf_counter() - t0
    if not np.array_equal(core, want.cpu().numpy()):
        raise AssertionError("core_number differs from the h-index "
                             "fixpoint")
    print(f"core_number: equal to the h-index fixpoint on the card "
          f"({rounds} rounds, {t_h:.1f} s), largest core {core.max()}")
    K = int(core.max())
    H = out["k_core"]
    members = core >= K
    ext = Gu.number_map.to_external
    got_v = np.sort(H.number_map.to_external(
        np.arange(H.number_of_vertices())))
    if not np.array_equal(got_v, np.sort(ext(np.flatnonzero(members)))):
        raise AssertionError("k_core: the vertex set is not {core >= k}")
    hs, hd, _ = H.edgelist_arrays()
    keep = members[su] & members[du]

    def pairs(x, y):
        return np.sort(x.astype(np.int64) * (1 << 32) + y)

    if not np.array_equal(pairs(H.number_map.to_external(hs),
                                H.number_map.to_external(hd)),
                          pairs(ext(su[keep]), ext(du[keep]))):
        raise AssertionError("k_core: the edges are not those with both "
                             "ends in the core")
    print(f"k_core(k={K}): {H.number_of_vertices()} vertices = {{core >= "
          f"k}}, {len(hs)} stored edges = those with both ends in it",
          flush=True)
    return refs


def _hold_power(label, G, df, col, want, it_ref, it):
    """The port's power method against the float64 reference: the same
    number of iterations under the same stopping rule, and L1 <= L1_TOL
    between the two vectors each scaled to unit L1 norm, as PageRank's
    are.  The L2-normalised vectors' own L1 distance is printed: their L1
    norm grows as sqrt(n) (hundreds at RMAT-20), so float32's rounding of
    the values alone puts it above L1_TOL."""
    got = _by_internal_id(G, df, col)
    if it != it_ref:
        raise AssertionError(f"{label}: {it} iterations, the float64 "
                             f"reference stopped after {it_ref}")
    raw = float(np.abs(got - want).sum())
    norm = float(np.abs(got).sum())
    l1 = float(np.abs(got / norm - want / np.abs(want).sum()).sum())
    if not (np.isfinite(got).all() and l1 <= L1_TOL):
        raise AssertionError(f"{label}: L1 {l1:.3e} > {L1_TOL} at unit L1 "
                             "norm")
    print(f"{label}: {it} iterations as the float64 reference; at unit L1 "
          f"norm, L1 vs float64 {l1:.3e} (<= {L1_TOL}); L2-normalised as "
          f"returned, L1 {raw:.3e} at L1 norm {norm:.4f}")
    return l1


def time_component_paths(G, Gu, secs, runs, card):
    """Wall time per call of the new paths (the path runs were the
    warm-up; the frame on the host included), with their rounds, sweeps
    or iterations."""
    from cugraph_tpu_torch import (core_number, degree_centrality,
                                   eigenvector_centrality, k_core,
                                   katz_centrality, maximal_independent_set,
                                   strongly_connected_components,
                                   vertex_coloring)

    calls = {
        "scc": (lambda: strongly_connected_components(G), 3),
        "katz": (lambda: katz_centrality(G), 3),
        "degree_centrality": (lambda: degree_centrality(G), 3),
        "eigenvector": (lambda: eigenvector_centrality(Gu), 3),
        "mis": (lambda: maximal_independent_set(Gu, seed=PATH_SEED), 3),
        "coloring": (lambda: vertex_coloring(Gu, seed=PATH_SEED), 1),
        "core_number": (lambda: core_number(Gu), 3),
        "k_core": (lambda: k_core(Gu), 1),
    }
    for name, (call, repeats) in calls.items():
        out = []
        for _ in range(repeats):
            torch_sync()
            t0 = time.perf_counter()
            call()
            out.append(time.perf_counter() - t0)
        print(json.dumps({"metric": f"{name}_rmat{SCALE}_ef{EDGE_FACTOR}",
                          "ms_per_call": float(np.median(out)) * 1e3,
                          "ms_per_call_runs": [t * 1e3 for t in out],
                          "path_run_ms": secs[name] * 1e3,
                          "run": runs[name], "card": card}), flush=True)
    print(json.dumps({"metric": f"wcc_hybrid_rmat{SCALE}_ef{EDGE_FACTOR}"
                      "_directed", "path_run_ms": secs["wcc_hybrid"] * 1e3,
                      "run": runs["wcc_hybrid"], "card": card}), flush=True)


def _without_heaviest(adj, k):
    """(offsets, indices, weights) of ``adj`` with its k heaviest rows,
    found by degree, emptied."""
    import torch

    deg = adj.offsets[1:] - adj.offsets[:-1]
    top = torch.topk(deg, k).indices
    keep = torch.ones(adj.num_vertices, dtype=torch.bool, device=adj.device)
    keep[top] = False
    deg = torch.where(keep, deg, 0)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=adj.device),
                         torch.cumsum(deg, 0, dtype=torch.int32)])
    edges = keep[adj.row_ids()]
    return offsets, adj.indices[edges], adj.weights[edges]


def time_without_heaviest(name, adj, run, bound, repeats, card):
    """Diagnostic for the tail: ``run(offsets, indices, weights)``, one
    kernel call, on ``adj`` in full and with its k heaviest rows emptied;
    with the span pass the heaviest row should no longer set the time.
    ``bound(m)`` is the call's bound at m edges."""
    full = _cuda_ms(lambda: run(adj.offsets, adj.indices, adj.weights),
                    repeats)
    for k in (1, 32, 1024):
        offsets, indices, weights = _without_heaviest(adj, k)
        left = int(indices.shape[0])
        ms = _cuda_ms(lambda: run(offsets, indices, weights), repeats)
        print(json.dumps({"diagnostic": f"{name} without the {k} heaviest "
                          "rows", "ms": ms, "full_ms": full,
                          "ratio_to_full": ms / full, "edges_left": left,
                          "edges": adj.num_edges, "bound_ms": bound(left),
                          "card": card}), flush=True)


# -- the sampling paths: samplers, walks, negatives, sampled GNN --------------

DISPATCH_SOURCE = "cugraph_tpu_torch/kernels/dispatch.py"
# benchmarks/bench_sampling_rmat20.py:38-39's shape: seeds among the
# vertices with out-edges (NumPy seed 0), fanout [10, 10]
SAMPLE_SEEDS, SAMPLE_SEED, SAMPLE_FANOUT = 4096, 0, [10, 10]
SELECT_CALLS, SELECT_CHI2_CALLS = 10, 200
SELECT_ROWS, SELECT_ROWS_DEGREE = 8192, (5, 40)
BULK_FRONTIER, BULK_K = 65536, 10
WALKERS, WALK_DEPTH = 4096, 16
# node2vec's step builds a [W, max_deg] tile (64,633 on the undirected
# graph) and searches prev's row for each entry in 32 steps: W and the
# depth are cut to the time budget (PERF.md §4)
N2V_WALKERS, N2V_DEPTH, N2V_P, N2V_Q = 512, 8, 0.5, 2.0
NEG_SAMPLES = 100_000
NEG_LOG2_DEGREE_TOL = 1.0
MB_BATCH, MB_BATCHES, MB_FANOUT = 1024, 5, [10, 10]
# the dot decoder scores unnormalised 40-wide embeddings: at the GNN
# phase's rate (1e-2) the loss jumps on the second step at RMAT-14 on the
# CPU, so the link-prediction steps take 1e-3
LP_POSITIVES, LP_STEPS, LP_LR = 100_000, 3, 1e-3
# the card against the CPU plain path, the same draws, at this scale
SAMPLING_CHECK_SCALE = 12
SAMPLING_TIMED_CALLS = 3
# node2vec on the card sums float32 scores in another order than on the
# CPU: a pick may differ only where the draw lies this close (relative) to
# a CDF step
N2V_EXCLUDE_RTOL = 1e-5


def _seeds_with_out_edges(G, size, seed, replace=False):
    """External ids of ``size`` vertices with out-edges, distinct unless
    ``replace``."""
    deg = G.structure.out_degrees().cpu().numpy()
    return np.random.default_rng(seed).choice(G.nodes()[deg > 0], size=size,
                                              replace=replace)


def _internal_tensor(G, ext_ids):
    import torch

    return torch.as_tensor(_internal(G, ext_ids), device=G.device)


def _edges_found(g, src, dst):
    """bool tensor: (src[i], dst[i]) is an edge, by the CSR's binary
    search on the card, and each edge's position."""
    from cugraph_tpu_torch.prims.intersection import lower_bound_rows

    return lower_bound_rows(g.csr, src, dst)


class _HostDraws:
    """The samplers' draws made by a CPU generator and moved to
    ``device``: the card and the CPU plain path then see the same
    numbers (the CUDA generator draws another stream)."""

    def __init__(self, seed, device):
        from cugraph_tpu_torch.algos.sampling import Draws

        self.draws = Draws(seed, "cpu")
        self.device = device

    def split(self):
        return self

    def uniform(self, shape, low=0.0, high=1.0):
        return self.draws.uniform(shape, low, high).to(self.device)

    def gumbel(self, shape):
        return self.draws.gumbel(shape).to(self.device)

    def edge_gumbel(self, n):
        return self.draws.edge_gumbel(n).to(self.device)

    def seed(self):
        return self.draws.seed()


def sampling_paths(G, Gu):
    """Through the public entry points, each with the launch counts set
    to 0 just before and read just after: ``uniform_neighbor_sample`` on
    the directed graph and ``homogeneous_biased_neighbor_sample`` on the
    weighted undirected one, with and without replacement, from
    SAMPLE_SEEDS seeds, fanout [10, 10]; SELECT_CALLS calls of
    ``per_v_random_select`` on the directed graph, then the bulk route
    ``_bulk_sample_with_replacement`` over BULK_FRONTIER distinct vertices
    with k = BULK_K; the walks; ``negative_sampling`` uniform and
    ``sample_negatives(degree_biased=True)``.  Returns the results, the
    counts and the wall seconds by path."""
    import torch

    from cugraph_tpu_torch import (biased_random_walks,
                                   homogeneous_biased_neighbor_sample,
                                   negative_sampling, node2vec_random_walks,
                                   per_v_random_select,
                                   uniform_neighbor_sample,
                                   uniform_random_walks)
    from cugraph_tpu_torch.algos import sampling
    from cugraph_tpu_torch.nn import sample_negatives

    seeds = _seeds_with_out_edges(G, SAMPLE_SEEDS, SAMPLE_SEED)
    seeds_u = _seeds_with_out_edges(Gu, SAMPLE_SEEDS, SAMPLE_SEED)
    g = G.structure
    gen = torch.Generator(device=G.device)
    gen.manual_seed(0)
    frontier = np.sort(np.random.default_rng(1).choice(
        g.num_vertices, BULK_FRONTIER, replace=False)).astype(np.int32)
    n2v_starts = seeds_u[:N2V_WALKERS]
    paths = {
        "uniform_wr": lambda: uniform_neighbor_sample(
            G, seeds, SAMPLE_FANOUT, with_replacement=True, random_state=0),
        "uniform_wor": lambda: uniform_neighbor_sample(
            G, seeds, SAMPLE_FANOUT, with_replacement=False, random_state=0),
        "biased_wr": lambda: homogeneous_biased_neighbor_sample(
            Gu, seeds_u, SAMPLE_FANOUT, with_replacement=True,
            random_state=0),
        "biased_wor": lambda: homogeneous_biased_neighbor_sample(
            Gu, seeds_u, SAMPLE_FANOUT, with_replacement=False,
            random_state=0),
        "per_v_random_select": lambda: [per_v_random_select(G, gen)
                                        for _ in range(SELECT_CALLS)],
        "bulk": lambda: sampling._bulk_sample_with_replacement(
            G, g, frontier, sampling.Draws(0, G.device), BULK_K),
        "uniform_walks": lambda: uniform_random_walks(
            G, seeds[:WALKERS], WALK_DEPTH, random_state=0),
        "biased_walks": lambda: biased_random_walks(
            Gu, seeds_u[:WALKERS], WALK_DEPTH, random_state=0),
        "node2vec_walks": lambda: node2vec_random_walks(
            Gu, n2v_starts, N2V_DEPTH, p=N2V_P, q=N2V_Q, random_state=0),
        "negative_uniform": lambda: negative_sampling(
            G, NEG_SAMPLES, random_state=0),
        "negative_degree_biased": lambda: sample_negatives(
            G, NEG_SAMPLES, random_state=0, degree_biased=True),
    }
    out, counts, secs = {}, {}, {}
    for name, fn in paths.items():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = _read_counts()
        launched = {k: v for k, v in counts[name].items() if v}
        size = (len(out[name]) if hasattr(out[name], "__len__") else "")
        print(f"sampling path {name}: {secs[name]:.3f} s, "
              f"{size} results, launches {launched}", flush=True)
    for name, calls in (("per_v_random_select", SELECT_CALLS),
                        ("bulk", BULK_K)):
        got = (counts[name]["spmv_semiring_max_right"],
               counts[name]["spmv_select_eqsel"])
        if got != (calls, calls):
            raise AssertionError(f"{name} launched K2 (max, right) / K3 "
                                 f"eqsel {got} times, expected {calls} each")
    out["frontier"], out["seeds"], out["seeds_u"] = frontier, seeds, seeds_u
    out["n2v_starts"] = n2v_starts
    return out, counts, secs


def _check_frame(label, G, df, seeds, k, with_replacement):
    """Every (src, dst) an edge of G with its weight; hop 0 gives each
    seed (one per batch) k rows with replacement, min(k, deg) distinct
    ones without; hop 1 gives a (source, batch) that many rows times the
    number of times hop 0 of the batch sampled it, distinct picks where
    once."""
    import pandas as pd
    import torch

    g = G.structure
    s = _internal_tensor(G, df["sources"].to_numpy())
    d = _internal_tensor(G, df["destinations"].to_numpy())
    found, pos = _edges_found(g, s, d)
    if not bool(found.all()):
        raise AssertionError(f"{label}: {int((~found).sum())} sampled pairs "
                             "are not edges")
    w = torch.as_tensor(df["weight"].to_numpy().copy(), device=G.device)
    if not torch.equal(g.csr.weights[pos], w):
        raise AssertionError(f"{label}: a weight is not its edge's")
    deg = g.out_degrees().cpu().numpy()
    frame = df.assign(src_i=s.cpu().numpy(), dst_i=d.cpu().numpy())
    h0 = frame[frame["hop_id"] == 0]
    h1 = frame[frame["hop_id"] == 1]
    key = ["src_i", "batch_id"]
    mult = {0: pd.Series(1, index=pd.MultiIndex.from_arrays(
                [_internal(G, seeds), np.arange(len(seeds), dtype=np.int32)],
                names=key)),
            1: h0.groupby(["dst_i", "batch_id"]).size().rename_axis(key)}
    for hop, rows in ((0, h0), (1, h1)):
        m = mult[hop]
        deg_m = deg[m.index.get_level_values(0)]
        per = (np.where(deg_m > 0, k, 0) if with_replacement else
               np.minimum(k, deg_m))
        want = (m * per)[m * per > 0].sort_index()
        got = rows.groupby(key).size().sort_index()
        if not (got.index.equals(want.index)
                and np.array_equal(got.to_numpy(), want.to_numpy())):
            law = "k" if with_replacement else "min(k, deg)"
            raise AssertionError(f"{label}: hop {hop} rows per (source, "
                                 f"batch) differ from multiplicity x {law}")
        if not with_replacement:
            once = rows.join(m.rename("mult"), on=key)
            once = once[once["mult"] == 1]
            if once.duplicated(key + ["dst_i"]).any():
                raise AssertionError(f"{label}: hop {hop} repeats a pick")
    print(f"{label}: {len(df)} rows, every pair an edge with its weight, "
          "rows per (source, batch, hop) as the fanout and multiplicity "
          "give", flush=True)


def _check_walks(label, G, vp, walkers, depth):
    """Every step an edge, -1 after a sink and ever after."""
    import torch

    g = G.structure
    p = _internal_tensor(G, vp.to_numpy()).reshape(walkers, depth + 1)
    a, b = p[:, :-1], p[:, 1:]
    both = (a >= 0) & (b >= 0)
    found, _ = _edges_found(g, a[both], b[both])
    deg = g.out_degrees().to(torch.int64)
    ends = (a >= 0) & (b < 0)
    ok = (bool(found.all()) and bool(((a < 0) <= (b < 0)).all())
          and bool((deg[a[ends]] == 0).all()))
    if not ok:
        raise AssertionError(f"{label}: a step is not an edge, or a walk "
                             "moves after -1 or stops at a vertex with "
                             "out-edges")
    print(f"{label}: {walkers} walks of depth {depth}, {int(both.sum())} "
          f"steps all edges, {int(ends.sum())} ended at sinks", flush=True)


def _numpy_select(csr, pri):
    """float64 NumPy argmax of ``pri`` per CSR row, the largest column id
    among ties, -1 for an empty row."""
    off = csr.offsets.cpu().numpy().astype(np.int64)
    ind = csr.indices.cpu().numpy()
    p = pri.cpu().numpy().astype(np.float64)
    deg = np.diff(off)
    rows = np.flatnonzero(deg > 0)
    top = np.maximum.reduceat(p, off[rows])
    cand = np.where(p == np.repeat(top, deg[rows]), ind, -1)
    out = np.full(len(deg), -1, np.int64)
    out[rows] = np.maximum.reduceat(cand, off[rows])
    return out


def check_select(G):
    """``per_v_random_select`` on the directed graph: with the path's own
    priorities (``dispatch.priorities``) K2 (max, right) and K3 eqsel bit
    for bit against their plain versions and two launches
    bit-identical, and the result equal to a float64 NumPy argmax per row;
    with its own draws every pick an out-neighbour and -1 exactly at
    sinks; on the top hub, SELECT_CHI2_CALLS draws under the χ² bound of
    tests/test_kernels.py:352-365 (< 4·deg) and under the 0.9999 quantile
    over 20 bins of its edges, and from the same calls a χ² summed over
    SELECT_ROWS rows of out-degree 5-40 within 6 standard deviations of
    its degrees of freedom."""
    import torch

    from cugraph_tpu_torch import per_v_random_select
    from cugraph_tpu_torch.kernels import dispatch
    from cugraph_tpu_torch.kernels.semiring import (spmv_select,
                                                    spmv_select_reference,
                                                    spmv_semiring,
                                                    spmv_semiring_reference)
    from cugraph_tpu_torch.testing import picks as picks_chi2

    g = G.structure
    csr = g.csr
    gen = torch.Generator(device=G.device)
    gen.manual_seed(7)
    pri = dispatch.priorities(csr.num_edges, gen, G.device)
    x0 = torch.zeros(csr.num_vertices, device=G.device)
    args = (csr.offsets, csr.indices, pri, x0, "max", "right")
    y1 = spmv_semiring(*args)
    _hold_exact("rmat csr (path priorities)/spmv_semiring_max_right", y1,
                spmv_semiring(*args), spmv_semiring_reference(*args))
    sargs = (csr.offsets, csr.indices, pri, y1, "eqsel")
    y2 = spmv_select(*sargs)
    _hold_exact("rmat csr (path priorities)/spmv_select_eqsel", y2,
                spmv_select(*sargs), spmv_select_reference(*sargs))
    want = _numpy_select(csr, pri)
    got = dispatch._select_by_priority(csr, pri)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("per_v_random_select with fed priorities "
                             "differs from the float64 NumPy argmax")
    deg = g.out_degrees()
    sel = per_v_random_select(G, gen)
    has = deg > 0
    ids = torch.arange(g.num_vertices, device=G.device)
    found, _ = _edges_found(g, ids[has], sel[has])
    if not (bool(found.all()) and bool((sel[~has] == -1).all())):
        raise AssertionError("per_v_random_select: a pick is not an "
                             "out-neighbour, or a sink did not get -1")
    hub = int(torch.argmax(deg))
    d0 = int(deg[hub])
    deg_h = deg.cpu().numpy()
    rows = np.flatnonzero((deg_h >= SELECT_ROWS_DEGREE[0])
                          & (deg_h <= SELECT_ROWS_DEGREE[1]))
    rows = np.sort(np.random.default_rng(0).choice(
        rows, min(SELECT_ROWS, len(rows)), replace=False))
    cols = torch.as_tensor(np.concatenate([[hub], rows]), device=G.device)
    sel = torch.stack([per_v_random_select(G, gen)[cols]
                       for _ in range(SELECT_CHI2_CALLS)]).cpu().numpy()
    picks = sel[:, 0]
    _, counts = np.unique(picks, return_counts=True)
    exp = SELECT_CHI2_CALLS / d0
    chi2 = float(((counts - exp) ** 2 / exp).sum() + (d0 - len(counts)) * exp)
    if chi2 >= 4 * d0:
        raise AssertionError(f"per_v_random_select χ² on the hub: {chi2}")
    # the hub's picks over 20 bins of its edge positions (a select kept to
    # one heavy-row piece shows), and one χ² summed over SELECT_ROWS rows
    # of out-degree 5-40 (a select that keeps to part of each light row
    # shows): tests/test_torch_sampling.py's bounds
    bchi2, bdof = picks_chi2.binned_chi2(csr.offsets, csr.indices, hub, picks)
    rchi2, rdof = picks_chi2.rows_chi2(csr.offsets, csr.indices, rows,
                                       sel[:, 1:])
    rbound = 6.0 * np.sqrt(2 * rdof)
    if not (bdof == 19 and bchi2 < 50.8 and abs(rchi2 - rdof) < rbound):
        raise AssertionError(f"per_v_random_select: binned χ² on the hub "
                             f"{bchi2} ({bdof} dof), χ² over {len(rows)} "
                             f"rows {rchi2} ({rdof} dof)")
    print(f"per_v_random_select: K2 (max, right) and K3 eqsel bit for bit on "
          f"the path's priorities (m={csr.num_edges}), equal to the float64 "
          f"NumPy argmax; picks valid, {int((~has).sum())} sinks at -1; hub "
          f"{hub} (out-degree {d0}): χ² {chi2:.1f} over "
          f"{SELECT_CHI2_CALLS} draws (< {4 * d0}), over 20 bins of its "
          f"edges {bchi2:.2f} (< 50.8); χ² over {len(rows)} rows of "
          f"out-degree {SELECT_ROWS_DEGREE[0]}-{SELECT_ROWS_DEGREE[1]} "
          f"{rchi2:.1f} against {rdof} dof (within {rbound:.1f})",
          flush=True)
    return {"max_right": 0.0, "eqsel": 0.0}


def _small_graphs(device):
    """RMAT-SAMPLING_CHECK_SCALE directed, and undirected with uniform
    (0, 1] weights, from the port's generator."""
    from cugraph_tpu_torch import Graph, rmat

    a, b, c = RMAT_ABC
    e = rmat(SAMPLING_CHECK_SCALE, EDGE_FACTOR << SAMPLING_CHECK_SCALE,
             a=a, b=b, c=c, seed=SEED)
    src, dst = e["src"].to_numpy(), e["dst"].to_numpy()
    w = (1.0 - np.random.default_rng(3).random(len(src))).astype(np.float32)
    return (Graph(directed=True, device=device).from_edgelist(src, dst, w),
            Graph(directed=False, device=device).from_edgelist(src, dst, w))


def check_card_against_cpu(device):
    """At RMAT-SAMPLING_CHECK_SCALE, the same draws on the card and on the
    CPU plain path: the four samplers' frames (the tile route and, with
    the tile threshold at 0, the per-edge sorted route) and the uniform
    and biased walks equal; node2vec's paths equal up to the first step
    whose draw lies within N2V_EXCLUDE_RTOL of a CDF step, counted."""
    import torch

    from cugraph_tpu_torch.algos import sampling

    graphs = {dev: _small_graphs(dev) for dev in ("cpu", device)}
    seeds = _seeds_with_out_edges(graphs["cpu"][0], 64, 0)
    compared = 0
    for biased in (False, True):
        for wr in (True, False):
            for threshold in ((None,) if wr else (None, 0)):
                frames = []
                for dev in ("cpu", device):
                    G = graphs[dev][1 if biased else 0]
                    ctx = (_patched(sampling, "_TILE_FALLBACK_ENTRIES",
                                    threshold) if threshold is not None
                           else contextlib.nullcontext())
                    with ctx:
                        frames.append(sampling._neighbor_sample(
                            G, seeds, SAMPLE_FANOUT, wr, biased, 0,
                            draws=_HostDraws(0, G.device)))
                if not frames[0].equals(frames[1]) or len(frames[0]) == 0:
                    raise AssertionError(
                        f"frames differ on the card (biased={biased}, "
                        f"with_replacement={wr}, tile threshold "
                        f"{threshold})")
                compared += 1
    u = torch.rand((WALK_DEPTH, 256), generator=torch.Generator()
                   .manual_seed(1))
    walks = {}
    for dev in ("cpu", device):
        Gu = graphs[dev][1]
        g = Gu.structure
        starts = torch.as_tensor(_internal(Gu, np.resize(seeds, 256)),
                                 device=g.device)
        walks[dev] = (
            sampling._walk_kernel(g, starts, u.to(g.device), WALK_DEPTH,
                                  False, None),
            sampling._walk_kernel(g, starts, u.to(g.device), WALK_DEPTH,
                                  True, sampling._row_cumweights(g)),
            sampling._node2vec_kernel(g, starts, u.to(g.device), WALK_DEPTH,
                                      N2V_P, N2V_Q,
                                      sampling._max_out_degree(g)))
    for i in range(2):
        for a, b in zip(walks["cpu"][i], walks[device][i]):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"{('uniform', 'biased')[i]} walks "
                                     "differ on the card")
    pc, pg = walks["cpu"][2][0], walks[device][2][0].cpu()
    differ = (pc != pg).any(dim=1)
    near = 0
    g = graphs["cpu"][1].structure
    for w in torch.nonzero(differ).flatten().tolist():
        i = int(torch.nonzero(pc[w] != pg[w])[0]) - 1   # the step that split
        prev = pc[w, i - 1:i] if i else torch.tensor([-1])
        _, _, score, cdf = sampling._node2vec_scores(
            g.csr, pc[w, i:i + 1], prev, N2V_P, N2V_Q,
            sampling._max_out_degree(g))
        target = float(u[i, w]) * float(score.sum())
        if not bool((torch.abs(cdf - target)
                     <= N2V_EXCLUDE_RTOL * target).any()):
            raise AssertionError(f"node2vec walk {w} splits at step {i} on "
                                 "the card, away from a CDF step")
        near += 1
    print(f"card against the CPU at RMAT-{SAMPLING_CHECK_SCALE}: {compared} "
          "frames and the uniform and biased walks equal; node2vec: "
          f"{near} of 256 walks split at a step within "
          f"{N2V_EXCLUDE_RTOL} of a CDF step, none elsewhere", flush=True)


def check_sampling_paths(G, Gu, out):
    """The frames, walks and negatives of ``sampling_paths``."""
    import torch

    k = SAMPLE_FANOUT[0]
    for name, Gx, seeds, wr in (
            ("uniform_wr", G, out["seeds"], True),
            ("uniform_wor", G, out["seeds"], False),
            ("biased_wr", Gu, out["seeds_u"], True),
            ("biased_wor", Gu, out["seeds_u"], False)):
        _check_frame(name, Gx, out[name], seeds, k, wr)
    _check_walks("uniform_walks", G, out["uniform_walks"][0], WALKERS,
                 WALK_DEPTH)
    _check_walks("biased_walks", Gu, out["biased_walks"][0], WALKERS,
                 WALK_DEPTH)
    _check_walks("node2vec_walks", Gu, out["node2vec_walks"][0],
                 len(out["n2v_starts"]), N2V_DEPTH)
    g = G.structure
    dst, eidx, valid = out["bulk"]
    fr = out["frontier"]
    ind = g.csr.indices.cpu().numpy()
    off = g.csr.offsets.cpu().numpy()
    deg = np.diff(off)[fr]
    rows = np.repeat(fr[:, None], BULK_K, 1)
    if not (np.array_equal(valid, np.repeat(deg[:, None] > 0, BULK_K, 1))
            and np.array_equal(ind[eidx[valid]], dst[valid])
            and ((eidx[valid] >= off[rows[valid]])
                 & (eidx[valid] < off[rows[valid] + 1])).all()):
        raise AssertionError("the bulk route's picks or edge positions are "
                             "not the frontier's out-edges")
    for name in ("negative_uniform", "negative_degree_biased"):
        res = out[name]
        if isinstance(res, tuple):
            s, d = (t.to(torch.int64) for t in res)
        else:
            s = _internal_tensor(G, res["src"].to_numpy())
            d = _internal_tensor(G, res["dst"].to_numpy())
        found, _ = _edges_found(g, s, d)
        pairs = torch.unique(s * g.num_vertices + d)
        if not (len(s) == NEG_SAMPLES and not bool(found.any())
                and len(pairs) == len(s) and not bool((s == d).any())):
            raise AssertionError(f"{name}: {len(s)} pairs, "
                                 f"{int(found.sum())} edges, "
                                 f"{len(s) - len(pairs)} repeats")
        print(f"{name}: {len(s)} pairs, none an edge, a repeat or a loop",
              flush=True)
    # degree-biased endpoints: the mean log2 degree of the sources and of
    # the destinations against its value under p = degree / Σdegree.  The
    # exclusion of edges and repeats lowers it by 0.33-0.41 at RMAT-14 and
    # RMAT-16 (CPU plain path); a bias paired with the wrong vertices
    # (sorted by external id) lowered it by 2.4-2.8 there.
    s, d = (t.to(torch.int64) for t in out["negative_degree_biased"])
    deg = G.degree()["degree"].to_numpy(np.float64)
    lg = torch.as_tensor(np.log2(np.maximum(deg, 1.0)), device=s.device)
    want = float((deg / deg.sum() * lg.cpu().numpy()).sum())
    got = (float(lg[s].mean()), float(lg[d].mean()))
    if max(abs(x - want) for x in got) >= NEG_LOG2_DEGREE_TOL:
        raise AssertionError(f"degree-biased negatives: mean log2 degree "
                             f"{got} against {want}")
    print(f"negative_degree_biased: mean log2 degree of the sources and "
          f"destinations {got[0]:.4f} / {got[1]:.4f}, {want:.4f} under the "
          f"degree law (within {NEG_LOG2_DEGREE_TOL})", flush=True)


def sampled_gnn_path(G, x, labels, mask):
    """``BASELINE.json``'s fourth configuration at ogbn-arxiv's widths:
    ``make_batches`` over the GNN phase's train vertices (shuffled, seed
    0), fanout [10, 10], batches of MB_BATCH seeds; GraphSAGE(128, 256,
    40), one Adam step on each of MB_BATCHES batches, then one eval
    forward on the next; with the launch counts set to 0 just before and
    read just after (2 forward and 1 VJP K4 launch per step)."""
    import torch

    from cugraph_tpu_torch.nn import (GraphSAGE, make_batches,
                                      make_train_step,
                                      masked_cross_entropy,
                                      sage_minibatch_forward)

    ext = G.nodes()
    x_ext = torch.zeros((int(ext.max()) + 1, GNN_IN), device=G.device)
    x_ext[torch.as_tensor(ext, device=G.device)] = x
    y_ext = torch.zeros(int(ext.max()) + 1, dtype=labels.dtype,
                        device=G.device)
    y_ext[torch.as_tensor(ext, device=G.device)] = labels
    train = np.random.default_rng(0).permutation(ext[mask.cpu().numpy()])
    model = GraphSAGE(GNN_IN, GNN_HIDDEN, GNN_CLASSES, device=G.device,
                      generator=torch.Generator().manual_seed(GNN_SEED))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=GNN_LR))
    batches = make_batches(G, train, MB_FANOUT, batch_size=MB_BATCH,
                           features=x_ext, random_state=0)
    _reset_spmm_counts()
    losses, batch_s, sizes, first = [], [], [], None
    for _ in range(MB_BATCHES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, xb = next(batches)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        yb = y_ext[b.global_ids.to(torch.int64)]
        sizes.append((b.g.num_vertices, b.g.num_edges, b.num_seeds))
        if len(losses) == MB_BATCHES:
            with torch.no_grad():
                logits = sage_minibatch_forward(model, b, xb)
            eval_loss = float(masked_cross_entropy(logits, yb, b.seed_mask))
            break
        losses.append(float(step(b.g, xb, yb, b.seed_mask)))
        if first is None:
            first = {"batch": b, "x": xb, "y": yb, "loss": losses[0],
                     "grads": {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()}}
    counts = _read_spmm_counts()
    want = (2 * MB_BATCHES + 2, MB_BATCHES)
    got = (counts["spmm_csr_sum_weighted"],
           counts["spmm_csr_sum_weighted_vjp"])
    if got != want:
        raise AssertionError(f"sampled GraphSAGE: K4 forward/VJP launches "
                             f"{got}, expected {want}")
    if not (np.isfinite(losses).all() and np.isfinite(eval_loss)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"sampled GraphSAGE: losses {losses}, eval "
                             f"{eval_loss}")
    print(f"sampled GraphSAGE {GNN_IN}-{GNN_HIDDEN}-{GNN_CLASSES}: batches "
          f"(n_local, m_local, seeds) {sizes}; losses {losses}; eval loss "
          f"{eval_loss:.4f}; make_batches s per batch {batch_s}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return {"init": init, "first": first, "counts": counts, "model": model,
            "step": step, "batch_s": batch_s, "sizes": sizes,
            "losses": losses}


def check_sampled_gnn(run):
    """The first sampled step's loss and gradients against GraphSAGE in
    float64 on the same batch, with the same initial weights."""
    import torch
    import torch.nn.functional as F

    first = run["first"]
    b = first["batch"]
    agg, deg = _aggregate_f64(b.g)
    p = {k: v.double().requires_grad_(True) for k, v in run["init"].items()}
    logits = _gnn_forward_f64("graphsage", p, first["x"].double(), agg, deg)
    loss = F.cross_entropy(logits[b.seed_mask], first["y"][b.seed_mask])
    grads = torch.autograd.grad(loss, list(p.values()))
    loss_err = abs(first["loss"] - loss.item()) / abs(loss.item())
    grad_err = {k: float(torch.linalg.vector_norm(
        first["grads"][k].double() - want) / torch.linalg.vector_norm(want))
        for k, want in zip(p, grads)}
    if not (loss_err <= GNN_LOSS_RTOL
            and max(grad_err.values()) <= GNN_GRAD_RTOL):
        raise AssertionError(f"sampled GraphSAGE first step against float64: "
                             f"loss {loss_err:.3e}, gradients {grad_err}")
    print(f"sampled GraphSAGE first step against float64: loss relative "
          f"error {loss_err:.3e} (<= {GNN_LOSS_RTOL}); gradients' relative "
          f"L2 {grad_err} (<= {GNN_GRAD_RTOL})", flush=True)


def linkpred_path(G, x):
    """A full-graph GraphSAGE(128, 256, 40) encoder on the directed graph
    with the dot decoder: LP_POSITIVES edges (NumPy seed 2) against as
    many ``sample_negatives``, LP_STEPS steps of
    ``make_linkpred_train_step``, with the launch counts set to 0 just
    before and read just after; the loss must be finite and fall."""
    import torch

    from cugraph_tpu_torch.nn import (GraphSAGE, dot_decoder,
                                      make_linkpred_train_step,
                                      sample_negatives)

    g = G.structure
    src, dst, _ = G.edgelist_arrays()
    pick = np.random.default_rng(2).choice(len(src), LP_POSITIVES,
                                           replace=False)
    ps = torch.as_tensor(src[pick], device=G.device)
    pd_ = torch.as_tensor(dst[pick], device=G.device)
    ns, nd = sample_negatives(G, LP_POSITIVES, random_state=1)
    encoder = GraphSAGE(GNN_IN, GNN_HIDDEN, GNN_CLASSES, device=G.device,
                        generator=torch.Generator().manual_seed(GNN_SEED))
    step = make_linkpred_train_step(encoder, dot_decoder, torch.optim.Adam(
        encoder.parameters(), lr=LP_LR))
    args = (g, x, ps, pd_, ns, nd)
    _reset_spmm_counts()
    losses = [float(step(*args)) for _ in range(LP_STEPS)]
    counts = _read_spmm_counts()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"link prediction losses {losses}: not finite, "
                             "or the last not below the first")
    got = (counts["spmm_csr_sum_weighted"],
           counts["spmm_csr_sum_weighted_vjp"])
    if got != (2 * LP_STEPS, LP_STEPS):
        raise AssertionError(f"link prediction: K4 launches {got}")
    print(f"link prediction ({LP_POSITIVES} positives, {len(ns)} negatives, "
          f"dot decoder): losses {losses}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return {"step": step, "args": args, "counts": counts, "losses": losses}


def _wall_ms(fn, repeats):
    """Median host ms of ``fn`` to a synchronised end, after a warm-up."""
    import torch

    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs)), runs


def time_sampling(G, Gu, out, gnn_run, lp_run, card):
    """ms per call of each sampler, walk and negative sampler (host clock
    to a synchronised end, median of SAMPLING_TIMED_CALLS after a warm-up)
    with sampled rows per second, and the device's share of one profiled
    call; ms per ``per_v_random_select`` (CUDA events) and per bulk call;
    the gather and select rates that set the bulk crossover; ms per
    ``make_batches`` batch, per sampled GraphSAGE step and eval forward,
    with peak memory; ms per link-prediction step."""
    import torch

    from cugraph_tpu_torch import (biased_random_walks,
                                   homogeneous_biased_neighbor_sample,
                                   negative_sampling, node2vec_random_walks,
                                   per_v_random_select,
                                   uniform_neighbor_sample,
                                   uniform_random_walks)
    from cugraph_tpu_torch.algos import sampling
    from cugraph_tpu_torch.nn import sample_negatives

    seeds, seeds_u = out["seeds"], out["seeds_u"]
    calls = {
        "uniform_neighbor_sample_wr": lambda r: uniform_neighbor_sample(
            G, seeds, SAMPLE_FANOUT, with_replacement=True, random_state=r),
        "uniform_neighbor_sample_wor": lambda r: uniform_neighbor_sample(
            G, seeds, SAMPLE_FANOUT, with_replacement=False, random_state=r),
        "biased_neighbor_sample_wr":
            lambda r: homogeneous_biased_neighbor_sample(
                Gu, seeds_u, SAMPLE_FANOUT, with_replacement=True,
                random_state=r),
        "biased_neighbor_sample_wor":
            lambda r: homogeneous_biased_neighbor_sample(
                Gu, seeds_u, SAMPLE_FANOUT, with_replacement=False,
                random_state=r),
        "uniform_random_walks": lambda r: uniform_random_walks(
            G, seeds[:WALKERS], WALK_DEPTH, random_state=r),
        "biased_random_walks": lambda r: biased_random_walks(
            Gu, seeds_u[:WALKERS], WALK_DEPTH, random_state=r),
        "node2vec_random_walks": lambda r: node2vec_random_walks(
            Gu, out["n2v_starts"], N2V_DEPTH, p=N2V_P, q=N2V_Q,
            random_state=r),
        "negative_sampling": lambda r: negative_sampling(
            G, NEG_SAMPLES, random_state=r),
        "sample_negatives_degree_biased": lambda r: sample_negatives(
            G, NEG_SAMPLES, random_state=r, degree_biased=True),
    }
    for name, fn in calls.items():
        state = iter(range(1, 1000))
        ms, runs = _wall_ms(lambda: fn(next(state)), SAMPLING_TIMED_CALLS)
        res = fn(0)
        rows = (len(res) if hasattr(res, "shape") else
                len(res[0]) if isinstance(res, tuple) else 0)
        by_name, window = _device_ms_by_name(lambda: fn(0))
        busy = sum(by_name.values())
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        print(json.dumps({
            "metric": f"{name}_rmat{SCALE}", "ms_per_call": ms,
            "ms_per_call_runs": runs, "rows": rows,
            "rows_per_s": rows / (ms * 1e-3),
            "profiled_ms": window, "device_busy_ms": busy,
            "host_ms": window - busy, "device_idle_share": 1 - busy / window
            if by_name else "not measured",
            "device_ms_by_kernel": top, "card": card}), flush=True)
    g = G.structure
    gen = torch.Generator(device=G.device)
    gen.manual_seed(3)
    select_ms = _cuda_ms(lambda: per_v_random_select(G, gen), 20)
    bulk_ms, bulk_runs = _wall_ms(
        lambda: sampling._bulk_sample_with_replacement(
            G, g, out["frontier"], sampling.Draws(1, G.device), BULK_K), 2)
    # the gather route's cost per sampled element, on a frontier of the
    # size hop 1 reaches, and the select route's per traversed edge
    deg = g.out_degrees()
    fr = torch.as_tensor(_internal(G, _seeds_with_out_edges(
        G, SAMPLE_SEEDS * SAMPLE_FANOUT[0], 4, replace=True)),
        device=G.device)
    draws = sampling.Draws(5, G.device)
    max_deg = sampling._max_out_degree(g)
    k = SAMPLE_FANOUT[1]
    gather_ms = _cuda_ms(lambda: sampling._sample_neighbors(
        g, fr, draws, k, True, False, max_deg), 20)
    gather_cost = gather_ms * 1e-3 / (len(fr) * k)
    select_cost = select_ms * 1e-3 / (2 * g.num_edges)
    print(json.dumps({
        "metric": f"per_v_random_select_rmat{SCALE}", "ms_per_call": select_ms,
        "n": g.num_vertices, "m": g.num_edges, "card": card}), flush=True)
    print(json.dumps({
        "metric": f"bulk_sample_with_replacement_rmat{SCALE}",
        "ms_per_call": bulk_ms, "ms_per_call_runs": bulk_runs,
        "frontier": BULK_FRONTIER, "k": BULK_K, "card": card}), flush=True)
    # the samplers take the gather route only: the bulk route's whole
    # cost per pick (its k selects and its host edge lookup) against the
    # gather route's, and the frontier above which its selects alone
    # would cost less than the gathers
    bulk_cost = bulk_ms * 1e-3 / (BULK_FRONTIER * BULK_K)
    print(json.dumps({
        "metric": "bulk crossover", "gather_s_per_element": gather_cost,
        "gather_frontier": len(fr), "gather_k": k, "gather_ms": gather_ms,
        "select_s_per_edge": select_cost,
        "bulk_s_per_element": bulk_cost,
        "bulk_over_gather_per_element": bulk_cost / gather_cost,
        "frontier_where_selects_alone_win": 2 * g.num_edges * select_cost
        / gather_cost, "n": g.num_vertices, "m": g.num_edges,
        "max_out_degree": max_deg, "card": card}), flush=True)
    del deg
    # sampled GraphSAGE: a step on the first batch, its eval forward
    first = gnn_run["first"]
    b, xb, yb = first["batch"], first["x"], first["y"]
    step, model = gnn_run["step"], gnn_run["model"]
    step(b.g, xb, yb, b.seed_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _cuda_ms(lambda: step(b.g, xb, yb, b.seed_mask), 10)
    with torch.no_grad():
        eval_ms = _cuda_ms(lambda: model(b.g, xb), 5)
    print(json.dumps({
        "metric": f"sampled_graphsage_rmat{SCALE}_train_step",
        "ms_per_step": step_ms, "eval_forward_ms": eval_ms,
        "make_batches_ms_per_batch": [s * 1e3 for s in gnn_run["batch_s"]],
        "batch": MB_BATCH, "fanout": MB_FANOUT,
        "batch_sizes": gnn_run["sizes"],
        "widths": [GNN_IN, GNN_HIDDEN, GNN_CLASSES],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card}), flush=True)
    lp_ms = _cuda_ms(lambda: lp_run["step"](*lp_run["args"]), 3)
    print(json.dumps({
        "metric": f"linkpred_graphsage_rmat{SCALE}_train_step",
        "ms_per_step": lp_ms, "positives": LP_POSITIVES,
        "negatives": LP_POSITIVES, "card": card}), flush=True)
    return {"select_ms": select_ms}


# -- community detection and similarity (Louvain, Leiden, ECG, Jaccard) ------

# BASELINE.json's third configuration ("Louvain + WCC + Jaccard on
# netscience"), then the Graph500 undirected RMAT-20; leiden and ecg run on
# the same construction at RMAT-COMMUNITY_CUT_SCALE, cut for the time limit
COMMUNITY_CUT_SCALE = 18
ECG_ENSEMBLE = 16
LP_WEIGHTED_PAIRS = 1_000_000  # drawn from the edges, NumPy seed 0
LP_CHECK_PAIRS = 100_000       # held against the scipy oracle
ALL_PAIRS_SEEDS = 64
ALL_PAIRS_TOPK = 1000
NETSCIENCE_TIMED_CALLS = 3
MODULARITY_ATOL = 1e-5
PAIR_SUM_RTOL = 1e-6
COEFFS = ("jaccard", "sorensen", "overlap", "cosine")
CLUSTERING_SCORES = ("modularity", "edge_cut", "ratio_cut")


def netscience_graph(device):
    """The undirected, weighted netscience graph (the dataset's three
    columns) on ``device``."""
    from cugraph_tpu_torch import Graph

    a = np.loadtxt(NETSCIENCE)
    return Graph(device=device).from_edgelist(
        a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
        a[:, 2].astype(np.float32))


def _netscience_calls(Gn):
    """Every call of the netscience phase, by name."""
    import cugraph_tpu_torch as ct

    calls = {"louvain": lambda: ct.louvain(Gn),
             "weakly_connected_components":
                 lambda: ct.weakly_connected_components(Gn)}
    for kind in COEFFS:
        for weighted in (False, True):
            calls[f"{kind}{'_weighted' if weighted else ''}"] = (
                lambda k=kind, w=weighted: getattr(ct, k)(Gn, use_weight=w))
    calls.update({
        "leiden": lambda: ct.leiden(Gn, random_state=0),
        "ecg": lambda: ct.ecg(Gn, random_state=0),
        "all_pairs_jaccard": lambda: ct.all_pairs_jaccard(Gn, topk=100)})
    part = ct.louvain(Gn)[0]
    for score in CLUSTERING_SCORES:
        fn = getattr(ct, f"analyzeClustering_{score}")
        calls[f"analyzeClustering_{score}"] = (
            lambda f=fn: f(Gn, part.partition.max() + 1, part))
    return calls


def netscience_paths(Gn):
    """BASELINE's third configuration through the public entry points;
    the launch counts are set to 0 just before the WCC and read just
    after (one K2 (min, left) int32 launch per sweep of the undirected
    CSC).  Returns the results by call and the WCC's counts."""
    from cugraph_tpu_torch.algos import components

    out = {}
    for name, fn in _netscience_calls(Gn).items():
        if name == "weakly_connected_components":
            _reset_counts()
            out[name] = fn()
            sweeps = components.LAST_SWEEPS
            counts = _read_counts()
            if counts["spmv_semiring_min_left_i32"] != sweeps or not sweeps:
                raise AssertionError(
                    "netscience wcc launched spmv_semiring_min_left_i32 "
                    f"{counts['spmv_semiring_min_left_i32']} times in "
                    f"{sweeps} sweeps")
        else:
            out[name] = fn()
    print(f"netscience: n={Gn.number_of_vertices()} stored "
          f"m={len(Gn.edgelist_arrays()[0])}; louvain q "
          f"{out['louvain'][1]:.6f} ({out['louvain'][0].partition.nunique()} "
          f"communities), leiden q {out['leiden'][1]:.6f}, ecg q "
          f"{out['ecg'][1]:.6f}; wcc {sweeps} sweeps, "
          f"{out['weakly_connected_components'].labels.nunique()} "
          f"components; {len(out['jaccard'])} default pairs; "
          + ", ".join(f"{s} {out[f'analyzeClustering_{s}']:.6f}"
                      for s in CLUSTERING_SCORES), flush=True)
    return out, counts


def _timed_probe(record):
    """``link_prediction.pair_intersection`` wrapped to record, per call,
    its host seconds to a synchronised end and its probes (the sum over
    pairs of the smaller endpoint degree)."""
    import torch

    from cugraph_tpu_torch.algos import link_prediction

    inner = link_prediction.pair_intersection

    def probe(g, us, vs, weighted=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(g, us, vs, weighted=weighted)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        record.append({"pairs": len(us), "seconds": secs, "probes": int(
            torch.minimum(out["deg_u"], out["deg_v"]).sum())})
        return out

    return _patched(link_prediction, "pair_intersection", probe)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def community_rmat_paths(Gu, lo, hi, device):
    """The RMAT calls through the public entry points, each run once and
    timed (host clock to a synchronised end): jaccard over the default
    pairs and weighted over LP_WEIGHTED_PAIRS edge pairs, and
    all_pairs_jaccard of ALL_PAIRS_SEEDS vertices on the Graph500 RMAT-20;
    louvain, leiden and ecg on the same construction at
    COMMUNITY_CUT_SCALE (louvain cut from RMAT-20 for the time limit).
    louvain, host code that launches nothing on the card, runs once,
    under the profiler, whose window is its time."""
    import cugraph_tpu_torch as ct
    import pandas as pd

    out, secs, probes = {}, {}, []
    with _timed_probe(probes):
        out["jaccard"], secs["jaccard"] = _timed(lambda: ct.jaccard(Gu))
        pick = np.random.default_rng(0).choice(len(lo), LP_WEIGHTED_PAIRS,
                                               replace=False)
        vp = pd.DataFrame({"first": lo[pick], "second": hi[pick]})
        out["jaccard_weighted"], secs["jaccard_weighted"] = _timed(
            lambda: ct.jaccard(Gu, vp, use_weight=True))
    seeds = _seeds_with_out_edges(Gu, ALL_PAIRS_SEEDS, 0)
    out["all_pairs_jaccard"], secs["all_pairs_jaccard"] = _timed(
        lambda: ct.all_pairs_jaccard(Gu, vertices=seeds, topk=ALL_PAIRS_TOPK))
    a, b, c = RMAT_ABC
    e = ct.rmat(COMMUNITY_CUT_SCALE, EDGE_FACTOR << COMMUNITY_CUT_SCALE,
                a=a, b=b, c=c, seed=SEED)
    Gc = build_graph500_graph(e, device, COMMUNITY_CUT_SCALE)[0]
    louvain_profile = _device_ms_by_name(
        lambda: out.setdefault("louvain", ct.louvain(Gc)))
    secs["louvain"] = louvain_profile[1] / 1e3
    out["leiden"], secs["leiden"] = _timed(
        lambda: ct.leiden(Gc, random_state=0))
    out["ecg"], secs["ecg"] = _timed(
        lambda: ct.ecg(Gc, random_state=0, ensemble_size=ECG_ENSEMBLE))
    for name, s in secs.items():
        extra = ""
        if isinstance(out[name], tuple):
            extra = (f", q {out[name][1]:.6f}, "
                     f"{out[name][0].partition.nunique()} communities")
        else:
            extra = f", {len(out[name])} rows"
        print(f"{name}: {s:.3f} s{extra}", flush=True)
    return out, secs, probes, louvain_profile, Gc


def _partition_by_internal_id(G, df):
    lab = np.empty(G.number_of_vertices(), np.int64)
    lab[G.lookup_internal_vertex_id(df["vertex"].to_numpy())] = \
        df["partition"].to_numpy()
    return lab


def _modularity_f64(G, lab):
    """float64 modularity of ``lab`` (by internal id) on G's edge list,
    every self-loop counted twice, as the level loops count it."""
    src, dst, w = G.edgelist_arrays()
    w = np.ones(len(src)) if w is None else w.astype(np.float64)
    w = np.where(src == dst, 2.0 * w, w)
    m2 = w.sum()
    k = np.bincount(src, weights=w, minlength=len(lab))
    sigma = np.bincount(lab, weights=k)
    return float(w[lab[src] == lab[dst]].sum() / m2
                 - np.sum((sigma / m2) ** 2))


def _hold_partition(label, G, res, q_check):
    """A compact partition over every vertex; for louvain and leiden q
    within MODULARITY_ATOL of the float64 value on G; for leiden connected
    communities.  Returns the float64 modularity."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    df, q = res
    n = G.number_of_vertices()
    lab = _partition_by_internal_id(G, df)
    if len(df) != n or set(np.unique(lab)) != set(range(lab.max() + 1)):
        raise AssertionError(f"{label}: the partition is not 0..k-1 over "
                             f"the {n} vertices")
    q64 = _modularity_f64(G, lab)
    if q_check and abs(q - q64) > MODULARITY_ATOL:
        raise AssertionError(f"{label}: q {q} against {q64} in float64")
    if label.startswith("leiden"):
        src, dst, _ = G.edgelist_arrays()
        keep = lab[src] == lab[dst]
        A = sp.csr_matrix((np.ones(int(keep.sum())),
                           (src[keep], dst[keep])), shape=(n, n))
        comps, _ = csgraph.connected_components(A, directed=False)
        if comps != lab.max() + 1:
            raise AssertionError(f"{label}: {lab.max() + 1} communities "
                                 f"but {comps} connected pieces")
    print(f"{label}: {lab.max() + 1} communities, q {q!r}, float64 "
          f"{q64!r}", flush=True)
    return q64


def _pair_oracle(G, us, vs):
    """scipy's count, sum_min and sum_max of each pair, float64."""
    import scipy.sparse as sp

    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    P = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    W = sp.csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    both = P[us].multiply(P[vs])
    count = np.asarray(both.sum(axis=1)).ravel()
    wu, wv = W[us], W[vs]
    smin = np.asarray(wu.minimum(wv).multiply(both).sum(axis=1)).ravel()
    smax = np.asarray(wu.maximum(wv).multiply(both).sum(axis=1)).ravel()
    return count, smin, smax


def check_community_paths(Gn, net_out, Gu, rmat_out, Gc):
    """The community and similarity results: partitions, modularity,
    Leiden's connectivity, ECG's float64 modularity on the input graph;
    the card's pair probe against a scipy oracle, twice bit-identical;
    netscience on the card against the CPU, bit for bit."""
    import pandas as pd
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos import link_prediction
    from cugraph_tpu_torch.prims.intersection import pair_intersection

    for label, G, res, q_check in (
            ("louvain netscience", Gn, net_out["louvain"], True),
            ("leiden netscience", Gn, net_out["leiden"], True),
            ("ecg netscience", Gn, net_out["ecg"], False),
            (f"louvain rmat{COMMUNITY_CUT_SCALE}", Gc, rmat_out["louvain"],
             True),
            (f"leiden rmat{COMMUNITY_CUT_SCALE}", Gc, rmat_out["leiden"],
             True),
            (f"ecg rmat{COMMUNITY_CUT_SCALE}", Gc, rmat_out["ecg"], False)):
        q64 = _hold_partition(label, G, res, q_check)
        if label.startswith("ecg") and not q64 > 0:
            raise AssertionError(f"{label}: float64 modularity {q64} on the "
                                 "input graph")
    src, dst, _ = Gn.edgelist_arrays()
    n = Gn.number_of_vertices()
    _, comp = csgraph.connected_components(sp.csr_matrix(
        (np.ones(len(src)), (src, dst)), shape=(n, n)), directed=False)
    minid = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(minid, comp, np.arange(n))
    wcc = net_out["weakly_connected_components"]
    if not np.array_equal(_internal(Gn, wcc["labels"].to_numpy()),
                          minid[comp]):
        raise AssertionError("netscience wcc differs from scipy's components")

    # the pair probe against scipy on LP_CHECK_PAIRS default pairs
    us_all, vs_all = link_prediction._default_pairs(Gu)
    pick = np.random.default_rng(1).choice(len(us_all), LP_CHECK_PAIRS,
                                           replace=False)
    us, vs = us_all[pick], vs_all[pick]
    runs = [pair_intersection(Gu.structure, us, vs, weighted=True)
            for _ in range(2)]
    for key in runs[0]:
        if not torch.equal(runs[0][key], runs[1][key]):
            raise AssertionError(f"pair probe: {key} differs between two "
                                 "launches")
    got = {k: v.cpu().numpy() for k, v in runs[0].items()}
    count, smin, smax = _pair_oracle(Gu, us, vs)
    if not np.array_equal(got["count"], count):
        raise AssertionError("pair probe counts differ from scipy's")
    worst = 0.0
    for key, want in (("sum_min", smin), ("sum_max", smax)):
        err = np.abs(got[key] - want)
        bad = err > PAIR_SUM_RTOL * np.abs(want)
        if bad.any():
            raise AssertionError(f"pair probe {key}: {int(bad.sum())} pairs "
                                 f"past rtol {PAIR_SUM_RTOL}")
        worst = max(worst, float((err / np.maximum(want, 1e-30)).max()))
    frame = rmat_out["jaccard"]
    deg = np.diff(Gu.structure.csr.offsets.cpu().numpy())
    want_j = count / (deg[us] + deg[vs] - count)
    if not np.array_equal(frame["jaccard_coeff"].to_numpy()[pick], want_j):
        raise AssertionError("jaccard(Gu) differs from the oracle's "
                             "coefficients on the checked pairs")
    print(f"pair probe at RMAT-{SCALE}: {LP_CHECK_PAIRS} default pairs, "
          f"{int(count.sum())} common neighbours, counts and jaccard equal "
          f"scipy's, sum_min/sum_max within {worst:.3g} relative, two "
          "launches bit-identical", flush=True)

    # netscience on the card against the CPU plain path
    Gcpu = netscience_graph("cpu")
    for name, fn in (("louvain", ct.louvain),
                     ("leiden", lambda G: ct.leiden(G, random_state=0)),
                     ("ecg", lambda G: ct.ecg(G, random_state=0))):
        a, b = fn(Gcpu), net_out[name]
        if not a[0].equals(b[0]) or a[1] != b[1]:
            raise AssertionError(f"netscience {name} differs on the card")
    for weighted in (False, True):
        name = "jaccard_weighted" if weighted else "jaccard"
        a = ct.jaccard(Gcpu, use_weight=weighted)
        if not a.equals(net_out[name]):
            raise AssertionError(f"netscience {name} frames differ on the "
                                 "card")
    uc, vc = link_prediction._default_pairs(Gcpu)
    x = pair_intersection(Gcpu.structure, uc, vc)
    y = pair_intersection(Gn.structure, uc, vc)
    if not torch.equal(x["count"], y["count"].cpu()):
        raise AssertionError("netscience pair counts differ on the card")
    if not ct.all_pairs_jaccard(Gcpu, topk=100).equals(
            net_out["all_pairs_jaccard"]):
        raise AssertionError("netscience all_pairs_jaccard differs on the "
                             "card")
    for name, res in rmat_out.items():
        if isinstance(res, pd.DataFrame):
            col = [c for c in res.columns if c.endswith("_coeff")][0]
            vals = res[col].to_numpy()
            if not (np.isfinite(vals).all() and (vals >= 0).all()
                    and (vals <= 1 + 1e-6).all()):
                raise AssertionError(f"{name}: coefficients outside [0, 1]")
    print("netscience on the card equals the CPU run: louvain, leiden, ecg "
          "partitions and q, jaccard frames and pair counts, "
          "all_pairs_jaccard", flush=True)


def time_community(Gn, Gu, rmat_secs, probes, louvain_profile, card):
    """ms per netscience call (median of NETSCIENCE_TIMED_CALLS after a
    warm-up); the RMAT calls' single runs; the card probe's probes per
    second; device busy against host ms for one profiled jaccard(Gu) and
    the path's profiled louvain at COMMUNITY_CUT_SCALE; one torch
    local-moving sweep on the card beside one native sweep at RMAT-20."""
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos import community
    from cugraph_tpu_torch.core import native

    for name, fn in _netscience_calls(Gn).items():
        ms, runs = _wall_ms(fn, NETSCIENCE_TIMED_CALLS)
        print(json.dumps({"metric": f"{name}_netscience", "ms_per_call": ms,
                          "ms_per_call_runs": runs, "card": card}),
              flush=True)
    for name, s in rmat_secs.items():
        scale = SCALE if name in ("jaccard", "jaccard_weighted",
                                  "all_pairs_jaccard") \
            else COMMUNITY_CUT_SCALE
        print(json.dumps({"metric": f"{name}_rmat{scale}",
                          "ms_per_call": s * 1e3, "runs": 1, "card": card}),
              flush=True)
    for label, rec in zip(("jaccard default pairs", "jaccard weighted"),
                          probes):
        print(json.dumps({
            "metric": f"pair_probe_rmat{SCALE}", "call": label,
            "pairs": rec["pairs"], "probes": rec["probes"],
            "ms": rec["seconds"] * 1e3,
            "probes_per_s": rec["probes"] / rec["seconds"], "card": card}),
            flush=True)
    for name, scale, (by_name, window) in (
            ("jaccard", SCALE, _device_ms_by_name(lambda: ct.jaccard(Gu))),
            ("louvain", COMMUNITY_CUT_SCALE, louvain_profile)):
        busy = sum(by_name.values())
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        print(json.dumps({
            "metric": f"{name}_rmat{scale}_profile", "profiled_ms": window,
            "device_busy_ms": busy, "host_ms": window - busy,
            "device_idle_share": 1 - busy / window,
            "device_kernels_seen": len(by_name),
            "device_ms_by_kernel": top, "card": card}), flush=True)

    # one local-moving sweep from singletons: the torch plain version on
    # the card, the native engine on the host
    src, dst, w = Gu.edgelist_arrays()
    n = Gu.number_of_vertices()
    w2 = community._loop_doubled_weights(src, dst, w)
    s_t, d_t, w_t = (torch.as_tensor(a, device=Gu.device)
                     for a in (src, dst, w2))
    cl = np.arange(n, dtype=np.int32)
    cl_t = torch.as_tensor(cl, device=Gu.device)
    community._louvain_move_sweep_torch(s_t, d_t, w_t, cl_t, True, 1.0, n)
    moved_t, t_torch = _timed(lambda: community._louvain_move_sweep_torch(
        s_t, d_t, w_t, cl_t, True, 1.0, n))
    agg_s, agg_d, agg_w = native.coarsen_edges_native(src, dst, w2, n)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(agg_s, minlength=n), out=row_off[1:])
    t0 = time.perf_counter()
    moved_n = native.louvain_sweep_native(agg_d, agg_w, row_off, cl, True,
                                          1.0)
    t_native = time.perf_counter() - t0
    agree = float((moved_t.cpu().numpy() == moved_n).mean())
    print(json.dumps({
        "metric": f"louvain_sweep_rmat{SCALE}", "torch_card_ms": t_torch * 1e3,
        "native_host_ms": t_native * 1e3,
        "moved_torch": int((moved_t.cpu().numpy() != cl).sum()),
        "moved_native": int((moved_n != cl).sum()),
        "same_cluster_share": agree, "card": card}), flush=True)


# -- edge properties, heterogeneous and temporal sampling, MultiGraph --------

# the typed directed RMAT-20: the PageRank cell's edge list with edge ids
# 0..m-1, EDGE_TYPES types and integer-valued float32 times in
# [0, TIME_SPAN) (exact in float32), then uniform (0, 1] weights, drawn in
# that order by default_rng(TYPE_SEED)
TYPE_SEED, EDGE_TYPES, TIME_SPAN = 23, 4, 1 << 20
HET_FANOUT = [4, 3, 2, 1] * 2      # 10 per source and hop, as [10, 10]
LOOKUP_IDS, LOOKUP_SEED = 1_000_000, 0
MULTI_SCALE = 18                   # the MultiGraph's raw R-MAT list
# the χ² tests: HUB_COPIES batches, each the top hub, one pick of type 0,
# binned into HUB_BINS runs of the hub's type-0 edges in CSR order
HUB_COPIES, HUB_BINS, HUB_CHI2_BOUND = 4096, 20, 50.8  # 0.9999, 19 dof


def _masked_calls(Gt, seeds):
    """The masked paths through the public entry points, by name: each a
    function of ``random_state``; with (sampler, fanouts per hop as
    per-type lists, seed time, comparison, biased) for its checks."""
    import cugraph_tpu_torch as ct

    het = [HET_FANOUT[:EDGE_TYPES], HET_FANOUT[EDGE_TYPES:]]
    homo = [[k] for k in SAMPLE_FANOUT]
    strict, last = "strictly_increasing", "last"
    return {
        "het_uniform": (lambda r: ct.heterogeneous_uniform_neighbor_sample(
            Gt, seeds, HET_FANOUT, random_state=r), het, None, strict,
            False),
        "het_biased": (lambda r: ct.heterogeneous_biased_neighbor_sample(
            Gt, seeds, HET_FANOUT, random_state=r), het, None, strict,
            True),
        "temporal_uniform": (
            lambda r: ct.homogeneous_uniform_temporal_neighbor_sample(
                Gt, seeds, SAMPLE_FANOUT, seed_time=0.0, random_state=r),
            homo, 0.0, strict, False),
        "temporal_biased": (
            lambda r: ct.homogeneous_biased_temporal_neighbor_sample(
                Gt, seeds, SAMPLE_FANOUT, seed_time=0.0, random_state=r),
            homo, 0.0, strict, True),
        "temporal_last": (
            lambda r: ct.homogeneous_uniform_temporal_neighbor_sample(
                Gt, seeds, SAMPLE_FANOUT, seed_time=float(TIME_SPAN),
                temporal_sampling_comparison="last", random_state=r),
            homo, float(TIME_SPAN), last, False),
        "het_temporal_uniform": (
            lambda r: ct.heterogeneous_uniform_temporal_neighbor_sample(
                Gt, seeds, HET_FANOUT, seed_time=0.0, random_state=r),
            het, 0.0, strict, False),
        "het_temporal_biased": (
            lambda r: ct.heterogeneous_biased_temporal_neighbor_sample(
                Gt, seeds, HET_FANOUT, seed_time=0.0, random_state=r),
            het, 0.0, strict, True),
        "heterogeneous_neighbor_sample": (
            lambda r: ct.heterogeneous_neighbor_sample(
                Gt, seeds, None, HET_FANOUT, num_edge_types=EDGE_TYPES,
                random_state=r), het, None, strict, False),
        "uniform_with_edge_properties": (
            lambda r: ct.uniform_neighbor_sample(
                Gt, seeds, SAMPLE_FANOUT, with_edge_properties=True,
                random_state=r), None, None, None, False),
    }


def typed_graph(edges, device):
    """The typed directed RMAT-20 through ``from_edgelist(edge_id=,
    edge_type=, edge_time=)``; prints the host set-up seconds and the
    stored edge count, and checks the CSR's kept permutation against
    ``np.lexsort`` over every stored edge and the properties in CSR order
    against the stored ones at it."""
    import torch

    from cugraph_tpu_torch import Graph
    from cugraph_tpu_torch.algos import sampling

    src, dst = edges["src"].to_numpy(), edges["dst"].to_numpy()
    m = len(src)
    rng = np.random.default_rng(TYPE_SEED)
    etype = rng.integers(0, EDGE_TYPES, m).astype(np.int32)
    etime = rng.integers(0, TIME_SPAN, m).astype(np.float32)
    w = (1.0 - rng.random(m)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Gt = Graph(directed=True, device=device).from_edgelist(
        src, dst, w, edge_id=np.arange(m, dtype=np.int64), edge_type=etype,
        edge_time=etime)
    g = Gt.structure
    props = {name: sampling._csr_prop(Gt, name)
             for name in sampling._EDGE_PROPS}
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    s, d, _ = Gt.edgelist_arrays()
    t1 = time.perf_counter()
    want = np.lexsort((d, s))
    lexsort_s = time.perf_counter() - t1
    if not np.array_equal(g.csr.perm.cpu().numpy(), want):
        raise AssertionError("the CSR's kept permutation is not np.lexsort "
                             "over the stored edges")
    for name, stored in (("edge_id", Gt.edge_ids), ("edge_type",
                                                    Gt.edge_types),
                         ("edge_time", Gt.edge_times)):
        if not np.array_equal(props[name].cpu().numpy(), stored[want]):
            raise AssertionError(f"{name} in CSR order is not the stored "
                                 "property at the permutation")
    print(json.dumps({
        "metric": f"typed_rmat{SCALE}_host_setup", "seconds": setup,
        "input_edges": m, "stored_edges": g.num_edges,
        "n": g.num_vertices, "types": EDGE_TYPES, "time_span": TIME_SPAN,
        "np_lexsort_check_s": lexsort_s}), flush=True)
    print(f"typed RMAT-{SCALE}: {g.num_edges} stored edges of {m}; the "
          "CSR's permutation equals np.lexsort over them, and the ids, "
          "types and times in CSR order are the stored ones at it",
          flush=True)
    return Gt


def _lookup_queries(m):
    """LOOKUP_IDS (id, type) queries, NumPy seed LOOKUP_SEED: ids in
    [-1000, m + 1000) and types in [0, EDGE_TYPES], so that some miss by
    id, by range and by type."""
    rng = np.random.default_rng(LOOKUP_SEED)
    return (rng.integers(-1000, m + 1000, LOOKUP_IDS),
            rng.integers(0, EDGE_TYPES + 1, LOOKUP_IDS))


def _lookup_all(table, ids, types):
    """``lookup_vertex_ids`` once per type; (src, dst) in query order."""
    src = np.empty(len(ids), np.int64)
    dst = np.empty(len(ids), np.int64)
    for t in range(EDGE_TYPES + 1):
        at = np.flatnonzero(types == t)
        df = table.lookup_vertex_ids(ids[at], t)
        src[at], dst[at] = df["src"].to_numpy(), df["dst"].to_numpy()
    return src, dst


def masked_paths(Gt):
    """Through the public entry points, each with the launch counts set to
    0 just before and read just after: the two heterogeneous samplers, the
    three temporal ones, the two heterogeneous temporal ones,
    ``heterogeneous_neighbor_sample`` and ``uniform_neighbor_sample(
    with_edge_properties=True)`` from SAMPLE_SEEDS seeds with out-edges,
    and an ``EdgeIdLookupTable`` built and queried LOOKUP_IDS times.
    Returns the results, the counts and the seconds by path."""
    import torch

    from cugraph_tpu_torch import EdgeIdLookupTable

    seeds = _seeds_with_out_edges(Gt, SAMPLE_SEEDS, SAMPLE_SEED)
    calls = _masked_calls(Gt, seeds)
    ids, types = _lookup_queries(len(Gt.edge_ids))
    out, counts, secs = {"seeds": seeds, "ids": ids, "types": types}, {}, {}
    runs = {name: functools.partial(spec[0], 0)
            for name, spec in calls.items()}
    runs["lookup_table_build"] = lambda: EdgeIdLookupTable(Gt)
    runs["lookup"] = lambda: _lookup_all(out["lookup_table_build"], ids,
                                         types)
    for name, fn in runs.items():
        _reset_spmm_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = _read_spmm_counts()
        launched = {k: v for k, v in counts[name].items() if v}
        if launched:
            raise AssertionError(f"{name} launched {launched}; no K-kernel "
                                 "lies on the masked sampling path")
        size = len(out[name]) if hasattr(out[name], "__len__") else ""
        print(f"masked path {name}: {secs[name]:.3f} s, {size} results, "
              f"launches {launched}", flush=True)
    return out, counts, secs


def _check_rows(label, Gt, df, table):
    """Every row an edge of Gt whose weight, id, type and time are the
    frame's, and the lookup table's endpoints for its (id, type) the
    row's.  Returns (source, destination, CSR position, the frame's
    columns) on the card."""
    import torch

    from cugraph_tpu_torch.algos import sampling

    g = Gt.structure
    s = _internal_tensor(Gt, df["sources"].to_numpy())
    d = _internal_tensor(Gt, df["destinations"].to_numpy())
    found, pos = _edges_found(g, s, d)
    if not bool(found.all()):
        raise AssertionError(f"{label}: {int((~found).sum())} rows are not "
                             "edges")
    col = {name: torch.as_tensor(df[name].to_numpy().copy(),
                                 device=Gt.device)
           for name in ("weight", *sampling._EDGE_PROPS)}
    if not (torch.equal(g.csr.weights[pos], col["weight"]) and all(
            torch.equal(sampling._csr_prop(Gt, name)[pos], col[name])
            for name in sampling._EDGE_PROPS)):
        raise AssertionError(f"{label}: a row's weight, id, type or time "
                             "is not its edge's")
    ls, ld = _lookup_all(table, df["edge_id"].to_numpy(),
                         df["edge_type"].to_numpy())
    if not (np.array_equal(ls, df["sources"].to_numpy())
            and np.array_equal(ld, df["destinations"].to_numpy())):
        raise AssertionError(f"{label}: the lookup table gives other "
                             "endpoints for a row's (id, type)")
    return s, d, pos, col


def _check_masked_frame(label, Gt, df, seeds, fanouts, seed_time,
                        comparison, biased, table):
    """``_check_rows``; then per hop, the rows of each (source, batch,
    type) are Σ over the source's copies in the batch's frontier of min(k,
    its eligible edges) (all for k < 0, none for 0), distinct where the
    source has one copy; each row's time passes the comparison against
    the time its source was reached with (the seed time at hop 0), so
    temporal paths increase strictly (decrease under "last")."""
    import torch

    from cugraph_tpu_torch.algos import sampling
    from cugraph_tpu_torch.algos._frontier import temporal_eligible

    g = Gt.structure
    csr, dev, n = g.csr, Gt.device, g.num_vertices
    s, d, pos, col = _check_rows(label, Gt, df, table)
    types = sampling._csr_prop(Gt, "edge_type").to(torch.int64)
    times = sampling._csr_prop(Gt, "edge_time")
    ntypes = len(fanouts[0])
    hop = torch.as_tensor(df["hop_id"].to_numpy().copy(), device=dev)
    bat = torch.as_tensor(df["batch_id"].to_numpy().astype(np.int64),
                          device=dev)
    rtype = col["edge_type"].to(torch.int64) if ntypes > 1 else \
        torch.zeros_like(s)
    fv = torch.as_tensor(_internal(Gt, seeds), device=dev)
    fb = torch.arange(len(seeds), device=dev)
    ft = torch.full((len(seeds),), np.float32(seed_time or 0.0),
                    device=dev)
    rows_checked = 0
    for h, ks in enumerate(fanouts):
        here = hop == h
        # eligible edges of each frontier copy by type
        r, _, e = sampling._frontier_edges(csr, fv)
        ok = torch.ones(e.shape, dtype=torch.bool, device=dev)
        if seed_time is not None:
            ok = temporal_eligible(times[e], ft[r], comparison)
        if biased and comparison != "last":
            ok &= csr.weights[e] > 0
        te = types[e] if ntypes > 1 else torch.zeros_like(e)
        ok &= te < ntypes
        cnt = torch.zeros(len(fv) * ntypes, dtype=torch.int64, device=dev)
        cnt.index_add_(0, r * ntypes + te.clamp(max=ntypes - 1),
                       ok.to(torch.int64))
        k = torch.as_tensor(ks, device=dev)
        want = torch.where(k < 0, cnt.view(-1, ntypes),
                           torch.minimum(cnt.view(-1, ntypes), k))
        # by (batch, source, type): the copies' sum against the rows
        key_f = fb * n + fv
        key_r = bat[here] * n + s[here]
        keys, inv = torch.unique(torch.cat([key_f, key_r]),
                                 return_inverse=True)
        exp = torch.zeros((len(keys), ntypes), dtype=torch.int64,
                          device=dev)
        exp.index_add_(0, inv[:len(fv)], want)
        got = torch.zeros(len(keys) * ntypes, dtype=torch.int64, device=dev)
        got.index_add_(0, inv[len(fv):] * ntypes + rtype[here],
                       torch.ones_like(key_r))
        if not torch.equal(got.view(-1, ntypes), exp):
            raise AssertionError(f"{label}: hop {h} rows per (source, "
                                 "batch, type) are not Σ min(k, eligible) "
                                 "over the source's copies")
        copies = torch.zeros(len(keys), dtype=torch.int64, device=dev)
        copies.index_add_(0, inv[:len(fv)], torch.ones_like(key_f))
        once = copies[inv[len(fv):]] == 1
        pair = (key_r * csr.num_edges + pos[here])[once]
        if len(torch.unique(pair)) != len(pair):
            raise AssertionError(f"{label}: hop {h} repeats an edge for a "
                                 "source with one copy")
        if seed_time is not None:
            up = comparison in ("strictly_increasing",
                                "monotonically_increasing")
            best = torch.full((len(keys),), torch.inf if up else -torch.inf,
                              device=dev)
            best.scatter_reduce_(0, inv[:len(fv)], ft,
                                 "amin" if up else "amax")
            if not bool(temporal_eligible(col["edge_time"][here],
                                          best[inv[len(fv):]],
                                          comparison).all()):
                raise AssertionError(f"{label}: hop {h} has a row whose "
                                     "time fails the comparison against "
                                     "every time its source was reached "
                                     "with")
        rows_checked += int(here.sum())
        # the next frontier: this hop's destinations with multiplicity
        fv, fb, ft = d[here], bat[here], col["edge_time"][here]
    if rows_checked != len(df):
        raise AssertionError(f"{label}: {len(df) - rows_checked} rows "
                             "beyond the hops")
    print(f"{label}: {len(df)} rows, each an edge with its weight, id, type "
          "and time and its (id, type)'s endpoints; rows per (source, "
          "batch, type, hop) as min(k, eligible) over the copies, distinct "
          "per copy" + ("; times pass the comparison along every path"
                        if seed_time is not None else ""), flush=True)


def _hub_chi2(Gt, df, hub, biased):
    """χ² of one type-0 pick per batch from the hub over HUB_BINS runs of
    its type-0 edges in CSR order, against equal shares (uniform) or the
    runs' weight shares (biased)."""
    import torch

    from cugraph_tpu_torch.algos import sampling

    g = Gt.structure
    csr = g.csr
    lo, hi = int(csr.offsets[hub]), int(csr.offsets[hub + 1])
    types = sampling._csr_prop(Gt, "edge_type")[lo:hi]
    e0 = torch.nonzero(types == 0).flatten() + lo
    s = _internal_tensor(Gt, df["sources"].to_numpy())
    d = _internal_tensor(Gt, df["destinations"].to_numpy())
    _, pos = _edges_found(g, s, d)
    rank = torch.searchsorted(e0, pos)
    if not (len(df) == HUB_COPIES and bool((s == hub).all())
            and bool((e0[rank.clamp(max=len(e0) - 1)] == pos).all())):
        raise AssertionError("hub picks: not one type-0 edge of the hub per "
                             "batch")
    bins = (rank * HUB_BINS // len(e0)).cpu().numpy()
    counts = np.bincount(bins, minlength=HUB_BINS)
    edge_bin = np.arange(len(e0)) * HUB_BINS // len(e0)
    w = (csr.weights[e0].double().cpu().numpy() if biased
         else np.ones(len(e0)))
    exp = HUB_COPIES * np.bincount(edge_bin, weights=w,
                                   minlength=HUB_BINS) / w.sum()
    return float(((counts - exp) ** 2 / exp).sum()), len(e0)


def check_masked_paths(Gt, out):
    """``_check_masked_frame`` on every sampled frame (``_check_frame`` and
    ``_check_rows`` on the homogeneous one), the lookup table against a
    NumPy oracle, the two χ² tests on the top hub, and the card against
    the CPU at RMAT-SAMPLING_CHECK_SCALE."""
    import cugraph_tpu_torch as ct

    table = out["lookup_table_build"]
    seeds = out["seeds"]
    for name, (_, fanouts, seed_time, comparison, biased) in \
            _masked_calls(Gt, seeds).items():
        if fanouts is None:   # with replacement: the homogeneous checks
            _check_frame(name, Gt, out[name], seeds, SAMPLE_FANOUT[0], True)
            _check_rows(name, Gt, out[name], table)
            continue
        _check_masked_frame(name, Gt, out[name], seeds, fanouts, seed_time,
                            comparison, biased, table)
    # the lookup against a NumPy oracle: the stored ids are distinct
    # (directed, de-duplicated, ids 0..m-1)
    ids, types = out["ids"], out["types"]
    s, d, _ = Gt.edgelist_arrays()
    m_in = len(Gt.edge_ids) and int(Gt.edge_ids.max()) + 1
    src_of = np.full(m_in, -1, np.int64)
    dst_of = np.full(m_in, -1, np.int64)
    type_of = np.full(m_in, -1, np.int64)
    src_of[Gt.edge_ids], dst_of[Gt.edge_ids] = s, d
    type_of[Gt.edge_ids] = Gt.edge_types
    ok = (ids >= 0) & (ids < m_in)
    safe = np.where(ok, ids, 0)
    hit = ok & (src_of[safe] >= 0) & (type_of[safe] == types)
    nm = Gt.number_map
    want_s = np.where(hit, nm.to_external(np.maximum(src_of[safe], 0)), -1)
    want_d = np.where(hit, nm.to_external(np.maximum(dst_of[safe], 0)), -1)
    got_s, got_d = out["lookup"]
    if not (np.array_equal(got_s, want_s) and np.array_equal(got_d, want_d)):
        raise AssertionError("EdgeIdLookupTable differs from the NumPy "
                             "oracle")
    print(f"EdgeIdLookupTable: {LOOKUP_IDS} queries, {int(hit.sum())} hits "
          f"and {int((~hit).sum())} misses, equal to the NumPy oracle",
          flush=True)
    hub = int(Gt.structure.out_degrees().argmax())
    hub_ext = Gt.number_map.to_external(np.array([hub]))
    copies = np.repeat(hub_ext, HUB_COPIES)
    one = [1] + [0] * (EDGE_TYPES - 1)
    for label, fn, biased in (
            ("uniform", ct.heterogeneous_uniform_neighbor_sample, False),
            ("biased", ct.heterogeneous_biased_neighbor_sample, True)):
        chi2, deg0 = _hub_chi2(Gt, fn(Gt, copies, one, random_state=5),
                               hub, biased)
        if chi2 >= HUB_CHI2_BOUND:
            raise AssertionError(f"{label} type-0 picks on the hub: χ² "
                                 f"{chi2} over {HUB_BINS} bins")
        print(f"hub {hub} ({deg0} type-0 out-edges), {HUB_COPIES} {label} "
              f"picks: χ² over {HUB_BINS} runs of its edges {chi2:.2f} "
              f"(< {HUB_CHI2_BOUND})", flush=True)
    _check_masked_card_against_cpu(Gt.device)


def _typed_small_graphs(device):
    """The typed construction at RMAT-SAMPLING_CHECK_SCALE on ``device``."""
    from cugraph_tpu_torch import Graph, rmat

    a, b, c = RMAT_ABC
    e = rmat(SAMPLING_CHECK_SCALE, EDGE_FACTOR << SAMPLING_CHECK_SCALE,
             a=a, b=b, c=c, seed=SEED)
    m = len(e)
    rng = np.random.default_rng(TYPE_SEED)
    props = dict(edge_id=np.arange(m, dtype=np.int64),
                 edge_type=rng.integers(0, EDGE_TYPES, m).astype(np.int32),
                 edge_time=rng.integers(0, 64, m).astype(np.float32))
    w = (1.0 - rng.random(m)).astype(np.float32)
    return Graph(directed=True, device=device).from_edgelist(
        e["src"].to_numpy(), e["dst"].to_numpy(), w, **props)


def _check_masked_card_against_cpu(device):
    """At RMAT-SAMPLING_CHECK_SCALE, the same draws on the card and on the
    CPU: the masked frames equal on the tile route and (threshold 0) on
    the per-edge route; under "last" the card's per-edge route equals the
    CPU's tile route."""
    from cugraph_tpu_torch.algos import sampling

    graphs = {dev: _typed_small_graphs(dev) for dev in ("cpu", device)}
    seeds = _seeds_with_out_edges(graphs["cpu"], 64, 0)

    def frame(dev, threshold, biased, het, seed_time, comparison=None):
        G = graphs[dev]
        types, fanouts = (sampling._het_fanouts(G, HET_FANOUT, None) if het
                          else (None, [[(0, k)] for k in SAMPLE_FANOUT]))
        ctx = (_patched(sampling, "_TILE_FALLBACK_ENTRIES", threshold)
               if threshold is not None else contextlib.nullcontext())
        with ctx:
            return sampling._masked_neighbor_sample(
                G, seeds, fanouts, types=types, seed_time=seed_time,
                biased=biased, temporal_sampling_comparison=comparison,
                draws=_HostDraws(0, G.device))

    compared = 0
    for biased, het, seed_time in ((False, True, None), (True, True, None),
                                   (False, False, 8.0), (True, True, 8.0)):
        for threshold in (None, 0):
            a = frame("cpu", threshold, biased, het, seed_time)
            b = frame(device, threshold, biased, het, seed_time)
            if len(a) == 0 or not a.equals(b):
                raise AssertionError(
                    f"masked frames differ on the card (biased={biased}, "
                    f"heterogeneous={het}, seed_time={seed_time}, tile "
                    f"threshold {threshold})")
            compared += 1
    for het in (False, True):
        a = frame("cpu", None, False, het, 60.0, "last")
        b = frame(device, 0, False, het, 60.0, "last")
        if len(a) == 0 or not a.equals(b):
            raise AssertionError("\"last\": the card's per-edge route "
                                 "differs from the CPU's tile route")
        compared += 1
    print(f"masked sampling, card against the CPU at "
          f"RMAT-{SAMPLING_CHECK_SCALE}: {compared} frames equal (tile and "
          "per-edge routes on the same draws; \"last\" per-edge on the card "
          "against the tile on the CPU)", flush=True)


def multigraph_path(device):
    """A directed ``MultiGraph`` from the raw RMAT-MULTI_SCALE list with
    its duplicates, then ``pagerank`` (the launch counts set to 0 just
    before and read just after) and ``count_multi_edges``; checks PageRank
    within L1_TOL of float64 with the duplicates summed, and the count
    against a NumPy sort.  Returns the counts and the seconds."""
    import torch

    from cugraph_tpu_torch import MultiGraph, count_multi_edges, pagerank, rmat

    a, b, c = RMAT_ABC
    e = rmat(MULTI_SCALE, EDGE_FACTOR << MULTI_SCALE, a=a, b=b, c=c,
             seed=SEED)
    t0 = time.perf_counter()
    Gm = MultiGraph(directed=True, device=device).from_edgelist(e, "src",
                                                                "dst")
    Gm.structure
    torch.cuda.synchronize()
    secs = {"setup": time.perf_counter() - t0}
    _reset_counts()
    pr, secs["pagerank"] = _timed(lambda: pagerank(Gm))
    counts = _read_counts()
    multi, secs["count_multi_edges"] = _timed(lambda: count_multi_edges(Gm))
    if counts["spmv_csr_sum_mul"] == 0:
        raise AssertionError("MultiGraph pagerank launched K1 (mul) no time")
    p_ref, it_ref = pagerank_reference(reference_matrix(Gm), 100,
                                       float(np.float32(1e-5)))
    _hold(f"MultiGraph RMAT-{MULTI_SCALE} pagerank ({len(e)} edges, "
          f"{counts['spmv_csr_sum_mul']} K1 launches, reference "
          f"{it_ref} iterations)", _by_internal_id(Gm, pr, "pagerank"),
          p_ref)
    s, d, _ = Gm.edgelist_arrays()
    key = np.sort((s.astype(np.int64) << 32) | d.astype(np.int64))
    want = int((key[1:] == key[:-1]).sum())
    if multi != want or multi == 0:
        raise AssertionError(f"count_multi_edges {multi}, NumPy sort {want}")
    print(f"MultiGraph: {Gm.structure.num_edges} stored edges, "
          f"count_multi_edges {multi} = NumPy sort count; {secs}; "
          f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
    return counts, secs


def time_masked(Gt, out, secs, multi_secs, card):
    """ms per call of each masked path (host clock to a synchronised end,
    median of SAMPLING_TIMED_CALLS after a warm-up) with rows per second;
    the lookup table's build and its LOOKUP_IDS queries; the MultiGraph's
    seconds; one profiled ``heterogeneous_biased_temporal_neighbor_sample``
    call (device busy, host ms, idle share) and a cProfile of one call by
    host function (the host framing below the call)."""
    import cProfile
    import pstats

    for name, spec in _masked_calls(Gt, out["seeds"]).items():
        fn = spec[0]
        state = iter(range(1, 1000))
        ms, runs = _wall_ms(lambda: fn(next(state)), SAMPLING_TIMED_CALLS)
        rows = len(out[name])
        print(json.dumps({
            "metric": f"{name}_typed_rmat{SCALE}", "ms_per_call": ms,
            "ms_per_call_runs": runs, "rows": rows,
            "rows_per_s": rows / (ms * 1e-3), "seeds": SAMPLE_SEEDS,
            "card": card}), flush=True)
    table = out["lookup_table_build"]
    ms, runs = _wall_ms(lambda: _lookup_all(table, out["ids"],
                                            out["types"]), 3)
    print(json.dumps({
        "metric": f"edge_id_lookup_typed_rmat{SCALE}",
        "build_s": secs["lookup_table_build"], "ms_per_lookup_call": ms,
        "ms_per_lookup_call_runs": runs, "queries": LOOKUP_IDS,
        "queries_per_s": LOOKUP_IDS / (ms * 1e-3), "card": card}),
        flush=True)
    print(json.dumps({"metric": f"multigraph_rmat{MULTI_SCALE}",
                      **{f"{k}_s": v for k, v in multi_secs.items()},
                      "card": card}), flush=True)
    fn = _masked_calls(Gt, out["seeds"])["het_temporal_biased"][0]
    by_name, window = _device_ms_by_name(lambda: fn(0))
    busy = sum(by_name.values())
    prof = cProfile.Profile()
    prof.enable()
    fn(0)
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    print(json.dumps({
        "metric": f"het_temporal_biased_typed_rmat{SCALE}_profile",
        "profiled_ms": window, "device_busy_ms": busy,
        "host_ms": window - busy,
        "device_idle_share": 1 - busy / window if by_name else
        "not measured",
        "device_ms_by_kernel": dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:8]),
        "cprofile_total_ms": total * 1e3,
        "cprofile_own_ms_by_function": {
            f"{os.path.basename(k[0])}:{k[1]}:{k[2]}": v[2] * 1e3
            for k, v in top},
        "card": card}), flush=True)


# -- triangles, k-truss, topological sort, spanning trees, egonets, matching,
# assignment, ForceAtlas2, spectral clustering and bicliques ----------------

TRI_CHECK_TOP = 4         # triangle counts held at the top-degree vertices
TRI_CHECK_RANDOM = 252    # and at as many other vertices with edges
KTRUSS_K = 5
KTRUSS_SCALE = 16         # cut from RMAT-18 for the time limit
KTRUSS_CHECK_SCALE = 14   # the engine's peel against the NumPy peel
EGO_SEEDS = 32            # radius 1, with the top-degree vertex
EGO_RADIUS2_SEEDS = 4
HUNGARIAN_N = 1024        # integer costs in [0, HUNGARIAN_HIGH)
HUNGARIAN_HIGH = 1000
FA2_PM_SCALE = 16         # the particle-mesh path's Graph500 construction
FA2_PM_ITERS = 50
FA2_CLUSTERED_N = 768     # _pm_repulsion against the exact force
# one exact step against float64: the d² = |x_i|² + |x_j|² - 2·x_i·x_j of
# both packages loses ~2^-24·|x|² to cancellation in fp32 at |x| ~ 100,
# which costs the closest pairs' forces (measured on the CPU on
# netscience: 5.8e-4 of the force norm in the port, 3.8e-4 of the
# repulsion norm in the JAX package); the positions, which move by
# ~sqrt(|F|), are held at 1e-4
FA2_FORCE_RTOL = 1e-3
FA2_POS_RTOL = 1e-4
SPECTRAL_CLUSTERS = 5
SCIPY_RTOL = 1e-6         # spanning-tree weights against scipy


def _host_csr(G, drop_loops=False):
    """(offsets int64 [n+1], indices int64) of G's stored edges by source,
    on the host."""
    s, d, _ = G.edgelist_arrays()
    if drop_loops:
        keep = s != d
        s, d = s[keep], d[keep]
    n = G.number_of_vertices()
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=offsets[1:])
    return offsets, d[np.argsort(s, kind="stable")].astype(np.int64)


def _gather_rows(offsets, indices, rows):
    """The neighbour lists of ``rows``, concatenated."""
    starts = offsets[rows]
    lens = offsets[rows + 1] - starts
    base = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return indices[base + np.arange(int(lens.sum()))]


def _sorted_distinct(a):
    """The distinct values of ``a``, ascending, by a sort."""
    a = np.sort(a)
    return a[np.r_[True, a[1:] != a[:-1]]] if len(a) else a


def triangle_paths(Gc):
    """triangle_count and edge_triangle_count on the Graph500 construction
    at RMAT-COMMUNITY_CUT_SCALE and k_truss(KTRUSS_K) on the one at
    RMAT-KTRUSS_SCALE (both cut for the time limit), each run once and
    timed (host clock to a synchronised end); k_truss's peel rounds
    counted as engine calls."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos import _oriented_tri

    out, secs = {}, {}
    _reset_counts()
    out["triangle_count"], secs["triangle_count"] = _timed(
        lambda: ct.triangle_count(Gc))
    out["edge_triangle_count"], secs["edge_triangle_count"] = _timed(
        lambda: ct.edge_triangle_count(Gc))
    rounds = []
    inner = _oriented_tri.oriented_wedge_counts

    def counted(*args, **kw):
        rounds.append(1)
        return inner(*args, **kw)

    a, b, c = RMAT_ABC
    Gk = build_graph500_graph(
        ct.rmat(KTRUSS_SCALE, EDGE_FACTOR << KTRUSS_SCALE, a=a, b=b, c=c,
                seed=SEED), Gc.device, KTRUSS_SCALE)[0]
    with _patched(_oriented_tri, "oriented_wedge_counts", counted):
        out["k_truss"], secs["k_truss"] = _timed(
            lambda: ct.k_truss(Gk, KTRUSS_K))
    out["counts"] = _read_counts()
    out["k_truss_rounds"] = len(rounds)
    tri = int(out["triangle_count"]["counts"].sum()) // 3
    print(f"triangle_count rmat{COMMUNITY_CUT_SCALE}: "
          f"{secs['triangle_count']:.3f} s, "
          f"{tri} triangles; edge_triangle_count: "
          f"{secs['edge_triangle_count']:.3f} s, "
          f"{len(out['edge_triangle_count'])} rows; k_truss("
          f"rmat{KTRUSS_SCALE}, {KTRUSS_K}): {secs['k_truss']:.3f} s, "
          f"{len(rounds)} rounds, {out['k_truss'].number_of_edges()} edges "
          f"of {Gk.number_of_edges()}", flush=True)
    return out, secs


def _triangles_at(offsets, indices, n, verts):
    """tri(v) = ½ Σ over u in N(v) of |N(v) ∩ N(u)|, by NumPy over a
    loop-free CSR."""
    mark = np.zeros(n, bool)
    out = np.empty(len(verts), np.int64)
    for i, v in enumerate(verts):
        nb = indices[offsets[v]:offsets[v + 1]]
        mark[nb] = True
        twice = int(mark[_gather_rows(offsets, indices, nb)].sum())
        mark[nb] = False
        if twice % 2:
            raise AssertionError(f"vertex {v}: odd wedge closure count")
        out[i] = twice // 2
    return out


def _graph_arrays(G):
    s, d, w = G.edgelist_arrays()
    return s, d, w, G.number_map.to_external(
        np.arange(G.number_of_vertices()))


def _same_graph(label, a, b):
    for x, y in zip(_graph_arrays(a), _graph_arrays(b)):
        if (x is None) != (y is None) or (x is not None and (
                x.dtype != y.dtype or not np.array_equal(x, y))):
            raise AssertionError(f"{label}: the graphs differ")


def check_triangles(Gc, out):
    """Triangle counts at the top-degree and at random vertices against
    NumPy neighbour-list intersections, Σ tri = 3·T, the per-edge counts'
    sum against the per-vertex one, the k-truss's own support, and the
    engine's peel against the NumPy engine's at RMAT-KTRUSS_CHECK_SCALE."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos import _oriented_tri

    n = Gc.number_of_vertices()
    counts = out["triangle_count"]["counts"].to_numpy()
    offsets, indices = _host_csr(Gc, drop_loops=True)
    deg = np.diff(offsets)
    top = np.argsort(-deg, kind="stable")[:TRI_CHECK_TOP]
    cand = np.flatnonzero(deg > 0)
    cand = cand[~np.isin(cand, top)]
    verts = np.r_[top, np.random.default_rng(0).choice(
        cand, TRI_CHECK_RANDOM, replace=False)]
    want = _triangles_at(offsets, indices, n, verts)
    if not np.array_equal(counts[verts], want):
        raise AssertionError("triangle_count differs from NumPy's neighbour "
                             f"intersections at {int((counts[verts] != want).sum())} "
                             "vertices")
    total = int(counts.sum())
    per_edge = int(out["edge_triangle_count"]["counts"].sum())
    if total % 3 or per_edge != 2 * total:
        raise AssertionError(f"Σ tri {total} is not 3·T, or the per-edge "
                             f"counts' sum {per_edge} is not twice it")
    kt = out["k_truss"]
    sup = ct.edge_triangle_count(kt)["counts"].to_numpy()
    if kt.number_of_edges() == 0 or sup.min() < KTRUSS_K - 2:
        raise AssertionError(f"k_truss({KTRUSS_K}): an edge with "
                             f"{sup.min() if len(sup) else None} triangles")
    a, b, c = RMAT_ABC
    e14 = ct.rmat(KTRUSS_CHECK_SCALE, EDGE_FACTOR << KTRUSS_CHECK_SCALE,
                  a=a, b=b, c=c, seed=SEED)
    G14 = build_graph500_graph(e14, Gc.device, KTRUSS_CHECK_SCALE)[0]
    got = ct.k_truss(G14, KTRUSS_K)
    with _patched(_oriented_tri, "oriented_wedge_counts",
                  _oriented_tri._oriented_wedge_counts_numpy):
        _same_graph(f"k_truss rmat{KTRUSS_CHECK_SCALE} engine against NumPy",
                    got, ct.k_truss(G14, KTRUSS_K))
    print(f"triangles: {len(verts)} vertices ({TRI_CHECK_TOP} of top degree, "
          f"up to {deg[top].max()}) equal NumPy's intersections, Σ tri = "
          f"3·{total // 3}, per-edge sum = 2·Σ tri; k_truss({KTRUSS_K}): "
          f"{kt.number_of_edges()} edges, each in >= {KTRUSS_K - 2} "
          f"triangles of the truss (min {sup.min()}); the engine's peel "
          f"equals NumPy's at RMAT-{KTRUSS_CHECK_SCALE} "
          f"({got.number_of_edges()} edges)", flush=True)


def dag_graph(edges, device):
    """The PageRank cell's edge list, the edges with src < dst (external
    ids) kept, as a directed graph: a DAG."""
    from cugraph_tpu_torch import Graph

    src = edges["src"].to_numpy()
    dst = edges["dst"].to_numpy()
    keep = src < dst
    Gd = Graph(directed=True, device=device).from_edgelist(src[keep],
                                                          dst[keep])
    g = Gd.structure
    print(f"DAG RMAT-{SCALE}: n={g.num_vertices} m={g.num_edges}, top "
          f"in-degree {int(g.in_degrees().max())}", flush=True)
    return Gd


def topo_path(Gd, G):
    """topological_sort on the DAG (the launch counts set to 0 just before
    and read just after), and on the cyclic directed graph, which must
    raise."""
    import cugraph_tpu_torch as ct

    _reset_counts()
    df, secs = _timed(lambda: ct.topological_sort(Gd))
    counts = _read_counts()
    levels = int(df["level"].max()) + 1
    left = counts["spmv_csr_sum_left"]
    if left < levels:
        raise AssertionError(f"topological_sort: {left} K1 left launches "
                             f"for {levels} levels")
    try:
        ct.topological_sort(G)
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("topological_sort of the cyclic directed "
                             f"RMAT-{SCALE} raised nothing")
    print(f"topological_sort: {secs:.3f} s, {levels} levels, {left} "
          f"spmv_csr_sum_left launches; the cyclic graph raised "
          f"ValueError({raised!r})", flush=True)
    return df, secs, counts


def _kahn_levels_numpy(s, d, n):
    """Kahn's levels in NumPy: each level's out-edges gathered from a CSR."""
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=offsets[1:])
    indices = d[np.argsort(s, kind="stable")].astype(np.int64)
    indeg = np.bincount(d, minlength=n).astype(np.int64)
    level = np.full(n, -1, np.int64)
    front = np.flatnonzero(indeg == 0)
    lvl = 0
    while len(front):
        level[front] = lvl
        nb = _gather_rows(offsets, indices, front)
        np.subtract.at(indeg, nb, 1)
        front = _sorted_distinct(nb[indeg[nb] == 0])
        lvl += 1
    return level


def check_topo(Gd, df):
    n = Gd.number_of_vertices()
    order = _internal(Gd, df["vertex"].to_numpy())
    level = np.empty(n, np.int64)
    level[order] = df["level"].to_numpy()
    s, d, _ = Gd.edgelist_arrays()
    if not (level[s] < level[d]).all():
        raise AssertionError("topological_sort: an edge does not go up")
    want = _kahn_levels_numpy(s, d, n)
    if not np.array_equal(level, want):
        raise AssertionError("topological_sort levels differ from NumPy's "
                             f"Kahn pass at {int((level != want).sum())} "
                             "vertices")
    if not np.array_equal(order, np.lexsort((np.arange(n), level))):
        raise AssertionError("topological_sort: rows not by (level, id)")
    print(f"topological_sort: every edge goes up a level, the levels equal "
          f"NumPy's Kahn pass (1 + the largest in-neighbour's, 0 at the "
          f"{int((want == 0).sum())} sources)", flush=True)


def tree_paths(Gu):
    import cugraph_tpu_torch as ct

    out, secs = {}, {}
    _reset_counts()
    for name, fn in (("minimum_spanning_tree", ct.minimum_spanning_tree),
                     ("maximum_spanning_tree", ct.maximum_spanning_tree)):
        out[name], secs[name] = _timed(lambda: fn(Gu))
        print(f"{name}: {secs[name]:.3f} s, "
              f"{out[name].number_of_edges()} edges", flush=True)
    out["counts"] = _read_counts()
    return out, secs


def check_trees(Gu, out):
    """Each forest has n - #components edges and no cycle, and its weight
    is within SCIPY_RTOL of scipy's float64 spanning forest (the maximum
    one on the negated weights)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    n = Gu.number_of_vertices()
    s, d, w = Gu.edgelist_arrays()
    up = s < d
    A = sp.csr_matrix((w[up].astype(np.float64), (s[up], d[up])),
                      shape=(n, n))
    n_comp = csgraph.connected_components(A, directed=False)[0]
    for name, sign in (("minimum_spanning_tree", 1.0),
                       ("maximum_spanning_tree", -1.0)):
        T = out[name]
        el = T.view_edge_list()
        ts = _internal(Gu, el["src"].to_numpy())
        td = _internal(Gu, el["dst"].to_numpy())
        if T.number_of_vertices() != n or len(el) != n - n_comp:
            raise AssertionError(f"{name}: {len(el)} edges over "
                                 f"{T.number_of_vertices()} vertices, want "
                                 f"{n - n_comp} over {n}")
        t_comp = csgraph.connected_components(sp.csr_matrix(
            (np.ones(len(ts)), (ts, td)), shape=(n, n)), directed=False)[0]
        if t_comp != n_comp:
            raise AssertionError(f"{name}: not a spanning forest "
                                 f"({t_comp} components, want {n_comp})")
        got = float(el["weight"].to_numpy().astype(np.float64).sum())
        want = sign * float(csgraph.minimum_spanning_tree(sign * A).sum())
        if abs(got - want) > SCIPY_RTOL * abs(want):
            raise AssertionError(f"{name}: weight {got!r} against scipy's "
                                 f"{want!r}")
        print(f"{name}: {len(el)} edges = n - {n_comp} components, a "
              f"forest, weight {got:.6f} within {abs(got - want) / abs(want):.2e} "
              "of scipy's", flush=True)


def ego_paths(Gu):
    """batched_ego_graphs at radius 1 from EGO_SEEDS vertices with edges
    (NumPy seed 0) and the top-degree vertex, and at radius 2 from the
    first EGO_RADIUS2_SEEDS of them, each with the launch counts set to 0
    just before and read just after."""
    import cugraph_tpu_torch as ct

    deg = Gu.structure.out_degrees().cpu().numpy()
    hub = Gu.nodes()[int(np.argmax(deg))]
    seeds = np.r_[_seeds_with_out_edges(Gu, EGO_SEEDS, 0), hub]
    runs = {}
    for radius, picked in ((1, seeds), (2, seeds[:EGO_RADIUS2_SEEDS])):
        _reset_counts()
        (df, offs), secs = _timed(
            lambda: ct.batched_ego_graphs(Gu, picked, radius=radius))
        counts = _read_counts()
        runs[radius] = {"seeds": picked, "df": df, "offsets": offs,
                        "secs": secs, "counts": counts}
        print(f"batched_ego_graphs radius {radius}, {len(picked)} seeds: "
              f"{secs:.3f} s, {len(df)} rows, "
              f"{counts['spmv_semiring_max_left_i32']} K2 (max, left) "
              "launches", flush=True)
    return runs


def check_egos(Gu, runs):
    """Each ego's vertex set and induced edges against NumPy expansions of
    the CSR (no np.unique): the frame's rows must be the members' CSR
    rows with both ends in the ego and src <= dst, in (src, dst) order,
    which is the undirected edge list's order, and cover every member."""
    n = Gu.number_of_vertices()
    offsets, indices = _host_csr(Gu)
    deg = np.diff(offsets)
    ext = Gu.number_map.to_external(np.arange(n))
    for radius, run in runs.items():
        df, offs = run["df"], run["offsets"]
        for i, seed in enumerate(run["seeds"]):
            part = df.iloc[offs[i]:offs[i + 1]]
            if not (part["seed"].to_numpy() == seed).all():
                raise AssertionError(f"ego {seed}: rows of another seed")
            mark = np.zeros(n, bool)
            front = _internal(Gu, [seed])
            mark[front] = True
            for _ in range(radius):
                nb = _gather_rows(offsets, indices, front)
                front = _sorted_distinct(nb[~mark[nb]])
                mark[front] = True
            members = np.flatnonzero(mark)
            rows = np.repeat(members, deg[members])
            cols = _gather_rows(offsets, indices, members)
            keep = mark[cols] & (rows <= cols)
            rows, cols = rows[keep], cols[keep]
            if not (np.array_equal(part["src"].to_numpy(), ext[rows])
                    and np.array_equal(part["dst"].to_numpy(), ext[cols])):
                raise AssertionError(f"ego {seed} radius {radius}: induced "
                                     "edges differ from NumPy's")
            covered = np.zeros(n, bool)
            covered[rows] = True
            covered[cols] = True
            if not np.array_equal(covered, mark):
                raise AssertionError(f"ego {seed} radius {radius}: vertex "
                                     "set differs from NumPy's expansion")
        print(f"egonets radius {radius}: {len(run['seeds'])} vertex sets and "
              f"{len(df)} induced edges equal NumPy's CSR expansion",
              flush=True)


def matching_path(Gu):
    import cugraph_tpu_torch as ct

    _reset_counts()
    (df, total), secs = _timed(lambda: ct.approx_weighted_matching(Gu))
    counts = _read_counts()
    print(f"approx_weighted_matching: {secs:.3f} s, "
          f"{int((df['partner'] >= 0).sum()) // 2} pairs, weight "
          f"{total!r}", flush=True)
    return df, total, secs, counts


def _descending_order(w):
    """``np.argsort(-w, kind="stable")`` of float32 weights without NaNs,
    by one int64 sort: a key from each weight's bits (monotone in the
    weight, -0.0 as +0.0) over its position."""
    bits = np.where(w == 0, np.float32(0), w).view(np.int32).astype(np.int64)
    ordered = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = (-ordered << 32) | np.arange(len(w), dtype=np.int64)
    return np.sort(key) & 0xFFFFFFFF


def check_matching(Gu, df, total):
    """A matching (symmetric partners) that the greedy loop in the order
    (weight descending, then edge position) would give: every unmatched
    non-loop edge has an endpoint matched by an earlier edge; the total is
    the float64 sum of the matched weights in that order."""
    n = Gu.number_of_vertices()
    s, d, w = Gu.edgelist_arrays()
    partner = np.full(n, -1, np.int64)
    matched = df["partner"].to_numpy() >= 0
    vid = _internal(Gu, df["vertex"].to_numpy())
    partner[vid[matched]] = _internal(Gu, df["partner"].to_numpy()[matched])
    m = partner >= 0
    if not (partner[partner[m]] == np.flatnonzero(m)).all() or \
            (partner[m] == np.flatnonzero(m)).any():
        raise AssertionError("approx_weighted_matching: partners are not "
                             "a matching")
    rank = np.empty(len(s), np.int64)
    rank[_descending_order(w)] = np.arange(len(s))
    pair = partner[s] == d
    first = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(first, s[pair], rank[pair])
    np.minimum.at(first, d[pair], rank[pair])
    other = ~pair & (s != d)
    blocked = (first[s[other]] < rank[other]) | (first[d[other]] < rank[other])
    if not blocked.all():
        raise AssertionError(f"approx_weighted_matching: {int((~blocked).sum())} "
                             "unmatched edges with no earlier matched edge at "
                             "an endpoint: not the greedy matching")
    chosen = pair & (rank == first[s]) & (rank == first[d])
    order = np.argsort(rank[chosen])
    want = float(np.cumsum(w[chosen][order].astype(np.float64))[-1])
    if int(chosen.sum()) != int(m.sum()) // 2 or total != want:
        raise AssertionError(f"approx_weighted_matching: total {total!r} "
                             f"against the float64 sum {want!r}")
    print(f"approx_weighted_matching: {int(chosen.sum())} pairs, a matching, "
          "the greedy one over all edges, total equal to the float64 sum in "
          "the greedy order", flush=True)


def _eps_final(costs):
    """The auction's last ε: C/2 divided by 4 until ε <= 1e-6·C, with C
    = max |cost| + 1 of the matrix padded with max + 1 (JAX
    ``_auction_solve``)."""
    C = float(np.abs(costs).max()) + 2.0
    eps = C / 2
    while not (eps <= 1e-6 * C or eps <= 1e-9):
        eps /= 4.0
    return eps


def assignment_paths(device):
    """dense_hungarian on an HUNGARIAN_N² integer cost matrix (NumPy seed
    0) and hungarian on a small weighted bipartite graph, against scipy's
    optimum within N·ε_final."""
    from scipy.optimize import linear_sum_assignment

    import cugraph_tpu_torch as ct

    costs = np.random.default_rng(0).integers(0, HUNGARIAN_HIGH,
                                              (HUNGARIAN_N, HUNGARIAN_N))
    _reset_counts()
    (total, cols), secs = _timed(
        lambda: ct.dense_hungarian(costs, device=device))
    counts = _read_counts()
    r, c = linear_sum_assignment(costs)
    opt = float(costs[r, c].sum())
    bound = HUNGARIAN_N * _eps_final(costs)
    if not (np.array_equal(np.sort(cols), np.arange(HUNGARIAN_N))
            and total == float(costs[np.arange(HUNGARIAN_N), cols].sum())
            and opt <= total <= opt + bound):
        raise AssertionError(f"dense_hungarian: total {total} against "
                             f"scipy's {opt} (+ {bound})")
    rng = np.random.default_rng(4)
    workers = np.arange(12)
    s = np.repeat(workers, 6)
    d = 100 + rng.integers(0, 14, len(s))
    w = rng.integers(1, 9, len(s)).astype(np.float32)
    G = ct.Graph(device=device).from_edgelist(s, d, w)
    cost, frame = ct.hungarian(G, workers)
    wsum = {}
    for a, b, x in zip(s, d, w):  # the graph keeps the first of a pair
        wsum.setdefault((a, b), x)
    tasks = np.arange(100, 114)
    big = float(w.max()) * 10 + 1.0
    C = np.array([[wsum.get((a, b), big) for b in tasks] for a in workers])
    r, c = linear_sum_assignment(C)
    small_opt = float(C[r, c].sum())
    if not (small_opt <= cost <= small_opt + len(tasks) * _eps_final(C)) \
            or len(set(frame["assignment"])) != len(workers):
        raise AssertionError(f"hungarian: cost {cost} against scipy's "
                             f"{small_opt}")
    print(f"dense_hungarian {HUNGARIAN_N}x{HUNGARIAN_N}: {secs:.3f} s, total "
          f"{total} within {total - opt} of scipy's optimum {opt} (bound "
          f"N·ε {bound:.3g}); hungarian 12 workers x 14 tasks: {cost} "
          f"against scipy's {small_opt}", flush=True)
    return secs, counts


def _fa2_step_f64(pos, deg, src, dst, w):
    """One default ForceAtlas2 step in float64 NumPy from rest (speed 1,
    previous force 0): the direct pairwise difference for the repulsion.
    Returns (force, new positions)."""
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = (diff ** 2).sum(-1)
    np.fill_diagonal(d2, 1.0)
    f = 2.0 * deg[:, None] * deg[None, :] / d2
    np.fill_diagonal(f, 0.0)
    rep = (f[:, :, None] * diff).sum(1)
    pd_ = pos[src] - pos[dst]
    contrib = -(w / np.maximum(deg[src], 1.0))[:, None] * pd_
    att = np.zeros_like(pos)
    np.add.at(att, src, contrib)
    grav = -deg[:, None] * pos / np.linalg.norm(pos, axis=1)[:, None]
    force = rep + att + grav
    fnorm = np.linalg.norm(force, axis=1)
    swing = (deg * fnorm).sum()
    traction = (deg * 0.5 * fnorm).sum()
    se = min(traction / max(swing, 1e-9), 10.0)
    return force, pos + force * (se / (1.0 + np.sqrt(se * fnorm)))[:, None]


def layout_paths(Gn, device):
    """force_atlas2 on netscience, exact path, the default 500 iterations,
    and on the Graph500 RMAT-FA2_PM_SCALE, particle-mesh path (more than
    _PM_AUTO_V vertices), FA2_PM_ITERS iterations; each run once, timed."""
    import cugraph_tpu_torch as ct

    out, secs = {}, {}
    a, b, c = RMAT_ABC
    e16 = ct.rmat(FA2_PM_SCALE, EDGE_FACTOR << FA2_PM_SCALE, a=a, b=b, c=c,
                  seed=SEED)
    G16 = build_graph500_graph(e16, device, FA2_PM_SCALE)[0]
    _reset_counts()
    out["exact"], secs["exact"] = _timed(lambda: ct.force_atlas2(Gn))
    out["pm"], secs["pm"] = _timed(
        lambda: ct.force_atlas2(G16, max_iter=FA2_PM_ITERS))
    out["counts"] = _read_counts()
    out["G16"] = G16
    print(f"force_atlas2 netscience exact: {secs['exact']:.3f} s, "
          f"{secs['exact'] / 500 * 1e3:.3f} ms per iteration; "
          f"RMAT-{FA2_PM_SCALE} particle-mesh (n={G16.number_of_vertices()}): "
          f"{secs['pm']:.3f} s, {secs['pm'] / FA2_PM_ITERS * 1e3:.3f} ms per "
          "iteration", flush=True)
    return out, secs


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_layout(Gn, out):
    """Finite [n, 2] layouts; one exact step on netscience against a
    float64 NumPy step; the particle-mesh repulsion against the exact one
    on clustered positions at the bound of tests/test_misc_algos.py."""
    import torch

    from cugraph_tpu_torch.algos import layout

    for name, G in (("exact", Gn), ("pm", out["G16"])):
        xy = out[name][["x", "y"]].to_numpy()
        if xy.shape != (G.number_of_vertices(), 2) or \
                not np.isfinite(xy).all():
            raise AssertionError(f"force_atlas2 {name}: bad layout")
    g = Gn.structure
    n = g.num_vertices
    pos = np.random.default_rng(42).uniform(-100, 100, (n, 2)).astype(
        np.float32)
    deg = (g.csr.degrees() + 1).to(torch.float32)
    state = layout._fa2_steps(
        torch.as_tensor(pos, device=g.device),
        torch.zeros((n, 2), device=g.device), torch.tensor(1.0,
                                                           device=g.device),
        deg, layout._Attraction(g, 1.0, False), 1, jitter_tolerance=1.0,
        scaling_ratio=2.0, gravity=1.0, outbound=True, lin_log_mode=False,
        strong_gravity_mode=False, pm_grid_dim=0)
    f64, p64 = _fa2_step_f64(
        pos.astype(np.float64), deg.cpu().numpy().astype(np.float64),
        g.csr.row_ids().cpu().numpy(), g.csr.indices.cpu().numpy(),
        g.csr.weights.cpu().numpy().astype(np.float64))
    f_err = _rel(state[1].cpu().numpy(), f64)
    p_err = _rel(state[0].cpu().numpy(), p64)
    if f_err > FA2_FORCE_RTOL or p_err > FA2_POS_RTOL:
        raise AssertionError(f"force_atlas2 step: force {f_err:.3e} "
                             f"(> {FA2_FORCE_RTOL}?), positions {p_err:.3e} "
                             f"(> {FA2_POS_RTOL}?) from float64")
    rng = np.random.default_rng(7)
    centers = rng.uniform(-100, 100, (8, 2))
    cl = (centers[rng.integers(0, 8, FA2_CLUSTERED_N)]
          + rng.normal(0, 5.0, (FA2_CLUSTERED_N, 2))).astype(np.float32)
    m = rng.integers(1, 20, FA2_CLUSTERED_N).astype(np.float32)
    p, mt = (torch.as_tensor(a, device=g.device) for a in (cl, m))
    exact = layout._exact_repulsion(p, mt, 2.0).cpu().numpy()
    pm = layout._pm_repulsion(p, mt, 64, 2.0).cpu().numpy()
    num = np.linalg.norm(pm - exact, axis=1)
    den = np.linalg.norm(exact, axis=1) + 1e-6
    med, tot = float(np.median(num / den)), float(num.sum() / den.sum())
    if not (med < 0.02 and tot < 0.03):
        raise AssertionError(f"_pm_repulsion: median {med:.3e}, weighted "
                             f"{tot:.3e} from the exact force")
    print(f"force_atlas2: finite layouts; one exact step from float64: "
          f"force {f_err:.3e} (<= {FA2_FORCE_RTOL}), positions {p_err:.3e} "
          f"(<= {FA2_POS_RTOL}); _pm_repulsion from exact on "
          f"{FA2_CLUSTERED_N} clustered points: median {med:.3e} (< 0.02), "
          f"weighted {tot:.3e} (< 0.03)", flush=True)


def _planted_bicliques():
    """Noise on features 1010..1049 plus a planted biclique: machines
    0..14 all carry features 1000..1005, which no other machine carries."""
    import pandas as pd

    rng = np.random.default_rng(1)
    src = rng.integers(0, 60, 400)
    dst = 1010 + rng.integers(0, 40, 400)
    ps, pf = np.meshgrid(np.arange(15), 1000 + np.arange(6))
    src = np.r_[src, ps.ravel()]
    dst = np.r_[dst, pf.ravel()]
    return pd.DataFrame({"src": src, "dst": dst,
                         "flag": (src % 7 == 0).astype(np.int64)})


def spectral_biclique_paths(Gn):
    """The two spectral clusterings of netscience (SPECTRAL_CLUSTERS
    clusters) and find_bicliques on a planted frame; each timed."""
    import cugraph_tpu_torch as ct

    secs = {}
    n = Gn.number_of_vertices()
    for name in ("spectralBalancedCutClustering",
                 "spectralModularityMaximizationClustering"):
        df, secs[name] = _timed(
            lambda: getattr(ct, name)(Gn, SPECTRAL_CLUSTERS))
        lab = df["cluster"].to_numpy()
        if not (len(df) == n and lab.min() >= 0
                and lab.max() < SPECTRAL_CLUSTERS
                and np.array_equal(_internal(Gn, df["vertex"].to_numpy()),
                                   np.arange(n))):
            raise AssertionError(f"{name}: labels outside 0..k-1 or "
                                 "vertices missing")
        print(f"{name} netscience: {secs[name]:.3f} s, cluster sizes "
              f"{np.bincount(lab).tolist()}", flush=True)
    (B, S), secs["find_bicliques"] = _timed(
        lambda: ct.experimental.find_bicliques(_planted_bicliques(), k=1))
    machines = set(B[B["type"] == 0]["vert"])
    feats = set(B[B["type"] == 1]["vert"])
    if len(S) != 1 or not (set(range(15)) <= machines
                           and set(range(1000, 1006)) <= feats):
        raise AssertionError("find_bicliques missed the planted biclique")
    print(f"find_bicliques: {secs['find_bicliques']:.3f} s, found the planted "
          f"15 x 6 biclique ({len(machines)} x {len(feats)})", flush=True)
    return secs


# -- phase 12 of the docstring: the Graph and API long tail -------------------

LT_GNM = (1 << 19, 1 << 23, 42)   # erdos_renyi_gnm(n, m, seed); cut
#   from (2^20, 2^24) for the time limit
LT_MESH = (128, 128, 128)         # mesh_3d_graph: 381 BFS levels
LT_BIPARTITE = (19, 17, 1 << 23)  # bipartite_rmat(scale_src, scale_dst, m);
#   cut from (20, 18, 2^24) for the time limit
LT_PR_ITERS = 20                  # pagerank(max_iter=20, tol=0)
LT_DENSE_SCALE = 14               # the dense converters' RMAT: n <= 16,384
LT_DENSE_SEED = 3
LT_FRAME_ROWS = 1 << 20           # unrenumber / add_internal_vertex_id
LT_NN_LOSS_RTOL = 1e-5            # the functional step against the module's
LT_NN_WEIGHT_ATOL = 1e-4


def _lt_timed(label, secs, fn):
    """``fn()`` on the host clock to a synchronised end; prints and keeps
    its seconds under ``label``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[label] = time.perf_counter() - t0
    print(f"long tail: {label} {secs[label]:.3f} s", flush=True)
    return out


def _lt_need(counts, key, label, exact=None):
    got = counts.get(key, 0)
    if got == 0 or (exact is not None and got != exact):
        raise AssertionError(f"{label} launched {key} {got} times"
                             + (f", expected {exact}" if exact else ""))


def _lt_distances(label, df, want, int_dist):
    """A bfs (int) or sssp (float) frame's distances against ``want``
    (float64, inf where unreached, in the frame's vertex order), exactly."""
    dist = df["distance"].to_numpy()
    reached = np.isfinite(want)
    unreached = (np.iinfo(np.int32).max if int_dist
                 else np.float64(np.finfo(np.float32).max))
    expect = np.where(reached, want, unreached)
    if not np.array_equal(dist.astype(np.float64), expect):
        raise AssertionError(f"{label}: {int((dist != expect).sum())} "
                             "distances differ from the reference")


def longtail_gnm(device, secs):
    """erdos_renyi_gnm into an undirected Graph through
    from_pandas_edgelist; shortest_path and bfs_edges from one vertex
    against scipy's unit-weight dijkstra and the Graph500 validators;
    has_isolated_vertices, number_of_nodes, to_directed, unrenumber and
    add_internal_vertex_id against NumPy.  Returns the launch counts of
    the two traversals, each set to 0 just before and read just after."""
    import pandas as pd
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.generators.simple import erdos_renyi_gnm
    from cugraph_tpu_torch.testing import graph500

    n_req, m_req, seed = LT_GNM
    df = _lt_timed("erdos_renyi_gnm", secs,
                   lambda: erdos_renyi_gnm(n_req, m_req, seed=seed))
    lo, hi = df["src"].to_numpy(), df["dst"].to_numpy()
    if len(df) != m_req or not np.all(lo < hi):
        raise AssertionError("erdos_renyi_gnm: not m pairs with i < j")
    G = _lt_timed("from_pandas_edgelist G(n, m)", secs,
                  lambda: ct.from_pandas_edgelist(
                      df, "src", "dst",
                      create_using=ct.Graph(device=device)))
    n = G.number_of_vertices()
    source = int(lo[0])
    _reset_counts()
    sp_df = _lt_timed("shortest_path G(n, m)", secs,
                      lambda: ct.shortest_path(G, source))
    c_sp = _read_counts()
    _reset_counts()
    bfs_df = _lt_timed("bfs_edges G(n, m)", secs,
                       lambda: ct.bfs_edges(G, source))
    c_bfs = _read_counts()
    print(f"G(n, m) {n_req}, {m_req}, seed {seed}: n={n} stored "
          f"m={G.structure.num_edges}; launches shortest_path "
          f"{ {k: v for k, v in c_sp.items() if v} }, bfs_edges "
          f"{ {k: v for k, v in c_bfs.items() if v} }", flush=True)
    _lt_need(c_sp, "spmv_semiring_min_add", "shortest_path")
    _lt_need(c_sp, "spmv_select_eqsel_rel", "shortest_path predecessors", 1)
    _lt_need(c_bfs, "spmv_semiring_max_left_i32", "bfs_edges (dense levels)")
    _lt_need(c_bfs, "spmv_select_eqsel_rel_unit", "bfs_edges predecessors",
             1)

    t0 = time.perf_counter()
    verts = sp_df["vertex"].to_numpy()
    if not np.array_equal(bfs_df["vertex"].to_numpy(), verts):
        raise AssertionError("bfs_edges: another vertex order")
    s, d, _ = G.edgelist_arrays()
    A = sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    ref = csgraph.dijkstra(A, indices=int(_internal(G, [source])[0]),
                           unweighted=True)[_internal(G, verts)]
    del A
    _lt_distances("shortest_path", sp_df, ref, False)
    _lt_distances("bfs_edges", bfs_df, ref, True)
    t1 = time.perf_counter()
    edges = graph500._bfs_edges(lo, hi, n, vertices=verts)
    t2 = time.perf_counter()
    graph500._check_bfs(edges, source, bfs_df["distance"].to_numpy(),
                        bfs_df["predecessor"].to_numpy())
    # on unit weights a shortest-path tree is a BFS tree: the same rules
    # over the same sorted keys
    sp_hops = sp_df["distance"].to_numpy()
    sp_hops = np.where(sp_hops < np.finfo(np.float32).max, sp_hops,
                       np.iinfo(np.int32).max).astype(np.int64)
    graph500._check_bfs(edges, source, sp_hops,
                        sp_df["predecessor"].to_numpy())
    del edges
    t3 = time.perf_counter()
    print(f"G(n, m): shortest_path and bfs_edges from {source} equal "
          f"scipy's unit-weight dijkstra ({int(np.isfinite(ref).sum())} "
          "reached), both trees pass the Graph500 BFS validator "
          f"({t3 - t0:.1f} s: scipy {t1 - t0:.1f}, the validator's keys "
          f"{t2 - t1:.1f}, two trees {t3 - t2:.1f})", flush=True)

    present = np.unique(np.concatenate([lo, hi]))
    iso = _lt_timed("has_isolated_vertices G(n, m)", secs,
                    G.has_isolated_vertices)
    if iso or G.number_of_nodes() != len(present) \
            or G.number_of_nodes() != G.number_of_vertices():
        raise AssertionError(f"has_isolated_vertices {iso}, number_of_nodes "
                             f"{G.number_of_nodes()}, {len(present)} "
                             "vertices with edges")
    Gd = _lt_timed("to_directed G(n, m)", secs, G.to_directed)
    if not (Gd.is_directed() and Gd.device == G.device
            and Gd.number_of_edges() == 2 * m_req
            and Gd.number_of_vertices() == n):
        raise AssertionError(f"to_directed: {Gd.number_of_edges()} edges, "
                             f"expected {2 * m_req}")
    del Gd
    ext = G.nodes()
    if not np.array_equal(np.sort(ext), present):
        raise AssertionError("nodes() is not the set of edge endpoints")
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n, LT_FRAME_ROWS)
    frame = pd.DataFrame({"v": ids, "tag": np.arange(LT_FRAME_ROWS)})
    un = _lt_timed(f"unrenumber {LT_FRAME_ROWS} rows", secs,
                   lambda: G.unrenumber(frame, "v"))
    want = np.where(ids >= 0, ext[np.maximum(ids, 0)], ids)
    if not (np.array_equal(un["v"].to_numpy(), want)
            and np.array_equal(un["tag"].to_numpy(), frame["tag"])):
        raise AssertionError("unrenumber differs from NumPy's")
    q = ext[rng.integers(0, n, LT_FRAME_ROWS)]
    added = _lt_timed(f"add_internal_vertex_id {LT_FRAME_ROWS} rows", secs,
                      lambda: G.add_internal_vertex_id(
                          pd.DataFrame({"ext": q}), "id", "ext"))
    if list(added.columns) != ["id"] \
            or not np.array_equal(ext[added["id"].to_numpy()], q):
        raise AssertionError("add_internal_vertex_id differs from NumPy's")
    print("G(n, m): no isolated vertex, number_of_nodes = the endpoints, "
          f"to_directed {2 * m_req} edges, unrenumber and "
          f"add_internal_vertex_id exact on {LT_FRAME_ROWS} rows",
          flush=True)
    return {"shortest_path G(n, m)": c_sp, "bfs_edges G(n, m)": c_bfs}


def longtail_mesh(device, secs):
    """mesh_3d_graph through from_adjlist from a NumPy CSR of its frame,
    then bfs_edges from vertex 0: every distance i + j + k, the tree
    valid.  Returns the bfs launch counts."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos import traversal
    from cugraph_tpu_torch.generators.simple import mesh_3d_graph
    from cugraph_tpu_torch.testing import graph500

    x, y, z = LT_MESH
    df = _lt_timed("mesh_3d_graph", secs, lambda: mesh_3d_graph(x, y, z))
    src, dst = df["src"].to_numpy(), df["dst"].to_numpy()
    n = x * y * z
    order = np.argsort(src, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(src,
                                                         minlength=n))])
    G = _lt_timed("from_adjlist mesh", secs, lambda: ct.from_adjlist(
        offsets, dst[order], create_using=ct.Graph(device=device)))
    if G.number_of_vertices() != n or G.number_of_edges() != len(df):
        raise AssertionError(f"mesh: {G.number_of_vertices()} vertices, "
                             f"{G.number_of_edges()} edges")
    _reset_counts()
    df_b = _lt_timed("bfs_edges mesh", secs, lambda: ct.bfs_edges(G, 0))
    counts = _read_counts()
    run = dict(traversal.LAST_RUN)
    _lt_need(counts, "spmv_select_eqsel_rel_unit", "bfs_edges predecessors",
             1)
    v = df_b["vertex"].to_numpy().astype(np.int64)
    i, j, k = v // (y * z), (v // z) % y, v % z
    dist = df_b["distance"].to_numpy().astype(np.int64)
    if not np.array_equal(dist, i + j + k):
        raise AssertionError("mesh bfs: a distance is not i + j + k")
    levels = int(dist.max())
    graph500._check_bfs(graph500._bfs_edges(src, dst, n, vertices=v), 0,
                        dist, df_b["predecessor"].to_numpy())
    print(f"mesh {x}x{y}x{z}: n={n} m={len(df)}; bfs_edges from 0: every "
          f"distance i + j + k, {levels} levels, Graph500 tree valid; "
          f"run {run}; launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    return {"bfs_edges mesh": counts}


def longtail_bipartite(device, secs):
    """bipartite_rmat into a BiPartiteGraph with both partitions
    registered; is_bipartite, sets, every edge across; pagerank(max_iter=20,
    tol=0) against float64 scipy.  Returns its launch counts."""
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.generators.simple import bipartite_rmat

    s_src, s_dst, m = LT_BIPARTITE
    df = _lt_timed("bipartite_rmat", secs,
                   lambda: bipartite_rmat(s_src, s_dst, m))
    top = np.arange(1 << s_src)
    bottom = (1 << s_src) + np.arange(1 << s_dst)

    def build():
        B = ct.BiPartiteGraph(device=device)
        B.add_nodes_from(top, bipartite="top")
        B.add_nodes_from(bottom, bipartite="bottom")
        return B.from_edgelist(df["src"].to_numpy(), df["dst"].to_numpy())

    B = _lt_timed("BiPartiteGraph", secs, build)
    t_sets, b_sets = B.sets()
    if not (B.is_bipartite() and ct.is_bipartite(B)
            and ct.is_multipartite(B) and np.array_equal(t_sets, top)
            and np.array_equal(b_sets, bottom)
            and B.number_of_vertices() == len(top) + len(bottom)):
        raise AssertionError("BiPartiteGraph: partitions or predicates")
    s, d, _ = B.edgelist_arrays()
    ext = B.nodes()
    if not np.array_equal((ext[s] < (1 << s_src)), ext[d] >= (1 << s_src)):
        raise AssertionError("bipartite_rmat: an edge within a partition")
    _reset_counts()
    pr, _ = _lt_timed("pagerank BiPartiteGraph", secs,
                      lambda: ct.pagerank(B, max_iter=LT_PR_ITERS, tol=0.0,
                                          fail_on_nonconvergence=False))
    counts = _read_counts()
    if counts["spmv_csr_sum_mul"] != LT_PR_ITERS:
        raise AssertionError(f"pagerank: {counts} launches, expected "
                             f"{LT_PR_ITERS} mul")
    p_ref, _ = pagerank_reference(reference_matrix(B), LT_PR_ITERS, 0.0)
    _hold(f"BiPartiteGraph RMAT {s_src}/{s_dst} pagerank({LT_PR_ITERS} "
          "iterations, tol 0)", _by_internal_id(B, pr, "pagerank"), p_ref)
    print(f"BiPartiteGraph: n={B.number_of_vertices()} stored "
          f"m={len(s)}, is_bipartite, sets as registered, every edge "
          f"across; isolated vertices {B.has_isolated_vertices()}",
          flush=True)
    del B
    torch.cuda.empty_cache()
    return {"pagerank BiPartiteGraph": counts}


def _last_write_numpy(src, dst, w, nodelist, directed):
    """The JAX package's to_numpy_array loop in NumPy: write k of the
    loop (A[s, d], then A[d, s] when undirected) lands at position k; a
    stable sort of the cells keeps each cell's last write."""
    by_id = np.argsort(nodelist, kind="stable")
    r = by_id[np.searchsorted(nodelist[by_id], src)]
    c = by_id[np.searchsorted(nodelist[by_id], dst)]
    n = len(nodelist)
    cells = r * n + c if directed else np.stack(
        [r * n + c, c * n + r], 1).ravel()
    vals = w if directed else np.repeat(w, 2)
    order = np.argsort(cells, kind="stable")
    cs = cells[order]
    last = np.ones(len(cs), bool)
    last[:-1] = cs[1:] != cs[:-1]
    A = np.zeros(n * n, np.float32)
    A[cs[last]] = vals[order][last]
    return A.reshape(n, n)


def _edge_set(G, labels=None):
    """An undirected graph's edges as sorted (lo, hi) external-id pairs
    and their weights; ``labels`` maps the ids first."""
    el = G.view_edge_list()
    s, d = el["src"].to_numpy(), el["dst"].to_numpy()
    if labels is not None:
        s, d = labels[s], labels[d]
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    order = np.lexsort((hi, lo))
    return lo[order], hi[order], el["weight"].to_numpy()[order]


def longtail_dense(device, secs):
    """to_numpy_array, from_numpy_array, to_pandas_adjacency and
    from_pandas_adjacency on an undirected weighted RMAT-14 graph."""
    import cugraph_tpu_torch as ct

    edges = ct.rmat(LT_DENSE_SCALE, EDGE_FACTOR << LT_DENSE_SCALE,
                    seed=LT_DENSE_SEED, include_edge_weights=True)
    G = ct.Graph(device=device).from_edgelist(
        edges["src"].to_numpy(), edges["dst"].to_numpy(),
        edges["weights"].to_numpy())
    tag = f"RMAT-{LT_DENSE_SCALE}"
    A = _lt_timed(f"to_numpy_array {tag}", secs,
                  lambda: ct.to_numpy_array(G))
    el = G.view_edge_list()
    nodes = np.unique(np.concatenate([el["src"], el["dst"]]))
    want = _last_write_numpy(el["src"].to_numpy(), el["dst"].to_numpy(),
                             el["weight"].to_numpy(), nodes, False)
    if A.dtype != np.float32 or not np.array_equal(A.view(np.uint32),
                                                   want.view(np.uint32)):
        raise AssertionError("to_numpy_array differs from the NumPy "
                             "last-write pass")
    ref = _edge_set(G)
    G2 = _lt_timed(f"from_numpy_array {tag}", secs, lambda: (
        ct.from_numpy_array(A, create_using=ct.Graph(device=device))))
    # without labels the vertices are the matrix positions
    got = _edge_set(G2, nodes)
    pdf = _lt_timed(f"to_pandas_adjacency {tag}", secs,
                    lambda: ct.to_pandas_adjacency(G))
    G3 = _lt_timed(f"from_pandas_adjacency {tag}", secs, lambda: (
        ct.from_pandas_adjacency(pdf, create_using=ct.Graph(device=device))))
    for label, (s, d, w) in (("from_numpy_array", got),
                             ("from_pandas_adjacency", _edge_set(G3))):
        if not (np.array_equal(s, ref[0]) and np.array_equal(d, ref[1])
                and np.array_equal(w.view(np.uint32),
                                   ref[2].view(np.uint32))):
            raise AssertionError(f"{label}: another edge set or weights")
    print(f"dense converters RMAT-{LT_DENSE_SCALE}: n={len(nodes)} "
          f"({A.nbytes / 2**20:.0f} MiB), {len(ref[0])} undirected edges; "
          "to_numpy_array bit for bit the last-write pass; from_numpy_array "
          "and from_pandas_adjacency give back the edges and float32 "
          "weights", flush=True)


def longtail_nn(G, x, labels, mask, secs):
    """graphsage_apply at (128, 256, 40) against the GraphSAGE module on
    the same weights, bit for bit; one functional train step against the
    module's.  Returns the K4 launch counts of the two forwards and
    steps."""
    import torch

    from cugraph_tpu_torch import nn as tnn

    g = G.structure
    params = tnn.graphsage_init(torch.Generator().manual_seed(GNN_SEED + 1),
                                GNN_IN, GNN_HIDDEN, GNN_CLASSES,
                                device=G.device)
    model = tnn.GraphSAGE(GNN_IN, GNN_HIDDEN, GNN_CLASSES, device=G.device)
    model.load_state_dict(tnn.state_dict_from_jax(
        model, [{k: v.cpu().numpy() for k, v in p.items()} for p in params]))
    _reset_spmm_counts()
    with torch.no_grad():
        y_fn = _lt_timed("graphsage_apply", secs,
                         lambda: tnn.graphsage_apply(params, g, x))
        y_mod = model(g, x)
    if not torch.equal(y_fn.view(torch.int32), y_mod.view(torch.int32)):
        raise AssertionError("graphsage_apply differs from the GraphSAGE "
                             "module on the same weights")
    step_f = tnn.make_train_step(
        tnn.graphsage_apply, lambda ps: torch.optim.Adam(ps, lr=GNN_LR))
    step_m = tnn.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                         lr=GNN_LR))
    p1, _, loss_f = _lt_timed("graphsage functional train step", secs,
                              lambda: step_f(params, None, g, x, labels,
                                             mask))
    loss_m = step_m(g, x, labels, mask)
    counts = _read_spmm_counts()
    rel = abs(float(loss_f) - float(loss_m)) / abs(float(loss_m))
    moved = tnn.jax_params_from_state_dict(model)
    worst = max(float(np.abs(p1[i][k].detach().cpu().numpy()
                             - moved[i][k]).max())
                for i in range(len(p1)) for k in p1[i])
    if rel > LT_NN_LOSS_RTOL or worst > LT_NN_WEIGHT_ATOL:
        raise AssertionError(f"functional step: loss rel {rel:.3e}, weights "
                             f"{worst:.3e} from the module step")
    _lt_need(counts, "spmm_csr_sum_weighted", "graphsage_apply and steps",
             8)
    _lt_need(counts, "spmm_csr_sum_weighted_vjp", "the two steps", 2)
    print(f"graphsage_apply {GNN_IN}-{GNN_HIDDEN}-{GNN_CLASSES}: equal to "
          "the module bit for bit; functional step loss "
          f"{float(loss_f):.6f} (rel {rel:.2e} from the module's), weights "
          f"within {worst:.2e}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return {"graphsage_apply and functional step": counts}


def longtail_datasets(device, secs):
    """Every bundled and generated dataset: get_graph() on the card and
    weakly_connected_components against scipy.  Returns the WCC launch
    counts."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from cugraph_tpu_torch import datasets, weakly_connected_components

    t0 = time.perf_counter()
    _reset_counts()
    sizes = {}
    for ds in datasets.get_all_datasets():
        G = ds.get_graph()
        if G.device.type != device.type:
            raise AssertionError(f"{ds.name}: built on {G.device}")
        labels = weakly_connected_components(G)
        n = G.number_of_vertices()
        s, d, _ = G.edgelist_arrays()
        k, comp = csgraph.connected_components(
            sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n)),
            directed=True, connection="weak")
        minid = np.full(k, n, np.int64)
        np.minimum.at(minid, comp, np.arange(n))
        got = _internal(G, labels["labels"].to_numpy())
        if not np.array_equal(got, minid[comp]):
            raise AssertionError(f"{ds.name}: wcc differs from scipy's")
        sizes[ds.name] = (n, G.number_of_edges(), k)
    counts = _read_counts()
    secs["datasets get_graph + wcc"] = time.perf_counter() - t0
    _lt_need(counts, "spmv_semiring_min_left_i32", "the datasets' wcc")
    print(f"datasets: {len(sizes)} graphs on {device}, wcc = scipy's "
          f"(n, m, components): {sizes}; "
          f"{secs['datasets get_graph + wcc']:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return {"datasets wcc": counts}


def longtail_paths(G, x, labels, mask, device):
    """Phase 12's paths and checks; returns (launch counts by path,
    seconds by call)."""
    secs, counts = {}, {}
    counts.update(longtail_gnm(device, secs))
    counts.update(longtail_mesh(device, secs))
    counts.update(longtail_bipartite(device, secs))
    longtail_dense(device, secs)
    counts.update(longtail_nn(G, x, labels, mask, secs))
    counts.update(longtail_datasets(device, secs))
    return counts, secs


# -- phase 13: the plc layer --------------------------------------------------

PLC_SEED = 14                 # the random states, the sources and the seeds
PLC_PPR_VERTICES = 64
PLC_MSBFS_SOURCES = 32
PLC_BC_K = 32
PLC_SAMPLE_SEEDS = 4096
PLC_LABELS = 4
PLC_FANOUT = [10, 10]
PLC_WALKS = (4096, 16)        # walkers, depth
PLC_KTRUSS_K = 5


def _plc_call(label, counts, secs, fn):
    """One plc wrapper on the card: the launch counts set to 0 just before
    and read just after, its seconds on the host clock to a synchronised
    end; prints both."""
    import torch

    torch.cuda.synchronize()
    _reset_spmm_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[label] = time.perf_counter() - t0
    counts[label] = _read_spmm_counts()
    print(f"plc: {label} {secs[label] * 1e3:.1f} ms; launches "
          f"{ {k: v for k, v in counts[label].items() if v} }", flush=True)
    return out


def _plc_same(label, got, want):
    """The wrapper's arrays against the top-level call's: the same dtype,
    shape and bits."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"plc {label}: {len(got)} arrays, expected "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"):
            raise AssertionError(f"plc {label}: array {i} ({a.dtype} "
                                 f"{a.shape}) differs from the top-level "
                                 f"call's ({b.dtype} {b.shape})")


def _by_vertex(df, cols):
    df = df.sort_values("vertex")
    return tuple(df[c].to_numpy() for c in ["vertex", *cols])


def _compress_numpy(df, seeds, labels, num_labels):
    """The CSR output of a renumbered sample, re-derived from its plain
    frame with dicts and NumPy: per label, each vertex numbered at its
    first appearance in (the label's seeds, then for each hop its sources
    and then its destinations); a row per number up to the largest source
    or seed; the edges in (source, destination, hop) order."""
    offsets, lho, rmap, rmap_offs, minors = [], [0], [], [0], []
    for lab in range(num_labels):
        rows = df[df["batch_id"].to_numpy() == lab]
        src = rows["sources"].to_numpy()
        dst = rows["destinations"].to_numpy()
        hop = rows["hop_id"].to_numpy()
        ids = {}
        for v in seeds[labels == lab].tolist():
            ids.setdefault(v, len(ids))
        for h in range(int(hop.max(initial=-1)) + 1):
            for v in src[hop == h].tolist():
                ids.setdefault(v, len(ids))
            for v in dst[hop == h].tolist():
                ids.setdefault(v, len(ids))
        maj = np.array([ids[v] for v in src.tolist()], np.int64)
        mnr = np.array([ids[v] for v in dst.tolist()], np.int64)
        n_rows = max(int(maj.max(initial=-1)),
                     max(ids[v] for v in seeds[labels == lab].tolist())) + 1
        off = np.zeros(n_rows + 1, np.int64)
        off[1:] = np.cumsum(np.bincount(maj, minlength=n_rows))
        offsets.append(off)
        lho.append(lho[-1] + len(off))
        rmap.append(np.array(list(ids), np.int64))
        rmap_offs.append(rmap_offs[-1] + len(ids))
        minors.append(mnr[np.lexsort((hop, mnr, maj))])
    return {"major_offsets": np.concatenate(offsets),
            "label_hop_offsets": np.array(lho),
            "renumber_map": np.concatenate(rmap),
            "renumber_map_offsets": np.array(rmap_offs),
            "minors": np.concatenate(minors)}


def plc_rmat(G, edges, counts, secs):
    """The plc wrappers on an SGGraph of the PageRank cell's COO, each
    against the top-level call on G (the same arrays) bit for bit, the
    adapter's own logic against NumPy."""
    import pandas as pd
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch import plc

    h = plc.ResourceHandle()
    if h.device != G.device:
        raise AssertionError(f"ResourceHandle() is on {h.device}, the "
                             f"graphs on {G.device}")
    src, dst = edges["src"].to_numpy(), edges["dst"].to_numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg = plc.SGGraph(h, plc.GraphProperties(), src, dst, None)
    S = sg.graph()
    S.structure  # the CSR/CSC build on the card, timed with the graph
    torch.cuda.synchronize()
    secs["SGGraph build"] = time.perf_counter() - t0
    s0, d0, _ = G.edgelist_arrays()
    s1, d1, w1 = S.edgelist_arrays()
    if not (S.device == G.device and S.is_directed() and w1 is None
            and np.array_equal(s1, s0) and np.array_equal(d1, d0)
            and np.array_equal(S.nodes(), G.nodes())):
        raise AssertionError("SGGraph: another graph than Graph("
                             "directed=True).from_edgelist of the same COO")
    n = S.number_of_vertices()
    print(f"plc: SGGraph of RMAT-{SCALE} ({len(src)} COO rows): n={n} "
          f"m={sg.number_of_edges()} on {S.device}, the same edges and "
          f"vertex map as G; {secs['SGGraph build']:.2f} s", flush=True)

    got = _plc_call("pagerank", counts, secs, lambda: plc.pagerank(h, sg))
    _plc_same("pagerank", got, _by_vertex(ct.pagerank(G), ["pagerank"]))
    rng = np.random.default_rng(PLC_SEED)
    pv = rng.choice(G.nodes(), PLC_PPR_VERTICES, replace=False)
    pw = rng.uniform(0.5, 1.5, PLC_PPR_VERTICES)
    pw /= pw.sum()
    got = _plc_call("personalized_pagerank", counts, secs,
                    lambda: plc.personalized_pagerank(h, sg, pv, pw,
                                                      max_iterations=200))
    _plc_same("personalized_pagerank", got, _by_vertex(ct.pagerank(
        G, personalization=pd.DataFrame({"vertex": pv, "values": pw}),
        max_iter=200), ["pagerank"]))
    got = _plc_call("hits", counts, secs,
                    lambda: plc.hits(h, sg, 0.0, HITS_ITERS))
    _plc_same("hits", got, _by_vertex(ct.hits(G, max_iter=HITS_ITERS,
                                              tol=0.0),
                                      ["hubs", "authorities"]))

    out_deg = np.bincount(s0, minlength=n)
    hub = int(G.nodes()[int(np.argmax(out_deg))])
    bfs1 = _plc_call("bfs 1 source", counts, secs,
                     lambda: plc.bfs(h, sg, np.array([hub])))
    want = ct.bfs(G, hub).sort_values("vertex")
    _plc_same("bfs 1 source", bfs1, (want["distance"].to_numpy(),
                                     want["predecessor"].to_numpy(),
                                     want["vertex"].to_numpy()))
    sources = _seeds_with_out_edges(G, PLC_MSBFS_SOURCES, PLC_SEED)
    got = _plc_call(f"bfs {PLC_MSBFS_SOURCES} sources", counts, secs,
                    lambda: plc.bfs(h, sg, sources))
    ms = ct.multi_source_bfs(G, sources).sort_values("vertex")
    D = ms[[f"distance_{s}" for s in sources]].to_numpy()
    P = ms[[f"predecessor_{s}" for s in sources]].to_numpy()
    best = np.argmin(D, axis=1)
    rows = np.arange(len(ms))
    _plc_same(f"bfs {PLC_MSBFS_SOURCES} sources", got,
              (D.min(axis=1), P[rows, best], ms["vertex"].to_numpy()))
    got = _plc_call("sssp", counts, secs, lambda: plc.sssp(h, sg, hub))
    want = ct.sssp(G, hub).sort_values("vertex")
    _plc_same("sssp", got, (want["vertex"].to_numpy(),
                            want["distance"].to_numpy(),
                            want["predecessor"].to_numpy()))
    reached = bfs1[0] < np.iinfo(np.int32).max
    unit = np.where(reached, bfs1[0].astype(np.float64),
                    np.float64(np.finfo(np.float32).max))
    if not np.array_equal(got[1], unit):
        raise AssertionError("plc sssp: unit-weight distances differ from "
                             "bfs's")
    got = _plc_call("weakly_connected_components", counts, secs,
                    lambda: plc.weakly_connected_components(h, sg))
    _plc_same("weakly_connected_components", got,
              _by_vertex(ct.weakly_connected_components(G), ["labels"]))
    state = plc.CuGraphRandomState(h, PLC_SEED)
    got = _plc_call(f"betweenness_centrality k={PLC_BC_K}", counts, secs,
                    lambda: plc.betweenness_centrality(h, sg, PLC_BC_K,
                                                       state))
    bc_seed = (PLC_SEED * 1_000_003 + 1) % 2**31   # the state's first seed
    _plc_same("betweenness_centrality", got, _by_vertex(
        ct.betweenness_centrality(G, k=PLC_BC_K, seed=bc_seed),
        ["betweenness_centrality"]))

    seeds = _seeds_with_out_edges(G, PLC_SAMPLE_SEEDS, PLC_SEED + 1)
    per = PLC_SAMPLE_SEEDS // PLC_LABELS
    offsets = np.arange(PLC_LABELS + 1) * per
    labels = np.repeat(np.arange(PLC_LABELS, dtype=np.int32), per)
    state = plc.CuGraphRandomState(h, PLC_SEED + 1)
    got = _plc_call("homogeneous_uniform_neighbor_sample CSR", counts, secs,
                    lambda: plc.homogeneous_uniform_neighbor_sample(
                        h, sg, seeds, offsets, np.array(PLC_FANOUT),
                        random_state=state, renumber=True,
                        compression="CSR", retain_seeds=True))
    frame = ct.homogeneous_uniform_neighbor_sample(
        G, seeds, PLC_FANOUT, with_replacement=False,
        random_state=((PLC_SEED + 1) * 1_000_003 + 1) % 2**31,
        batch_id_list=labels)
    want = _compress_numpy(frame, seeds, labels, PLC_LABELS)
    for key, value in want.items():
        if not np.array_equal(np.asarray(got[key]), value):
            raise AssertionError(f"plc sampler CSR: {key} differs from "
                                 "the NumPy re-derivation of the plain "
                                 "frame")
    if got["majors"] is not None:
        raise AssertionError("plc sampler CSR: majors given")
    print(f"plc: sampler CSR from {PLC_SAMPLE_SEEDS} seeds in {PLC_LABELS} "
          f"labels: {len(frame)} edges; offsets ({len(want['major_offsets'])}"
          "), label offsets, renumber map and minors equal NumPy's from the "
          "plain frame on the state's seed", flush=True)
    walkers, depth = PLC_WALKS
    starts = _seeds_with_out_edges(G, walkers, PLC_SEED + 2, replace=True)
    vp, wp, max_len = _plc_call(
        f"uniform_random_walks {walkers}x{depth}", counts, secs,
        lambda: plc.uniform_random_walks(
            h, sg, starts, depth, plc.CuGraphRandomState(h, PLC_SEED + 2)))
    if max_len != depth or len(wp) != walkers * depth:
        raise AssertionError("plc walks: another layout")
    _check_walks("plc uniform_random_walks", G, vp, walkers, depth)

    a, b, c = RMAT_ABC
    got = _plc_call(f"generate_rmat_edgelist scale {SCALE}", counts, secs,
                    lambda: plc.generate_rmat_edgelist(
                        h, SEED, SCALE, EDGE_FACTOR << SCALE, a, b, c))
    _plc_same("generate_rmat_edgelist", got, (src, dst))
    got = _plc_call("degrees", counts, secs, lambda: plc.degrees(h, sg))
    order = np.argsort(G.nodes(), kind="stable")
    _plc_same("degrees", got, (G.nodes()[order],
                               np.bincount(d0, minlength=n)[order],
                               out_deg[order]))
    got = _plc_call("decompress_to_edgelist", counts, secs,
                    lambda: plc.decompress_to_edgelist(h, sg))
    keys = np.sort(got[0].astype(np.int64) << 32 | got[1].astype(np.int64))
    want = np.sort(src.astype(np.int64) << 32 | dst.astype(np.int64))
    want = want[np.concatenate([[True], np.diff(want) != 0])]
    if not np.array_equal(keys, want):
        raise AssertionError("plc decompress_to_edgelist: the sorted keys "
                             "differ from the input COO's")
    print(f"plc: RMAT-{SCALE} wrappers equal the top-level calls bit for "
          "bit; bfs from 32 sources the per-vertex argmin of the panel; "
          "sssp = bfs on unit weights; generate_rmat_edgelist = rmat; "
          f"degrees = NumPy's; decompress_to_edgelist = the {len(want)} "
          "distinct input keys", flush=True)
    for label, key, exact in (
            ("pagerank", "spmv_csr_sum_mul", None),
            ("personalized_pagerank", "spmv_csr_sum_mul", None),
            ("hits", "spmv_csr_sum_mul", 2 * HITS_ITERS),
            ("bfs 1 source", "spmv_semiring_max_left_i32", None),
            ("bfs 1 source", "spmv_select_eqsel_rel_unit", 1),
            (f"bfs {PLC_MSBFS_SOURCES} sources", "spmm_csr_sum_unit", None),
            ("sssp", "spmv_semiring_min_add", None),
            ("sssp", "spmv_select_eqsel_rel", 1),
            ("weakly_connected_components", "spmv_semiring_min_left_i32",
             None),
            (f"betweenness_centrality k={PLC_BC_K}", "spmm_csr_sum_unit",
             None)):
        _lt_need(counts[label], key, f"plc {label}", exact)


def plc_netscience(Gn, counts, secs):
    """The community, similarity, triangle and core wrappers on a
    symmetric SGGraph of netscience.csv (both directions, as the file
    lists them), each against the top-level call on its graph."""
    import pandas as pd

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch import plc

    h = plc.ResourceHandle()
    a = np.loadtxt(NETSCIENCE)
    sg = plc.SGGraph(h, plc.GraphProperties(is_symmetric=True),
                     a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                     a[:, 2].astype(np.float32))
    S = sg.graph()
    if S.is_directed() or S.device != Gn.device \
            or sg.number_of_edges() != Gn.number_of_edges():
        raise AssertionError("symmetric SGGraph: another graph than the "
                             "undirected netscience Graph")
    _plc_same("netscience SGGraph edges", _edge_set(S), _edge_set(Gn))
    got = _plc_call("netscience louvain", counts, secs,
                    lambda: plc.louvain(h, sg))
    parts, q = ct.louvain(S)
    _plc_same("louvain", got, (*_by_vertex(parts, ["partition"]),
                               np.float64(q)))
    state = plc.CuGraphRandomState(h, PLC_SEED)
    got = _plc_call("netscience leiden", counts, secs,
                    lambda: plc.leiden(h, state, sg))
    parts, q = ct.leiden(S, random_state=(PLC_SEED * 1_000_003 + 1) % 2**31)
    _plc_same("leiden", got, (*_by_vertex(parts, ["partition"]),
                              np.float64(q)))
    got = _plc_call("netscience ecg", counts, secs,
                    lambda: plc.ecg(h, None, sg))
    parts, _ = ct.ecg(S, min_weight=0.0001, random_state=0)
    _plc_same("ecg", got, _by_vertex(parts, ["partition"]))
    es, ed, _ = S.edgelist_arrays()
    first = S.number_map.to_external(es[es < ed])
    second = S.number_map.to_external(ed[es < ed])
    got = _plc_call("netscience jaccard_coefficients", counts, secs,
                    lambda: plc.jaccard_coefficients(h, sg, first, second))
    want = ct.jaccard(S, pd.DataFrame({"first": first, "second": second}))
    _plc_same("jaccard_coefficients", got, (
        want["first"].to_numpy(), want["second"].to_numpy(),
        want["jaccard_coeff"].to_numpy()))
    got = _plc_call("netscience triangle_count", counts, secs,
                    lambda: plc.triangle_count(h, sg))
    _plc_same("triangle_count", got, _by_vertex(ct.triangle_count(S),
                                                ["counts"]))
    got = _plc_call("netscience core_number", counts, secs,
                    lambda: plc.core_number(h, sg))
    _plc_same("core_number", got, _by_vertex(ct.core_number(S),
                                             ["core_number"]))
    got = _plc_call(f"netscience k_truss_subgraph k={PLC_KTRUSS_K}", counts,
                    secs, lambda: plc.k_truss_subgraph(h, sg, PLC_KTRUSS_K))
    T = ct.ktruss_subgraph(S, PLC_KTRUSS_K)
    ts, td, tw = T.edgelist_arrays()
    _plc_same("k_truss_subgraph", got, (
        T.number_map.to_external(ts), T.number_map.to_external(td), tw))
    print(f"plc: netscience SGGraph (is_symmetric, {len(a)} rows) = the "
          "undirected Graph's edges; louvain, leiden on a state, ecg, "
          f"jaccard over {len(first)} edge pairs, triangle_count, "
          f"core_number and k_truss_subgraph({PLC_KTRUSS_K}) equal the "
          "top-level calls bit for bit", flush=True)


def plc_paths(G, edges, Gn, card):
    """The plc layer phase; returns the launch counts by call."""
    counts, secs = {}, {}
    plc_rmat(G, edges, counts, secs)
    plc_netscience(Gn, counts, secs)
    for label, s in secs.items():
        graph = ("netscience" if label.startswith("netscience")
                 else f"RMAT-{SCALE}")
        print(json.dumps({"metric": f"plc {label}", "ms_per_call": s * 1e3,
                          "runs": 1, "graph": graph, "card": card}),
              flush=True)
    return counts


# -- the multi-device layer on a 1x1 NCCL mesh -------------------------------

# BASELINE.json's fifth configuration trains GraphSAGE on ogbn-papers100M:
# 128 features, 172 classes; hidden 256 as the GNN phase's
MG_GNN_CLASSES = 172
MG_GNN_STEPS = 5


def _mg_call(label, counts, secs, fn):
    """One call of the multi-device layer: the launch counts set to 0 just
    before and read just after, its seconds on the host clock to a
    synchronised end; prints both."""
    import torch

    torch.cuda.synchronize()
    _reset_spmm_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[label] = time.perf_counter() - t0
    counts[label] = _read_spmm_counts()
    print(f"mg: {label} {secs[label] * 1e3:.1f} ms; launches "
          f"{ {k: v for k, v in counts[label].items() if v} }", flush=True)
    return out


def _mg_need(counts, label, key, want):
    """``label``'s run launched ``key`` ``want`` times and nothing else."""
    c = counts[label]
    others = {k: v for k, v in c.items() if v and k != key}
    if c[key] != want or others:
        raise AssertionError(f"mg {label}: {c[key]} launches of {key}, "
                             f"expected {want}; others {others}")


def _sssp_rounds(s, d, w, source, n, dev):
    """Plain-torch Bellman-Ford on ``dev`` in the order ``mg_sssp`` takes
    its rounds (each relaxes every edge from the previous round's
    distances, float32, until none changes): (rounds, distances)."""
    import torch

    s = torch.from_numpy(s.astype(np.int64)).to(dev)
    d = torch.from_numpy(d.astype(np.int64)).to(dev)
    w = torch.from_numpy(w.astype(np.float32)).to(dev)
    dist = torch.full((n,), float("inf"), device=dev)
    dist[source] = 0.0
    rounds = 0
    while True:
        new = dist.scatter_reduce(0, d, dist[s] + w, "amin")
        rounds += 1
        if not bool((new < dist).any()):
            return rounds, dist.cpu().numpy()
        dist = new


def _wcc_rounds(s, d, n, dev):
    """Plain-torch label propagation on ``dev`` in the order ``mg_wcc``
    takes its rounds (the minimum over in-neighbours, then over
    out-neighbours of the updated labels, until none changes): the
    rounds."""
    import torch

    s = torch.from_numpy(s.astype(np.int64)).to(dev)
    d = torch.from_numpy(d.astype(np.int64)).to(dev)
    lab = torch.arange(n, device=dev)
    rounds = 0
    while True:
        new = lab.scatter_reduce(0, d, lab[s], "amin")
        new = new.scatter_reduce(0, s, new[d], "amin")
        rounds += 1
        if not bool((new < lab).any()):
            return rounds
        lab = new


def _hold_unit_l1(label, got, want, it, it_ref):
    """A power method's vector against float64 at unit L1 norm (as
    ``_hold_power``), with the reference's iteration count."""
    if it != it_ref:
        raise AssertionError(f"{label}: {it} iterations, the float64 "
                             f"reference stopped after {it_ref}")
    l1 = float(np.abs(got / np.abs(got).sum()
                      - want / np.abs(want).sum()).sum())
    if not (np.isfinite(got).all() and l1 <= L1_TOL):
        raise AssertionError(f"{label}: L1 {l1:.3e} > {L1_TOL} at unit L1 "
                             "norm")
    print(f"{label}: {it} iterations as the float64 reference; L1 vs "
          f"float64 at unit L1 norm {l1:.3e} (<= {L1_TOL})", flush=True)


def _mg_gnn_inputs(G, device):
    """X [n, 128] N(0, 1) from GNN_SEED, 172 labels by argmax(X·R), a train
    mask of half the vertices (as ``gnn_inputs``), and GraphSAGE(128,
    256, 172)'s initial weights in the JAX layout."""
    import torch

    from cugraph_tpu_torch.nn import graphsage_init

    n = G.number_of_vertices()
    rng = np.random.default_rng(GNN_SEED)
    x = rng.standard_normal((n, GNN_IN), dtype=np.float32)
    rule = rng.standard_normal((GNN_IN, MG_GNN_CLASSES), dtype=np.float32)
    labels = np.argmax(x @ rule, axis=1).astype(np.int64)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n // 2]] = True
    params = graphsage_init(torch.Generator().manual_seed(GNN_SEED), GNN_IN,
                            GNN_HIDDEN, MG_GNN_CLASSES, device=device)
    return x, labels, mask, params


def _sg_first_step(G, x, labels, mask, params):
    """The single-device port's GraphSAGE loss and parameter gradients on
    the same weights: ``graphsage_apply`` over the Graph's structure."""
    import torch

    from cugraph_tpu_torch.nn import graphsage_apply
    from cugraph_tpu_torch.nn.models import masked_cross_entropy

    dev = G.device
    p = [{k: v.detach().clone().requires_grad_(True) for k, v in
          layer.items()} for layer in params]
    loss = masked_cross_entropy(
        graphsage_apply(p, G.structure, torch.from_numpy(x).to(dev)),
        torch.from_numpy(labels).to(dev), torch.from_numpy(mask).to(dev))
    leaves = [(i, k, t) for i, layer in enumerate(p)
              for k, t in sorted(layer.items())]
    grads = torch.autograd.grad(loss, [t for *_, t in leaves])
    return loss.item(), {(i, k): g for (i, k, _), g in zip(leaves, grads)}


def mg_paths(G, Gu, bfs_out, sssp_out, wcc_df, refs, card):
    """The multi-device layer (``cugraph_tpu_torch.parallel``) on a one-rank
    NCCL mesh: DistGraphs of the directed RMAT-20 and of the Graph500
    construction, each algorithm once with its launches counted, every
    result held to the single-device port's bounds (against the float64
    and scipy references of the earlier checks, ``refs``, and the
    single-device port's results), MG GraphSAGE at (128, 256, 172) for
    MG_GNN_STEPS Adam steps with its first step held against the
    single-device port's, and MG PageRank's ms per iteration beside the
    single-device port's.  Returns the launch counts by call."""
    import torch
    import torch.distributed as dist

    from cugraph_tpu_torch import parallel as mg
    from cugraph_tpu_torch.parallel import nn as pnn

    on_card = G.device.type == "cuda"
    dev = torch.device("cuda:0") if on_card else G.device
    if on_card:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:  # a rehearsal on the CPU
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    counts, secs = {}, {}
    try:
        mesh = mg.make_mesh_2d(1, 1, device=None if on_card else dev)
        if mesh.device != dev:
            raise AssertionError(f"make_mesh_2d() chose {mesh.device}")
        n, nu = G.number_of_vertices(), Gu.number_of_vertices()
        s, d, _ = G.edgelist_arrays()
        su, du, wu = Gu.edgelist_arrays()
        t0 = time.perf_counter()
        gd = mg.build_dist_graph(s, d, None, n, mesh, store_push=True)
        gu = mg.build_dist_graph(su, du, wu, nu, mesh, store_push=False)
        torch.cuda.synchronize()
        secs["build_dist_graph x2"] = time.perf_counter() - t0
        print(f"mg: a {mesh.pmaj}x{mesh.pmin} NCCL mesh on {mesh.device}; "
              f"DistGraphs of the directed RMAT-{SCALE} ({gd.num_edges} "
              f"edges, pull and push) and the Graph500 one ({gu.num_edges}) "
              f"in {secs['build_dist_graph x2']:.1f} s", flush=True)

        def own(x):
            return x.cpu().numpy()

        # power methods, K1 (mul)
        p, _, it = _mg_call("pagerank", counts, secs,
                            lambda: mg.mg_pagerank(gd, mesh))
        p_ref, it_ref = refs["pagerank"]
        if it != it_ref:
            raise AssertionError(f"mg_pagerank: {it} iterations, the "
                                 f"reference {it_ref}")
        _hold(f"mg_pagerank, {it} iterations", own(p)[:n], p_ref)
        _mg_need(counts, "pagerank", "spmv_csr_sum_mul", it)
        alpha, x_ref, it_ref = refs["katz"]
        c, _, it = _mg_call("katz_centrality", counts, secs,
                            lambda: mg.mg_katz_centrality(
                                gd, mesh, alpha=alpha, tol=n * 1e-6))
        _hold_unit_l1("mg_katz_centrality", own(c)[:n], x_ref, it, it_ref)
        _mg_need(counts, "katz_centrality", "spmv_csr_sum_mul", it)
        h, a, _, it = _mg_call("hits", counts, secs, lambda: mg.mg_hits(
            gd, mesh, tol=0.0, max_iter=HITS_ITERS))
        h_ref, a_ref = refs["hits"]
        _hold(f"mg_hits hubs, {it} iterations", own(h)[:n], h_ref)
        _hold("mg_hits authorities", own(a)[:n], a_ref)
        _mg_need(counts, "hits", "spmv_csr_sum_mul", 2 * it)
        e, _, it = _mg_call("eigenvector_centrality", counts, secs,
                            lambda: mg.mg_eigenvector_centrality(gu, mesh))
        x_ref, it_ref = refs["eigenvector"]
        _hold_unit_l1("mg_eigenvector_centrality", own(e)[:nu], x_ref, it,
                      it_ref)
        _mg_need(counts, "eigenvector_centrality", "spmv_csr_sum_mul", it)

        # degrees
        din, dout = _mg_call("degrees", counts, secs,
                             lambda: mg.mg_degrees(gd, mesh))
        if not (np.array_equal(own(din)[:n], np.bincount(d, minlength=n))
                and np.array_equal(own(dout)[:n],
                                   np.bincount(s, minlength=n))):
            raise AssertionError("mg_degrees differ from the host counts")
        print("mg_degrees: equal to the host in- and out-degree counts")

        # traversals, K2
        int_inf = np.iinfo(np.int32).max
        for (key, df, _), ref in zip(bfs_out, refs["hops"]):
            k = int(_internal(Gu, [key])[0])
            dist_, pred = _mg_call(f"bfs {key}", counts, secs,
                                   lambda: mg.mg_bfs(gu, mesh, k))
            dist_, pred = own(dist_)[:nu], own(pred)[:nu]
            # one K2 per level, the last one finding no new vertex
            _mg_need(counts, f"bfs {key}", "spmv_semiring_max_left_i32",
                     int(dist_[dist_ < int_inf].max()) + 1)
            sg_d = np.empty(nu, np.int64)
            sg_p = np.empty(nu, np.int64)
            at = _internal(Gu, df["vertex"].to_numpy())
            sg_d[at] = df["distance"].to_numpy()
            sg_p[at] = _internal(Gu, df["predecessor"].to_numpy())
            want = np.where(np.isinf(ref), int_inf, ref).astype(np.int64)
            if not (np.array_equal(dist_, want) and np.array_equal(
                    dist_, sg_d) and np.array_equal(pred, sg_p)):
                raise AssertionError(f"mg_bfs {key}: distances differ from "
                                     "scipy's or the single-device port's, "
                                     "or predecessors from the port's")
        print(f"mg_bfs: {len(bfs_out)} keys, distances equal scipy's and "
              "the single-device port's, predecessors the port's (the "
              "largest in-neighbour one level up)", flush=True)
        key, df, _ = sssp_out[0]
        k = int(_internal(Gu, [key])[0])
        dist_, pred = _mg_call(f"sssp {key}", counts, secs,
                               lambda: mg.mg_sssp(gu, mesh, k))
        dist_, pred = own(dist_)[:nu], own(pred)[:nu]
        rounds, bf = _sssp_rounds(su, du, wu, k, nu, dev)
        _mg_need(counts, f"sssp {key}", "spmv_semiring_min_add", rounds)
        if not np.array_equal(dist_, bf):
            raise AssertionError("mg_sssp: distances differ from plain "
                                 "float32 Bellman-Ford's")
        sg = np.empty(nu, np.float32)
        sg[_internal(Gu, df["vertex"].to_numpy())] = \
            df["distance"].to_numpy()
        reached = np.isfinite(dist_)
        if not np.array_equal(reached, sg < np.finfo(np.float32).max):
            raise AssertionError("mg_sssp: reachability differs from the "
                                 "single-device port's")
        rel = float((np.abs(dist_[reached] - sg[reached])
                     / np.maximum(sg[reached], 1e-30)).max())
        if rel > SSSP_RTOL:
            raise AssertionError(f"mg_sssp: relative error {rel:.3e} > "
                                 f"{SSSP_RTOL} against the port's")
        ok = reached[su] & (dist_[su] + wu == dist_[du])
        pred_want = np.full(nu, -1, np.int64)
        np.maximum.at(pred_want, du[ok], su[ok])
        pred_want[k] = -1
        if not np.array_equal(pred, pred_want):
            raise AssertionError("mg_sssp: predecessors differ from the "
                                 "largest exact-equality in-neighbour")
        print(f"mg_sssp {key}: distances within rtol {SSSP_RTOL} of the "
              f"single-device port's (max {rel:.3e}, "
              f"{int((dist_[reached] == sg[reached]).sum())} of "
              f"{int(reached.sum())} equal), predecessors the largest "
              "in-neighbour with d[u] + w == d[v] in float32", flush=True)
        lab = _mg_call("wcc", counts, secs, lambda: mg.mg_wcc(gd, mesh))
        _mg_need(counts, "wcc", "spmv_semiring_min_left_i32",
                 2 * _wcc_rounds(s, d, n, dev))
        got = own(lab)[:n]
        sg = np.empty(n, np.int64)
        sg[_internal(G, wcc_df["vertex"].to_numpy())] = _internal(
            G, wcc_df["labels"].to_numpy())
        if not (np.array_equal(got, refs["wcc"])
                and np.array_equal(got, sg)):
            raise AssertionError("mg_wcc: labels differ from scipy's or the "
                                 "single-device port's")
        print(f"mg_wcc: {refs['n_wcc']} components, labels equal scipy's "
              "smallest "
              "internal ids and the single-device port's", flush=True)

        # MG GraphSAGE at papers100M's widths, K4 and its VJP
        x, labels, mask, params = _mg_gnn_inputs(G, dev)
        sg_loss, sg_grads = _sg_first_step(G, x, labels, mask, params)

        def pad(a):
            out = np.zeros((gd.pad_v,) + a.shape[1:], a.dtype)
            out[:n] = a
            return out

        xo, lo, mo = pnn.shard_vertex_data(mesh, pad(x), pad(labels),
                                           pad(mask))
        step = pnn.make_mg_train_step(
            gd, mesh, lambda ps: torch.optim.Adam(ps, lr=GNN_LR))
        state = {"p": pnn.replicate(mesh, params), "opt": None}
        losses, step_ms, grads = [], [], None

        def train():
            nonlocal grads
            for _ in range(MG_GNN_STEPS):
                t0 = time.perf_counter()
                state["p"], state["opt"], loss = step(
                    state["p"], state["opt"], xo, lo, mo)
                losses.append(loss.item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if grads is None:
                    grads = {(i, k): t.grad.clone() for i, layer in
                             enumerate(state["p"]) for k, t in layer.items()}

        gnn_label = (f"graphsage {GNN_IN}-{GNN_HIDDEN}-{MG_GNN_CLASSES} "
                     f"{MG_GNN_STEPS} steps")
        _mg_call(gnn_label, counts, secs, train)
        c = counts[gnn_label]
        got = (c["spmm_csr_sum_weighted"], c["spmm_csr_sum_weighted_vjp"])
        want = (2 * MG_GNN_STEPS, MG_GNN_STEPS)
        others = {k: v for k, v in c.items() if v and k not in (
            "spmm_csr_sum_weighted", "spmm_csr_sum_weighted_vjp")}
        if got != want or others:
            raise AssertionError(f"mg graphsage: K4 forward/VJP launches "
                                 f"{got}, expected {want}; others {others}")
        loss_err = abs(losses[0] - sg_loss) / abs(sg_loss)
        grad_err = {f"{i}.{k}": float(torch.linalg.vector_norm(
            grads[(i, k)].double() - g.double())
            / torch.linalg.vector_norm(g.double()))
            for (i, k), g in sg_grads.items()}
        if not (loss_err <= GNN_LOSS_RTOL
                and max(grad_err.values()) <= GNN_GRAD_RTOL):
            raise AssertionError(
                f"mg graphsage first step against the single-device port: "
                f"loss relative error {loss_err:.3e} (limit "
                f"{GNN_LOSS_RTOL}), gradients {grad_err} (limit "
                f"{GNN_GRAD_RTOL})")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"mg graphsage losses {losses}: the last "
                                 "is not below the first")
        print(f"mg graphsage {GNN_IN}-{GNN_HIDDEN}-{MG_GNN_CLASSES}: losses "
              f"{losses}; ms per step (host clock to the loss read) "
              f"{[round(t, 2) for t in step_ms]}; first step against the single-device port's: "
              f"loss relative error {loss_err:.3e} (<= {GNN_LOSS_RTOL}), "
              f"gradients' relative L2 {grad_err} (<= {GNN_GRAD_RTOL})",
              flush=True)
        del xo, lo, mo, state, grads, sg_grads

        # MG PageRank's ms per iteration beside the single-device port's,
        # measured the same way, in turns
        n_it = PAGERANK_TIMED_ITERS
        sg_run = functools.partial(_pagerank_call, G)

        def mg_run(iters):
            return lambda: mg.mg_pagerank(gd, mesh, tol=0.0, max_iter=iters)

        diffs = {"sg": [], "mg": []}
        for _ in range(TIMED_PAIRS):
            for name, run in (("sg", sg_run), ("mg", mg_run)):
                t1 = _cuda_ms(run(n_it), 1)
                t2 = _cuda_ms(run(2 * n_it), 1)
                diffs[name].append((t2 - t1) / n_it)
        per_it = {k: float(np.median(v)) for k, v in diffs.items()}
        print(f"mg_pagerank: {per_it['mg']:.4f} ms per iteration on the 1x1 "
              f"NCCL mesh beside the single-device port's "
              f"{per_it['sg']:.4f} (median of {TIMED_PAIRS} pairs of "
              f"{n_it} and {2 * n_it} iterations, in turns)", flush=True)
        profile_power_iteration(G, card, per_it["mg"], call=mg_run,
                                label=f"mg_pagerank_rmat{SCALE}_1x1")
        print(json.dumps({"metric": f"mg_pagerank_rmat{SCALE}_1x1_ms_per_"
                                    "iteration",
                          "ms_per_iteration": per_it["mg"],
                          "ms_per_iteration_runs": diffs["mg"],
                          "sg_ms_per_iteration": per_it["sg"],
                          "sg_ms_per_iteration_runs": diffs["sg"],
                          "mesh": "1x1 nccl", "card": card}), flush=True)
        for label, sec in secs.items():
            print(json.dumps({"metric": f"mg {label}",
                              "ms_per_call": sec * 1e3, "runs": 1,
                              "mesh": "1x1 nccl", "card": card}), flush=True)
        del gd, gu
    finally:
        dist.destroy_process_group()
    return counts


def print_slice_metrics(secs, card):
    """One metric line per call of the triangle ... biclique phases: its
    single run's ms (host clock to a synchronised end) and its graph."""
    cut = f"Graph500 RMAT-{COMMUNITY_CUT_SCALE}"
    graphs = {"triangle_count": cut, "edge_triangle_count": cut,
              "k_truss": f"Graph500 RMAT-{KTRUSS_SCALE}",
              "topological_sort": f"DAG RMAT-{SCALE}",
              f"dense_hungarian_{HUNGARIAN_N}": "dense costs",
              "force_atlas2_exact": "netscience, 500 iterations",
              "force_atlas2_pm": f"Graph500 RMAT-{FA2_PM_SCALE}, "
                                 f"{FA2_PM_ITERS} iterations",
              "spectralBalancedCutClustering": "netscience",
              "spectralModularityMaximizationClustering": "netscience",
              "find_bicliques": "planted 15 x 6"}
    for name, s in secs.items():
        print(json.dumps({"metric": name, "ms_per_call": s * 1e3, "runs": 1,
                          "graph": graphs.get(name,
                                              f"Graph500 RMAT-{SCALE}"),
                          "card": card}), flush=True)


def main() -> int:
    import torch

    from cugraph_tpu_torch.kernels import semiring, spmm, spmv

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device 0: {kind}; device count {count}")
    device = torch.device("cuda")

    with phase("build"):
        build_kernels()
    vjp_err = {"weighted": 0.0, "weighted_vjp": 0.0}

    def hold_vjp(name, gs, widths, seed=0):
        for key, err in zip(vjp_err, check_spmm_vjp(name, gs, widths, seed)):
            vjp_err[key] = max(vjp_err[key], err)

    with phase("kernel checks, small cases"):
        for name, gs in small_cases(device):
            for combine in ("mul", "left"):
                check_kernel(name, gs.csc, combine)
            check_semiring_and_select(name, gs.csc)
            check_spmm(name, gs.csc, SPMM_WIDTHS)
            hold_vjp(name, gs, VJP_WIDTHS)
            if name == "random":  # NaNs and signed zeros, heavy rows at 8
                check_min_max(name, gs.csc, 8, SPMM_WIDTHS)
    with phase("kernel checks, heavy rows"):
        k1_heavy, k4_heavy = check_heavy_rows(device, hold_vjp)

    with phase("RMAT-20 directed graph"):
        G, edges = build_graph(device)
    g = G.structure
    with phase("host set-up, native engines against NumPy"):
        time_host_setup(G)
    max_err, k23_err, k45_err = {}, {}, dict(k4_heavy)
    with phase("kernel checks, RMAT-20 directed"):
        for combine in ("mul", "left"):
            max_err[combine] = max(k1_heavy[combine], check_kernel(
                f"rmat{SCALE} csc", g.csc, combine))
            check_kernel(f"rmat{SCALE} csr", g.csr, combine)
        w_rand = torch.from_numpy(np.random.default_rng(2).uniform(
            0.5, 1.5, g.num_edges).astype(np.float32)).to(device)
        check_kernel(f"rmat{SCALE} csc w", g.csc, "mul", weights=w_rand)
        # the WCC, SCC and hybrid WCC sweeps over both orientations
        for name, adj in (("csc", g.csc), ("csr", g.csr)):
            k23_err.update(check_semiring_and_select(
                f"rmat{SCALE} {name}", adj,
                modes={"min_left_i32", "max_left_i32", "max_left"}))
            for key, err in check_spmm(f"rmat{SCALE} {name}", adj,
                                       (PANEL,)).items():
                k45_err[key] = max(k45_err.get(key, 0.0), err)
        # K4's VJP at the GNN's hidden width: on the path's structure, and
        # on the same edges with random weights, which the CSR must carry
        # as the transpose of the CSC's
        hold_vjp(f"rmat{SCALE}", g, (GNN_HIDDEN,), 1)
        from cugraph_tpu_torch.core.structure import build_structure

        s_int, d_int, _ = G.edgelist_arrays()
        gw = build_structure(s_int, d_int, w_rand.cpu().numpy(),
                             g.num_vertices, device)
        hold_vjp(f"rmat{SCALE} w", gw, (GNN_HIDDEN,), 2)
        del gw

    with phase("pagerank/hits path"):
        counts, refs = main_path(G)
    if counts["mul"] == 0:
        raise AssertionError("the main path launched spmv_csr_sum_mul no time")

    with phase("Graph500 undirected graph"):
        Gu, lo, hi, wmin, keys = build_graph500_graph(edges, device)
    with phase("kernel checks, RMAT-20 undirected"):
        k23_err.update(check_semiring_and_select(f"rmat{SCALE} u-csc",
                                                 Gu.structure.csc))
        # eigenvector's K1 and the MIS/coloring sweeps' loop-free CSC
        max_err["mul_undirected"] = check_kernel(
            f"rmat{SCALE} u-csc", Gu.structure.csc, "mul")
        check_semiring_and_select(f"rmat{SCALE} u-csc loop-free",
                                  Gu.structure.loop_free.csc,
                                  modes={"max_left_i32"})
        for key, err in check_spmm(f"rmat{SCALE} u-csc", Gu.structure.csc,
                                   (PANEL,)).items():
            k45_err[key] = max(k45_err.get(key, 0.0), err)
    with phase("traversal paths"):
        bfs_out, sssp_out, wcc_out, paths = traversal_paths(Gu, G, keys)
    with phase("traversal checks against scipy"):
        refs.update(check_traversal(Gu, G, lo, hi, wmin, bfs_out, sssp_out,
                                    wcc_out))
    with phase("analytics paths"):
        origins, dests = analytics_inputs(G, Gu)
        an_out, an_counts, an_runs = analytics_paths(G, Gu, origins, dests)
    with phase("analytics checks"):
        check_analytics(G, Gu, origins, dests, an_out)
    del an_out
    with phase("components, cores and power-method paths"):
        cp_out, cp_counts, cp_runs, cp_secs = component_paths(G, Gu)
    with phase("components, cores and power-method checks"):
        refs.update(check_component_paths(G, Gu, cp_out, cp_runs,
                                          wcc_out[0]["labels"].to_numpy()))
    del cp_out
    paths.update({name: cp_counts[name] for name in
                  ("scc", "wcc_hybrid", "mis", "coloring")})
    with phase("gnn path"):
        gx, glabels, gmask = gnn_inputs(G)
        gnn_runs = gnn_path(G, gx, glabels, gmask)
    with phase("gnn checks against float64"):
        check_gnn(G, gx, glabels, gmask, gnn_runs)
    with phase("sampling paths"):
        s_out, s_counts, _ = sampling_paths(G, Gu)
    paths.update({f"sampling {k}": v for k, v in s_counts.items()})
    with phase("sampling checks"):
        check_sampling_paths(G, Gu, s_out)
        k23_err.update(check_select(G))
        check_card_against_cpu(device)
    with phase("sampled gnn and link prediction paths"):
        mb_run = sampled_gnn_path(G, gx, glabels, gmask)
        lp_run = linkpred_path(G, gx)
    with phase("sampled gnn checks against float64"):
        check_sampled_gnn(mb_run)
    with phase("typed graph: edge ids, types and times"):
        Gt = typed_graph(edges, device)
    with phase("masked sampling and lookup paths"):
        m_out, m_counts, m_secs = masked_paths(Gt)
    paths.update({f"masked {k}": v for k, v in m_counts.items()})
    with phase("masked sampling checks"):
        check_masked_paths(Gt, m_out)
    with phase("MultiGraph path"):
        mg_counts, mg_secs = multigraph_path(device)
    with phase("BASELINE netscience: louvain + wcc + jaccard"):
        Gn = netscience_graph(device)
        net_out, paths["netscience wcc"] = netscience_paths(Gn)
    with phase("community and similarity, RMAT"):
        cs_out, cs_secs, cs_probes, cs_profile, Gc = community_rmat_paths(
            Gu, lo, hi, device)
    with phase("community and similarity checks"):
        check_community_paths(Gn, net_out, Gu, cs_out, Gc)
    del cs_out
    with phase("triangles and k-truss paths"):
        tri_out, slice_secs = triangle_paths(Gc)
    with phase("triangles and k-truss checks"):
        check_triangles(Gc, tri_out)
    del tri_out, Gc
    with phase("topological sort path"):
        Gd = dag_graph(edges, device)
        topo_df, slice_secs["topological_sort"], paths["topological_sort"] = \
            topo_path(Gd, G)
    with phase("topological sort checks"):
        check_topo(Gd, topo_df)
        max_err["left"] = max(max_err["left"], check_kernel(
            f"dag{SCALE} csc", Gd.structure.csc, "left"))
    del topo_df
    with phase("spanning tree paths"):
        tree_out, secs = tree_paths(Gu)
        slice_secs.update(secs)
    with phase("spanning tree checks against scipy"):
        check_trees(Gu, tree_out)
    del tree_out
    with phase("egonet paths"):
        ego_runs = ego_paths(Gu)
    with phase("egonet checks"):
        check_egos(Gu, ego_runs)
    for radius, run in ego_runs.items():
        paths[f"egonet radius {radius}"] = run["counts"]
        slice_secs[f"batched_ego_graphs_radius{radius}"] = run["secs"]
    del ego_runs
    with phase("matching path"):
        m_df, m_total, slice_secs["approx_weighted_matching"], _ = \
            matching_path(Gu)
    with phase("matching checks"):
        check_matching(Gu, m_df, m_total)
    del m_df
    with phase("assignment paths against scipy"):
        slice_secs[f"dense_hungarian_{HUNGARIAN_N}"], _ = assignment_paths(
            device)
    with phase("force_atlas2 paths"):
        fa_out, secs = layout_paths(Gn, device)
        slice_secs.update({f"force_atlas2_{k}": v for k, v in secs.items()})
    with phase("force_atlas2 checks"):
        check_layout(Gn, fa_out)
    del fa_out
    with phase("spectral clustering and bicliques"):
        slice_secs.update(spectral_biclique_paths(Gn))
    with phase("API long tail"):
        lt_counts, _ = longtail_paths(G, gx, glabels, gmask, device)
    paths.update(lt_counts)
    with phase("plc layer"):
        plc_counts = plc_paths(G, edges, Gn, card)
    paths.update({f"plc {k}": v for k, v in plc_counts.items()})
    with phase("multi-device layer (1x1 NCCL mesh)"):
        mgl_counts = mg_paths(G, Gu, bfs_out, sssp_out, wcc_out[0], refs,
                              card)
    paths.update({f"mg {k}": v for k, v in mgl_counts.items()})

    kernels = []
    with phase("timing pagerank and K1"):
        per_iter = time_power_iteration(G, card)["ms_per_iteration"]
        profile_power_iteration(G, card, per_iter)
        launches = {"mul": counts["mul"] + cp_counts["katz"][
            "spmv_csr_sum_mul"] + mg_counts["spmv_csr_sum_mul"]
            + lt_counts["pagerank BiPartiteGraph"]["spmv_csr_sum_mul"]
            + sum(c["spmv_csr_sum_mul"] for c in plc_counts.values())
            + sum(c["spmv_csr_sum_mul"] for k, c in mgl_counts.items()
                  if k != "eigenvector_centrality"),
            "left": counts["left"] + paths["topological_sort"][
                "spmv_csr_sum_left"]}
        # K1 left at its path's shape: the DAG's CSC
        for combine, adj in (("mul", g.csc), ("left", Gd.structure.csc)):
            row = time_kernel(adj, combine, card)
            kernels.append({"name": f"spmv_csr_sum_{combine}",
                            "route": "cuda", "source": SOURCE,
                            "replaces": REPLACES,
                            "launches": launches[combine],
                            "max_abs_err": max_err[combine], **row})
        # eigenvector_centrality's shape: the undirected CSC
        row = time_kernel(Gu.structure.csc, "mul", card)
        kernels.append({"name": "spmv_csr_sum_mul_undirected_csc",
                        "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES,
                        "launches": cp_counts["eigenvector"][
                            "spmv_csr_sum_mul"] + mgl_counts[
                            "eigenvector_centrality"]["spmv_csr_sum_mul"],
                        "max_abs_err": max_err["mul_undirected"], **row})
        x1 = torch.rand(g.num_vertices, device=device)
        time_without_heaviest(
            "spmv_csr_sum_mul", g.csc,
            lambda o, i, w: spmv.spmv_csr(o, i, w, x1, "mul"),
            lambda m: bound_ms(g.num_vertices, m, "mul"),
            KERNEL_TIMED_LAUNCHES, card)
    with phase("timing traversal"):
        time_traversal(Gu, G, lo, hi, bfs_out, sssp_out, card)
    with phase("timing components, cores and power methods"):
        time_component_paths(G, Gu, cp_secs, cp_runs, card)
    with phase("timing K2/K3"):
        rows = time_semiring_and_select(Gu, G, card)
        gu = Gu.structure
        xu = torch.rand(gu.num_vertices, device=device) * 10
        time_without_heaviest(
            "spmv_semiring_min_add", gu.csc,
            lambda o, i, w: semiring.spmv_semiring(o, i, w, xu, "min", "add"),
            lambda m: semiring_bound_ms(gu.num_vertices, m, "add"),
            KERNEL_TIMED_LAUNCHES, card)
        xs, _, atol, rtol = _select_inputs(gu.csc, "eqsel_rel", 101)
        time_without_heaviest(
            "spmv_select_eqsel_rel", gu.csc,
            lambda o, i, w: semiring.spmv_select(o, i, w, xs, "eqsel_rel",
                                                 atol, rtol),
            lambda m: semiring_bound_ms(gu.num_vertices, m, "eqsel_rel"),
            KERNEL_TIMED_LAUNCHES, card)
    for reduce, combine, is_int in SEMIRING_MODES:
        key = _semiring_key(reduce, combine, is_int)
        name = f"spmv_semiring_{key}"
        kernels.append({"name": name, "route": "cuda",
                        "source": SEMIRING_SOURCE,
                        "replaces": SEMIRING_REPLACES,
                        "launches": sum(c[name] for c in paths.values()),
                        "max_abs_err": k23_err[key], **rows[key]})
    for mode in SELECT_MODES:
        name = f"spmv_select_{mode}"
        kernels.append({"name": name, "route": "cuda",
                        "source": SELECT_SOURCE,
                        "replaces": SELECT_REPLACES[mode],
                        "launches": sum(c[name] for c in paths.values()),
                        "max_abs_err": k23_err[mode], **rows[mode]})
    with phase("timing analytics"):
        time_analytics(G, Gu, origins, dests, an_runs, card)
    with phase("timing K4/K5"):
        rows = time_spmm(G, Gu, card)
        xp = torch.rand(g.num_vertices, PANEL, device=device)
        time_without_heaviest(
            f"spmm_csr_sum_unit F={PANEL}", g.csc,
            lambda o, i, w: spmm.spmm_csr(o, i, None, xp),
            lambda m: spmm_bound_ms(g.num_vertices, m, PANEL, False), 10,
            card)
        xu = torch.rand(gu.num_vertices, PANEL, device=device) * 10
        time_without_heaviest(
            f"spmm_semiring_min_add F={PANEL}", gu.csc,
            lambda o, i, w: spmm.spmm_semiring(o, i, w, xu, "min", "add"),
            lambda m: spmm_bound_ms(gu.num_vertices, m, PANEL, True), 10,
            card)
        del xp, xu
    with phase("timing gnn"):
        time_gnn(G, gx, glabels, gmask, gnn_runs, card)
        gnn_rows = time_gnn_spmm(g, card)
        time_spmm_classes(g, card)
    with phase("timing sampling"):
        time_sampling(G, Gu, s_out, mb_run, lp_run, card)
    del s_out
    with phase("timing masked sampling, lookup and MultiGraph"):
        time_masked(Gt, m_out, m_secs, mg_secs, card)
    del m_out, Gt
    with phase("timing community and similarity"):
        time_community(Gn, Gu, cs_secs, cs_probes, cs_profile, card)
    print_slice_metrics(slice_secs, card)
    del Gd
    with phase("sweep of K1/K4 spans"):
        sweep_spans(g, card)
    with phase("sweep of K2/K3/K5 spans"):
        sweep_min_max_spans(Gu.structure, card)
        sweep_select_spans(Gu.structure, card)
    # K4 weighted's path is the GNN's: its row takes the F = 256 times
    rows.update({f"spmm_csr_sum_{k}": v for k, v in gnn_rows.items()})
    for key in gnn_rows:
        k45_err[f"spmm_csr_sum_{key}"] = max(
            k45_err.get(f"spmm_csr_sum_{key}", 0.0), vjp_err[key])
    path_counts = list(an_counts.values()) + [r["counts"] for r in
                                              gnn_runs.values()] + [
        mb_run["counts"], lp_run["counts"],
        lt_counts["graphsage_apply and functional step"],
        *plc_counts.values(), *mgl_counts.values()]
    for key, source, replaces in (
            [(f"spmm_csr_sum_{k}", SPMM_SOURCE, SPMM_REPLACES)
             for k in ("unit", "weighted")]
            + [("spmm_csr_sum_weighted_vjp", SPMM_SOURCE, VJP_REPLACES)]
            + [(f"spmm_semiring_{r}_{c}", SPMM_SEMIRING_SOURCE,
                SPMM_SEMIRING_REPLACES) for r, c in SPMM_SEMIRING_MODES]):
        kernels.append({"name": key, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c[key] for c in path_counts),
                        "max_abs_err": k45_err[key], **rows[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
