"""cugraph_tpu_torch — the PyTorch and CUDA port of ``cugraph_tpu``.

The same public functions with the same arguments, returning the same
frames, over torch tensors on an NVIDIA card; the heavy steps run in
kernels written by hand for Hopper (``kernels/csrc``):

- ``pagerank``, ``hits``: the sum SpMV K1 (``spmv_csr.cu``);
- ``bfs``: the min/max SpMV K2 (``spmv_semiring.cu``) in (max, left) on its
  dense levels, then the argmax select K3 (``spmv_select.cu``, eqsel_rel)
  for the predecessors;
- ``sssp``: K2 (min, add) on its dense relaxations, then K3 eqsel_rel;
- ``k_hop_neighbors``: K2 (max, left), one launch per hop;
- ``katz_centrality``, ``eigenvector_centrality``: K1 (mul) over the CSC,
  one launch per power iteration;
- ``weakly_connected_components``, ``connected_components(connection=
  "weak")``: K2 (min, left) over int32 labels; with
  ``CUGRAPH_TPU_WCC_HYBRID=1``, K2 (max, left) float32 mask sweeps, then a
  host pass;
- ``strongly_connected_components``, ``connected_components(connection=
  "strong")``: K2 (max, left) int32 over the CSC forward and (min, left)
  int32 over the CSR backward, in each round;
- ``maximal_independent_set``, ``vertex_coloring``: K2 (max, left) int32
  over the self-loop-free CSC (and CSR when directed), two per Luby round;
- ``betweenness_centrality``, ``edge_betweenness_centrality``: the sum
  SpMM K4 (``spmm_csr.cu``) at unit weight, over the CSC on each forward
  level and over the CSR on each backward level of a 128-source Brandes
  panel;
- ``multi_source_bfs``, ``concurrent_bfs``: K4 over the CSC on each level
  of a 128-source panel (``strategy="serial"``: K1 per source and level);
- ``od_shortest_distances``: K4 panels when the graph is unweighted, the
  min/max SpMM K5 (``spmm_semiring.cu``) in (min, add) when weighted;
- ``per_v_random_select`` (one random out-neighbour per vertex): K2 (max,
  right) over per-edge random priorities, then K3 eqsel, over the CSR; its
  rounds make ``algos.sampling._bulk_sample_with_replacement``, which the
  samplers do not take on the H100 (the gather route is faster);
- ``uniform_neighbor_sample``, ``homogeneous_uniform_neighbor_sample``,
  ``homogeneous_biased_neighbor_sample``, ``homogeneous_neighbor_sample``,
  the walks (``random_walks``, ``uniform_random_walks``,
  ``biased_random_walks``, ``node2vec_random_walks``, ``node2vec``) and
  ``negative_sampling`` are torch gathers, searches and sorts over the CSR
  on the card, one host copy per hop for the frame; ``sampling_post``'s
  five functions are NumPy and pandas;
- ``cugraph_tpu_torch.nn`` (GraphSAGE, GCN, GIN, GAT, GATv2, APPNP and
  their layers): "sum"/"mean" neighbour aggregation is K4 over the CSC,
  weighted, and its backward is K4 over the CSR
  (``kernels/spmm.make_spmm_pair``); GAT's attention is the fused kernel
  K6 (``kernels/gat.py``: the edge softmax and the weighted sum over the
  CSC, its backward over the CSC and the CSR); the dense transforms are
  float32 ``nn.Linear`` GEMMs, and GATv2's attention and "max"
  aggregation are plain torch; ``nn.make_batches``
  samples per seed batch and trains over each batch's structure (K4 over
  its CSC and CSR), and ``nn.linkpred`` scores pairs against
  ``sample_negatives``.

- ``jaccard``, ``sorensen``, ``overlap``, ``cosine`` (weighted or not),
  ``jaccard_coefficient`` and the ``*_coefficient`` aliases: the pair
  intersections run on the card (``prims/intersection.pair_intersection``,
  the min-degree probe as torch gathers and binary searches over the CSR,
  in chunks, with fixed-order sums), the coefficients in NumPy;
  ``all_pairs_jaccard``, ``all_pairs_sorensen``, ``all_pairs_overlap`` and
  ``all_pairs_cosine`` enumerate their two-hop candidates with a scipy
  product on the host, and score them on the card when weighted.

- ``heterogeneous_uniform_neighbor_sample``,
  ``heterogeneous_biased_neighbor_sample``, the four temporal samplers
  (``homogeneous_uniform_temporal_neighbor_sample``,
  ``homogeneous_biased_temporal_neighbor_sample``,
  ``heterogeneous_uniform_temporal_neighbor_sample``,
  ``heterogeneous_biased_temporal_neighbor_sample``) and
  ``heterogeneous_neighbor_sample``: a masked Gumbel top-k by edge type
  and time as torch sorts over the CSR on the card, every type of a hop
  in one pass; the edge properties of ``Graph``/``MultiGraph``
  (``edge_id``, ``edge_type``, ``edge_time``) follow the CSR by its kept
  sort permutation.

``louvain``, ``leiden`` and ``ecg`` run on the native host engines
(``louvain_sweep``, ``leiden_refine_sweep``, ``coarsen_edges`` of
``core/_native/builder.cpp``), with the level loop, its float64 modularity
and ECG's votes in NumPy, and ``analyzeClustering_modularity``,
``analyzeClustering_edge_cut`` and ``analyzeClustering_ratio_cut`` in
NumPy: no card kernel runs in community detection.
``EdgeIdLookupTable`` and the structure ops of ``algos/structure.py``
(``symmetrize``, ``induced_subgraph``, ``subgraph``, ``two_hop_neighbors``,
``decompress_to_edgelist``, ``count_multi_edges``, the weight sums,
``hypergraph``, ...) are NumPy and scipy on the host, as in the JAX
package.  ``shortest_path_length`` runs ``bfs`` or ``sssp``; ``filter_unreachable``
and ``extract_bfs_paths`` are host code over their frames, and
``degree_centrality`` over the degrees.  ``core_number`` and ``k_core`` run
the native host peel, and graph construction (``rmat``, renumbering,
de-duplication) the native host engines of ``core/native.py``, built with
g++ at first use.

- ``topological_sort``: Kahn levels, the in-degree decrement of each one
  launch of K1 in its "left" mode over the CSC on the level's mask;
- ``egonet``, ``batched_ego_graphs``, ``ego_graph``: one ``bfs`` per seed
  (K2 (max, left) on its dense levels), the induced edges masked on the
  card;
- ``triangle_count``, ``edge_triangle_count``, ``ktruss_subgraph`` and
  ``k_truss``: the native wedge engine (``triangle_support``) on the host
  over unique pairs sorted on the card;
- ``minimum_spanning_tree``, ``maximum_spanning_tree`` (Borůvka),
  ``approx_weighted_matching`` (locally-dominant rounds), ``hungarian``
  and ``dense_hungarian`` (the ε-scaled auction) and ``force_atlas2``
  (exact or particle-mesh repulsion, segmented attraction sums): torch
  scatters, sorts, dense tiles and matmuls on the card, no K-kernel;
- ``spectralBalancedCutClustering``,
  ``spectralModularityMaximizationClustering`` and
  ``experimental.find_bicliques``: scipy, NumPy and pandas on the host,
  as in the JAX package.

The Graph and API long tail: ``Tree``, ``BiPartiteGraph``,
``NPartiteGraph`` and Graph's construction aliases, predicates and
conversions; the constructors and exporters (``from_edgelist`` ...
``to_pandas_adjacency``: ``to_numpy_array`` builds the matrix on the
graph's device), the predicates, ``bfs_edges`` (``bfs``: K2 and K3),
``shortest_path`` (``sssp``: K2 and K3), ``symmetrize_df``;
``generators.simple``, ``datasets``, ``utils``, ``etl``, ``testing``,
``internals``, the import-path subpackages (``centrality`` ...
``utilities``) and ``nn``'s functional surface (``graphsage_apply`` and
the other ``*_apply``/``*_conv`` run their modules' code: K4 for "sum" and
"mean").

``plc``, the pylibcugraph-style stable layer (``SGGraph`` and one
``(resource_handle, graph, ...)`` function per algorithm, NumPy arrays
out): each wrapper calls the top-level function on the graph's device and
reaches its kernels (``plc.pagerank``: K1; ``plc.bfs``: K2 and K3, or K4
from several sources; ``plc.betweenness_centrality``: K4; ...).

Entry points run on the card unless the caller passes ``device="cpu"``
(``plc``: ``ResourceHandle(device="cpu")``).
This package imports neither JAX nor ``cugraph_tpu``.
"""

from cugraph_tpu_torch.api import exceptions
from cugraph_tpu_torch.api.exceptions import (CugraphTpuError,
                                              FailedToConvergeError,
                                              InvalidInputError)
from cugraph_tpu_torch.api.bipartite import BiPartiteGraph, NPartiteGraph
from cugraph_tpu_torch.api.convenience import (
    bfs_edges, concurrent_bfs, cosine_coefficient, ego_graph, from_adjlist,
    from_cudf_edgelist, from_edgelist, from_numpy_array, from_numpy_matrix,
    from_pandas_adjacency, from_pandas_edgelist,
    heterogeneous_neighbor_sample, homogeneous_neighbor_sample,
    is_bipartite, is_directed, is_multigraph, is_multipartite, is_weighted,
    multi_source_bfs, overlap_coefficient, shortest_path,
    sorensen_coefficient, symmetrize_ddf, symmetrize_df, to_numpy_array,
    to_numpy_matrix, to_pandas_adjacency, to_pandas_edgelist)
from cugraph_tpu_torch.api.graph import DiGraph, Graph, MultiGraph, Tree
from cugraph_tpu_torch.algos.centrality import (betweenness_centrality,
                                                degree_centrality,
                                                edge_betweenness_centrality,
                                                eigenvector_centrality,
                                                katz_centrality)
from cugraph_tpu_torch.algos.components import (
    connected_components, maximal_independent_set,
    strongly_connected_components, vertex_coloring,
    weakly_connected_components)
from cugraph_tpu_torch.algos.community import (
    analyzeClustering_edge_cut, analyzeClustering_modularity,
    analyzeClustering_ratio_cut, approx_weighted_matching,
    batched_ego_graphs, ecg, edge_triangle_count, egonet, k_truss, leiden,
    ktruss_subgraph, louvain, spectralBalancedCutClustering,
    spectralModularityMaximizationClustering, triangle_count)
from cugraph_tpu_torch.algos.cores import core_number, k_core
from cugraph_tpu_torch.algos.dag import topological_sort
from cugraph_tpu_torch.algos.layout import force_atlas2
from cugraph_tpu_torch.algos.linear_assignment import (dense_hungarian,
                                                       hungarian)
from cugraph_tpu_torch.algos.link_analysis import hits, pagerank
from cugraph_tpu_torch.algos.link_prediction import (
    all_pairs_cosine, all_pairs_jaccard, all_pairs_overlap,
    all_pairs_sorensen, cosine, jaccard, jaccard_coefficient, overlap,
    sorensen)
from cugraph_tpu_torch.algos.lookup import (EdgeIdLookupTable,
                                            edge_id_lookup_table)
from cugraph_tpu_torch.algos.sampling import (
    biased_random_walks, heterogeneous_biased_neighbor_sample,
    heterogeneous_biased_temporal_neighbor_sample,
    heterogeneous_uniform_neighbor_sample,
    heterogeneous_uniform_temporal_neighbor_sample,
    homogeneous_biased_neighbor_sample,
    homogeneous_biased_temporal_neighbor_sample,
    homogeneous_uniform_neighbor_sample,
    homogeneous_uniform_temporal_neighbor_sample, negative_sampling,
    node2vec, node2vec_random_walks, random_walks, uniform_neighbor_sample,
    uniform_random_walks)
from cugraph_tpu_torch.algos.sampling_post import (
    compress_per_hop_csr, heterogeneous_renumber_and_sort_sampled_edgelist,
    renumber_and_compress_sampled_edgelist, renumber_sampled_edgelist,
    sampling_results_to_batches)
from cugraph_tpu_torch.algos.structure import (
    count_multi_edges, decompress_to_edgelist, extract_vertex_list,
    hypergraph, in_weight_sums, induced_subgraph, k_hop_neighbors,
    out_weight_sums, renumber_arbitrary_edgelist, replicate_edgelist,
    select_random_vertices, subgraph, symmetrize, total_edge_weight,
    two_hop_neighbors)
from cugraph_tpu_torch.algos.traversal import (bfs, extract_bfs_paths,
                                               filter_unreachable,
                                               od_shortest_distances,
                                               shortest_path_length, sssp)
from cugraph_tpu_torch.algos.tree import (maximum_spanning_tree,
                                          minimum_spanning_tree)
from cugraph_tpu_torch import (datasets, experimental, generators, plc,
                               testing, utils)
from cugraph_tpu_torch.utils import ensure_cugraph_obj, import_optional
from cugraph_tpu_torch.kernels.dispatch import per_v_random_select
from cugraph_tpu_torch.generators.rmat import (generate_rmat_edgelist,
                                               generate_rmat_edgelists, rmat)

__all__ = [
    "BiPartiteGraph", "CugraphTpuError", "DiGraph", "EdgeIdLookupTable",
    "FailedToConvergeError", "Graph", "InvalidInputError", "MultiGraph",
    "NPartiteGraph", "Tree", "bfs_edges", "datasets", "ensure_cugraph_obj",
    "from_adjlist", "from_cudf_edgelist", "from_edgelist",
    "from_numpy_array", "from_numpy_matrix", "from_pandas_adjacency",
    "from_pandas_edgelist", "generators", "import_optional", "is_bipartite",
    "is_directed", "is_multigraph", "is_multipartite", "is_weighted",
    "plc", "shortest_path", "symmetrize_ddf", "symmetrize_df", "testing",
    "to_numpy_array", "to_numpy_matrix", "to_pandas_adjacency",
    "to_pandas_edgelist", "utils",
    "all_pairs_cosine", "all_pairs_jaccard", "all_pairs_overlap",
    "all_pairs_sorensen", "analyzeClustering_edge_cut",
    "analyzeClustering_modularity", "analyzeClustering_ratio_cut",
    "approx_weighted_matching", "batched_ego_graphs",
    "betweenness_centrality", "bfs", "biased_random_walks",
    "compress_per_hop_csr", "concurrent_bfs", "connected_components",
    "core_number", "cosine", "cosine_coefficient", "count_multi_edges",
    "decompress_to_edgelist", "degree_centrality", "dense_hungarian", "ecg",
    "edge_betweenness_centrality", "edge_id_lookup_table",
    "edge_triangle_count", "ego_graph", "egonet", "eigenvector_centrality",
    "exceptions", "experimental", "extract_bfs_paths", "extract_vertex_list",
    "filter_unreachable", "force_atlas2", "generate_rmat_edgelist",
    "generate_rmat_edgelists", "heterogeneous_biased_neighbor_sample",
    "heterogeneous_biased_temporal_neighbor_sample",
    "heterogeneous_neighbor_sample",
    "heterogeneous_renumber_and_sort_sampled_edgelist",
    "heterogeneous_uniform_neighbor_sample",
    "heterogeneous_uniform_temporal_neighbor_sample", "hits",
    "homogeneous_biased_neighbor_sample",
    "homogeneous_biased_temporal_neighbor_sample",
    "homogeneous_neighbor_sample", "homogeneous_uniform_neighbor_sample",
    "homogeneous_uniform_temporal_neighbor_sample", "hungarian", "hypergraph",
    "in_weight_sums", "induced_subgraph", "jaccard", "jaccard_coefficient",
    "k_core", "k_hop_neighbors", "k_truss", "katz_centrality",
    "ktruss_subgraph", "leiden", "louvain", "maximal_independent_set",
    "maximum_spanning_tree", "minimum_spanning_tree", "multi_source_bfs",
    "negative_sampling", "node2vec", "node2vec_random_walks",
    "od_shortest_distances", "out_weight_sums", "overlap",
    "overlap_coefficient", "pagerank", "per_v_random_select", "random_walks",
    "renumber_and_compress_sampled_edgelist", "renumber_arbitrary_edgelist",
    "renumber_sampled_edgelist", "replicate_edgelist", "rmat",
    "sampling_results_to_batches", "select_random_vertices",
    "shortest_path_length", "sorensen", "sorensen_coefficient",
    "spectralBalancedCutClustering",
    "spectralModularityMaximizationClustering", "sssp",
    "strongly_connected_components", "subgraph", "symmetrize",
    "topological_sort", "total_edge_weight", "triangle_count",
    "two_hop_neighbors", "uniform_neighbor_sample", "uniform_random_walks",
    "vertex_coloring", "weakly_connected_components",
]
