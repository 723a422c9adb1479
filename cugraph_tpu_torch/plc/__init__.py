"""pylibcugraph-compatible stable layer of the port.

Counterpart of ``cugraph_tpu.plc``: the reference's L4 surface
(python/pylibcugraph/pylibcugraph/), a thin array adapter over the port's
engine:

* ``ResourceHandle``  — the device and mesh handle (the raft handle
  analog); ``None`` or ``ResourceHandle()`` means the card;
* ``GraphProperties`` — is_symmetric/is_multigraph flags;
* ``SGGraph``         — array-based graph construction on the handle's
  device;
* ``MGGraph``         — this rank's part of a graph over the handle's 2D
  mesh (``cugraph_tpu_torch.parallel``, one process per device);
* ``comms``           — the ``torch.distributed`` bootstrap
  (``cugraph_comms_init``, ``init_subcomms``);
* one function per algorithm, ``(resource_handle, graph, ...)``, returning
  host NumPy arrays (or the frames the JAX wrappers return), the work
  running on the graph's device through the top-level functions' kernels,
  or on the mesh through ``parallel.mg_*``.
"""

from cugraph_tpu_torch.plc.graphs import (
    GraphProperties,
    MGGraph,
    ResourceHandle,
    SGGraph,
)
from cugraph_tpu_torch.api import exceptions
from cugraph_tpu_torch.algos.lookup import EdgeIdLookupTable
from cugraph_tpu_torch.plc.algorithms import (
    CuGraphRandomState,
    ego_graph,
    get_two_hop_neighbors,
    pagerank,
    personalized_pagerank,
    bfs,
    sssp,
    hits,
    katz_centrality,
    eigenvector_centrality,
    betweenness_centrality,
    edge_betweenness_centrality,
    louvain,
    leiden,
    ecg,
    triangle_count,
    core_number,
    k_core,
    k_truss_subgraph,
    egonet,
    induced_subgraph,
    weakly_connected_components,
    strongly_connected_components,
    jaccard_coefficients,
    sorensen_coefficients,
    overlap_coefficients,
    cosine_coefficients,
    all_pairs_jaccard_coefficients,
    all_pairs_sorensen_coefficients,
    all_pairs_overlap_coefficients,
    all_pairs_cosine_coefficients,
    uniform_random_walks,
    biased_random_walks,
    node2vec_random_walks,
    uniform_neighbor_sample,
    homogeneous_uniform_neighbor_sample,
    homogeneous_biased_neighbor_sample,
    heterogeneous_uniform_neighbor_sample,
    heterogeneous_biased_neighbor_sample,
    homogeneous_uniform_temporal_neighbor_sample,
    homogeneous_biased_temporal_neighbor_sample,
    heterogeneous_uniform_temporal_neighbor_sample,
    heterogeneous_biased_temporal_neighbor_sample,
    negative_sampling,
    generate_rmat_edgelist,
    generate_rmat_edgelists,
    two_hop_neighbors,
    degrees,
    in_degrees,
    out_degrees,
    select_random_vertices,
    replicate_edgelist,
    decompress_to_edgelist,
    extract_vertex_list,
    has_vertex,
    count_multi_edges,
    renumber_arbitrary_edgelist,
    minimum_spanning_tree,
    balanced_cut_clustering,
    spectral_modularity_maximization,
    analyze_clustering_modularity,
    analyze_clustering_edge_cut,
    analyze_clustering_ratio_cut,
    force_atlas2,
    edge_id_lookup_table,
)
from cugraph_tpu_torch.plc import comms  # noqa: F401  (init_subcomms bootstrap)
from cugraph_tpu_torch.plc import internal_types  # noqa: F401
from cugraph_tpu_torch.plc.internal_types import (  # noqa: F401
    COO,
    EdgeIdLookupResult,
    SamplingResult,
)

__version__ = "0.1.0"


def _git_commit() -> str:
    """The checkout's commit, or "" where git cannot tell."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"],
                              capture_output=True, text=True, cwd=root,
                              timeout=5).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def __getattr__(name):
    # pylibcugraph exposes __git_commit__; resolved lazily (PEP 562): a
    # git subprocess at the first access, not at import
    if name == "__git_commit__":
        value = _git_commit()
        globals()["__git_commit__"] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
