"""The multi-device layer: a 2D edge partition over ``torch.distributed``.

Counterpart of ``cugraph_tpu.parallel``: the mesh, the partition, the
shard primitives, the vertex-program algorithms, the distributed GNN
layers and training, the shuffle and the sharded construction; the
sampler half (the one-hop engine, the fused samplers, the walks,
``mg_has_edge`` and ``sampling_mg``'s five neighbour samplers); and the
analytics: Louvain, Leiden and the contraction (``louvain``), ECG, the
similarity coefficients and all-pairs similarity, negative sampling, core
numbers and k-cores, vertex and edge betweenness, SCC, triangle counts,
k-truss, k-hop neighbours, egonets, induced subgraphs and two-hop
neighbours.  One process per device (torchrun style: NCCL between cards,
gloo between CPU processes); the caller initialises the process group and
builds the mesh with ``make_mesh_2d``.  Every function takes the mesh;
where the JAX package returns a global owner-sharded [pad_v] device array
a function here returns this rank's owned slice [Vc]
(``all_gather_vertex`` gives the global one), and where it returns host
arrays, tuples or frames every rank returns the same full host result.
The distributed edge-id lookup (``parallel.lookup``) and the compressed
minor cache (``parallel.kvcache``) are reached by their module paths, as
in the JAX package.  ``cugraph_tpu_torch`` does not import this package,
as ``cugraph_tpu`` does not import its own.

  reference / JAX                    here
  ---------------------------------- ----------------------------------------
  major_comm / minor_comm 2D grid    Mesh2D's column and row process groups
  update_edge_src_property (bcast)   all_gather_into_tensor on the row group
  device_reduce to vertex owner      reduce_scatter_tensor on the column group
  host_scalar_allreduce              all_reduce on the mesh's group
  partition_manager rank math        Partition2D (pure NumPy, the same copy)
"""

from cugraph_tpu_torch.parallel.algos import (
    MGDraws,
    all_gather_vertex,
    mg_all_pairs_similarity,
    mg_betweenness_centrality,
    mg_bfs,
    mg_biased_random_walks,
    mg_core_number,
    mg_cosine_coefficients,
    mg_degrees,
    mg_ecg,
    mg_edge_betweenness_centrality,
    mg_egonet,
    mg_eigenvector_centrality,
    mg_has_edge,
    mg_hits,
    mg_induced_subgraph,
    mg_jaccard_coefficients,
    mg_k_core,
    mg_k_hop_nbrs,
    mg_k_truss,
    mg_katz_centrality,
    mg_negative_sampling,
    mg_node2vec_random_walks,
    mg_overlap_coefficients,
    mg_pagerank,
    mg_sample_multihop_batched_device,
    mg_sample_multihop_device,
    mg_sample_one_hop,
    mg_sorensen_coefficients,
    mg_sssp,
    mg_strongly_connected_components,
    mg_triangle_count,
    mg_two_hop_neighbors,
    mg_uniform_random_walks,
    mg_wcc,
    sample_panel_rows,
)
from cugraph_tpu_torch.parallel.construct import (
    DistNumberMap,
    allgather_scalars,
    build_dist_graph_from_chunks,
    build_dist_graph_sharded,
    renumber_edgelist_sharded,
)
from cugraph_tpu_torch.parallel.mesh import (Mesh2D, make_mesh_2d,
                                             mesh_shape_for,
                                             shard_dist_graph)
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.louvain import (mg_leiden, mg_louvain,
                                                mg_louvain_move_phase)
from cugraph_tpu_torch.parallel.partition import (DistGraph, EdgeBlocks,
                                                  Partition2D, build_block,
                                                  build_dist_graph)
from cugraph_tpu_torch.parallel.sampling_mg import (
    mg_biased_neighbor_sample,
    mg_heterogeneous_neighbor_sample,
    mg_heterogeneous_temporal_neighbor_sample,
    mg_temporal_neighbor_sample,
    mg_uniform_neighbor_sample,
)
from cugraph_tpu_torch.parallel.shuffle import (shuffle_reduce_by_key,
                                                shuffle_to_owners)

# Reference-named aliases (cugraph.dask names each MG algorithm as the SG
# API does, python/cugraph/cugraph/dask/__init__.py:6-38); each takes
# (g: DistGraph, mesh, ...).
pagerank = mg_pagerank
bfs = mg_bfs
sssp = mg_sssp
hits = mg_hits
louvain = mg_louvain
leiden = mg_leiden
ecg = mg_ecg
triangle_count = mg_triangle_count
ego_graph = mg_egonet
induced_subgraph = mg_induced_subgraph
ktruss_subgraph = mg_k_truss
katz_centrality = mg_katz_centrality
eigenvector_centrality = mg_eigenvector_centrality
betweenness_centrality = mg_betweenness_centrality
edge_betweenness_centrality = mg_edge_betweenness_centrality
core_number = mg_core_number
k_core = mg_k_core
weakly_connected_components = mg_wcc
strongly_connected_components = mg_strongly_connected_components
uniform_random_walks = mg_uniform_random_walks
random_walks = mg_uniform_random_walks
biased_random_walks = mg_biased_random_walks
node2vec_random_walks = mg_node2vec_random_walks
jaccard = mg_jaccard_coefficients
sorensen = mg_sorensen_coefficients
overlap = mg_overlap_coefficients
cosine = mg_cosine_coefficients


def _make_all_pairs(kind):
    def all_pairs(g, mesh, vertices=None, topk=None, batch=128):
        return mg_all_pairs_similarity(g, mesh, kind=kind, vertices=vertices,
                                       topk=topk, batch=batch)
    all_pairs.__name__ = f"all_pairs_{kind}"
    all_pairs.__doc__ = (
        f"All-pairs {kind} similarity with optional global top-k "
        "(reference dask/link_prediction/*.py all_pairs_* entry points).")
    return all_pairs


all_pairs_jaccard = _make_all_pairs("jaccard")
all_pairs_sorensen = _make_all_pairs("sorensen")
all_pairs_overlap = _make_all_pairs("overlap")
all_pairs_cosine = _make_all_pairs("cosine")


def get_n_workers(mesh=None):
    """Ranks of the mesh, or of the default process group (the
    reference's dask ``get_n_workers`` counts dask workers)."""
    import torch.distributed as dist

    return mesh.size if mesh is not None else dist.get_world_size()


def get_chunksize(input_path, mesh=None):
    """Bytes per partition so a CSV read splits into one chunk per rank
    (reference common/read_utils.py:12)."""
    import math
    import os
    from glob import glob

    files = sorted(glob(str(input_path)))
    if len(files) == 1:
        return math.ceil(os.path.getsize(files[0]) / get_n_workers(mesh))
    return max(os.path.getsize(f) for f in files)
