"""The multi-device layer: a 2D edge partition over ``torch.distributed``.

Counterpart of ``cugraph_tpu.parallel``'s core: the mesh, the partition,
the shard primitives, the vertex-program algorithms, the distributed GNN
layers and training, the shuffle and the sharded construction; and its
sampler half: the one-hop engine, the fused samplers, the walks,
``mg_has_edge`` and ``sampling_mg``'s five neighbour samplers.  One
process per device (torchrun style: NCCL between cards, gloo between CPU
processes); the caller initialises the process group and builds the mesh
with ``make_mesh_2d``.  Every function takes the mesh and returns this
rank's part: owned vertex slices [Vc] where the JAX package returns
global owner-sharded [pad_v] arrays (``all_gather_vertex`` gives those).
The JAX package's other MG modules (community, similarity,
betweenness, triangles, negative sampling, ``louvain``, ``lookup``,
``kvcache``) have no counterpart yet.  ``cugraph_tpu_torch`` does not
import this package, as ``cugraph_tpu`` does not import its own.

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
    mg_bfs,
    mg_biased_random_walks,
    mg_degrees,
    mg_eigenvector_centrality,
    mg_has_edge,
    mg_hits,
    mg_katz_centrality,
    mg_node2vec_random_walks,
    mg_pagerank,
    mg_sample_multihop_batched_device,
    mg_sample_multihop_device,
    mg_sample_one_hop,
    mg_sssp,
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
katz_centrality = mg_katz_centrality
eigenvector_centrality = mg_eigenvector_centrality
weakly_connected_components = mg_wcc
uniform_random_walks = mg_uniform_random_walks
random_walks = mg_uniform_random_walks
biased_random_walks = mg_biased_random_walks
node2vec_random_walks = mg_node2vec_random_walks


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
