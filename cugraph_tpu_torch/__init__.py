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
- ``weakly_connected_components``, ``connected_components(connection=
  "weak")``: K2 (min, left) over int32 labels.

``shortest_path_length`` runs ``bfs`` or ``sssp``; ``filter_unreachable``
and ``extract_bfs_paths`` are host code over their frames.  Entry points
run on the card unless the caller passes ``device="cpu"``.  This package
imports neither JAX nor ``cugraph_tpu``.
"""

from cugraph_tpu_torch.api import exceptions
from cugraph_tpu_torch.api.exceptions import (CugraphTpuError,
                                              FailedToConvergeError,
                                              InvalidInputError)
from cugraph_tpu_torch.api.graph import DiGraph, Graph
from cugraph_tpu_torch.algos.components import (connected_components,
                                                weakly_connected_components)
from cugraph_tpu_torch.algos.link_analysis import hits, pagerank
from cugraph_tpu_torch.algos.traversal import (bfs, extract_bfs_paths,
                                               filter_unreachable,
                                               k_hop_neighbors,
                                               shortest_path_length, sssp)
from cugraph_tpu_torch.generators.rmat import (generate_rmat_edgelist,
                                               generate_rmat_edgelists, rmat)

__all__ = [
    "CugraphTpuError", "DiGraph", "FailedToConvergeError", "Graph",
    "InvalidInputError", "bfs", "connected_components", "exceptions",
    "extract_bfs_paths", "filter_unreachable", "generate_rmat_edgelist",
    "generate_rmat_edgelists", "hits", "k_hop_neighbors", "pagerank", "rmat",
    "shortest_path_length", "sssp", "weakly_connected_components",
]
