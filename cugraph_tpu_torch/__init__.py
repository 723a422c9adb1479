"""cugraph_tpu_torch — the PyTorch and CUDA port of ``cugraph_tpu``.

The same public functions with the same arguments, returning the same
frames, over torch tensors on an NVIDIA card; the heavy steps run in
kernels written by hand for Hopper (``kernels/csrc``).  Entry points run on
the card unless the caller passes ``device="cpu"``.  This package imports
neither JAX nor ``cugraph_tpu``.
"""

from cugraph_tpu_torch.api import exceptions
from cugraph_tpu_torch.api.exceptions import (CugraphTpuError,
                                              FailedToConvergeError,
                                              InvalidInputError)
from cugraph_tpu_torch.api.graph import DiGraph, Graph
from cugraph_tpu_torch.algos.link_analysis import hits, pagerank
from cugraph_tpu_torch.generators.rmat import (generate_rmat_edgelist,
                                               generate_rmat_edgelists, rmat)

__all__ = [
    "CugraphTpuError", "DiGraph", "FailedToConvergeError", "Graph",
    "InvalidInputError", "exceptions", "generate_rmat_edgelist",
    "generate_rmat_edgelists", "hits", "pagerank", "rmat",
]
