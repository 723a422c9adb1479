"""Graph generators (reference cpp/src/generators/)."""
from cugraph_tpu_torch.generators import rmat, simple
from cugraph_tpu_torch.generators.rmat import (generate_rmat_edgelist,
                                               generate_rmat_edgelists)
