"""GNN layers and models (``nn.Module``s), the counterpart of
``cugraph_tpu.nn``'s layers and models.

Where the JAX package has an ``*_init``/``*_apply`` pair of pure
functions, the port has one module: ``sage_conv`` is ``SAGEConv``,
``graphsage_init``/``graphsage_apply`` is ``GraphSAGE``, and so on.
"sum" and "mean" aggregation runs the hand-written sum SpMM K4, with K4
over the transposed CSR as its backward.  ``nn/convert.py`` carries the
JAX package's parameter pytrees across.  The link-prediction and
minibatch modules of the JAX package follow the sampling slice.
"""

from cugraph_tpu_torch.nn.convert import (jax_params_from_state_dict,
                                          state_dict_from_jax)
from cugraph_tpu_torch.nn.layers import (GATConv, GATv2Conv, GCNConv,
                                         GINConv, SAGEConv,
                                         aggregate_neighbors,
                                         appnp_propagate)
from cugraph_tpu_torch.nn.models import (APPNP, GAT, GCN, GIN, GATv2,
                                         GraphSAGE, accuracy,
                                         make_train_step,
                                         masked_cross_entropy)

__all__ = [
    "APPNP", "GAT", "GATConv", "GATv2", "GATv2Conv", "GCN", "GCNConv",
    "GIN", "GINConv", "GraphSAGE", "SAGEConv", "accuracy",
    "aggregate_neighbors", "appnp_propagate", "jax_params_from_state_dict",
    "make_train_step", "masked_cross_entropy", "state_dict_from_jax",
]
