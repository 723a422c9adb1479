"""GNN layers and models (``nn.Module``s), the counterpart of
``cugraph_tpu.nn``'s layers and models.

Where the JAX package has an ``*_init``/``*_apply`` pair of pure
functions, the port has one module: ``sage_conv`` is ``SAGEConv``,
``graphsage_init``/``graphsage_apply`` is ``GraphSAGE``, and so on.
"sum" and "mean" aggregation runs the hand-written sum SpMM K4, with K4
over the transposed CSR as its backward.  ``nn/convert.py`` carries the
JAX package's parameter pytrees across.  ``nn/minibatch.py`` trains on
sampled neighbourhoods (``make_batches``), and ``nn/linkpred.py`` holds the
link-prediction decoders, loss, metrics and training step.
"""

from cugraph_tpu_torch.nn.convert import (jax_params_from_state_dict,
                                          state_dict_from_jax)
from cugraph_tpu_torch.nn.layers import (GATConv, GATv2Conv, GCNConv,
                                         GINConv, SAGEConv,
                                         aggregate_neighbors,
                                         appnp_propagate)
from cugraph_tpu_torch.nn.linkpred import (DistMultDecoder, DotDecoder,
                                           MLPDecoder, distmult_decoder,
                                           dot_decoder, hits_at_k,
                                           link_prediction_loss,
                                           make_linkpred_train_step,
                                           mlp_decoder, roc_auc,
                                           sample_negatives)
from cugraph_tpu_torch.nn.minibatch import (SampledBatch,
                                            batch_from_sampling,
                                            make_batches,
                                            sage_minibatch_forward)
from cugraph_tpu_torch.nn.models import (APPNP, GAT, GCN, GIN, GATv2,
                                         GraphSAGE, accuracy,
                                         make_train_step,
                                         masked_cross_entropy)

__all__ = [
    "APPNP", "DistMultDecoder", "DotDecoder", "GAT", "GATConv", "GATv2",
    "GATv2Conv", "GCN", "GCNConv", "GIN", "GINConv", "GraphSAGE",
    "MLPDecoder", "SAGEConv", "SampledBatch", "accuracy",
    "aggregate_neighbors", "appnp_propagate", "batch_from_sampling",
    "distmult_decoder", "dot_decoder", "hits_at_k",
    "jax_params_from_state_dict", "link_prediction_loss", "make_batches",
    "make_linkpred_train_step", "make_train_step", "masked_cross_entropy",
    "mlp_decoder", "roc_auc", "sage_minibatch_forward", "sample_negatives",
    "state_dict_from_jax",
]
