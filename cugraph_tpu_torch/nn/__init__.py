"""GNN layers and models, the counterpart of ``cugraph_tpu.nn``.

Each layer and model is both a pure function over the JAX package's
parameter pytree (``sage_init``/``sage_conv``,
``graphsage_init``/``graphsage_apply`` ...: dicts of tensors, dense
weights [in, out]; ``*_init`` takes a ``torch.Generator`` and a
``device`` where JAX takes a key) and an ``nn.Module`` (``SAGEConv``,
``GraphSAGE`` ...) whose ``forward`` calls that function on its own
weights.  "sum" and "mean" aggregation runs the hand-written sum SpMM K4,
with K4 over the transposed CSR as its backward.  ``make_train_step`` and
``make_linkpred_train_step`` take a module and a ``torch.optim``
optimizer, or an apply function and a ``torch.optim`` factory (the JAX
step's signature).  ``nn/convert.py`` carries the JAX package's parameter
pytrees across.  ``nn/minibatch.py`` trains on sampled neighbourhoods
(``make_batches``), and ``nn/linkpred.py`` holds the link-prediction
decoders, loss, metrics and training step.
"""

from cugraph_tpu_torch.nn.convert import (jax_params_from_state_dict,
                                          state_dict_from_jax)
from cugraph_tpu_torch.nn.layers import (GATConv, GATv2Conv, GCNConv,
                                         GINConv, SAGEConv,
                                         aggregate_neighbors,
                                         appnp_propagate, gat_conv, gat_init,
                                         gatv2_conv, gatv2_init, gcn_conv,
                                         gcn_init, gin_conv, gin_init,
                                         sage_conv, sage_init)
from cugraph_tpu_torch.nn.linkpred import (DistMultDecoder, DotDecoder,
                                           MLPDecoder, distmult_decoder,
                                           distmult_decoder_init,
                                           dot_decoder, hits_at_k,
                                           link_prediction_loss,
                                           make_linkpred_train_step,
                                           mlp_decoder, mlp_decoder_init,
                                           roc_auc, sample_negatives)
from cugraph_tpu_torch.nn.minibatch import (SampledBatch,
                                            batch_from_sampling,
                                            make_batches,
                                            sage_minibatch_forward)
from cugraph_tpu_torch.nn.models import (APPNP, GAT, GCN, GIN, GATv2,
                                         GraphSAGE, accuracy, appnp_apply,
                                         appnp_init, gat_apply, gatv2_apply,
                                         gatv2_model_init, gcn_apply,
                                         gin_apply, gin_model_init,
                                         graphsage_apply, graphsage_init,
                                         make_train_step,
                                         masked_cross_entropy)
# the model inits under the names cugraph_tpu.nn gives them, beside the
# layer inits gcn_init and gat_init
from cugraph_tpu_torch.nn.models import gat_init as gat_model_init
from cugraph_tpu_torch.nn.models import gcn_init as gcn_model_init

__all__ = [
    "APPNP", "DistMultDecoder", "DotDecoder", "GAT", "GATConv", "GATv2",
    "GATv2Conv", "GCN", "GCNConv", "GIN", "GINConv", "GraphSAGE",
    "MLPDecoder", "SAGEConv", "SampledBatch", "accuracy",
    "aggregate_neighbors", "appnp_apply", "appnp_init", "appnp_propagate",
    "batch_from_sampling", "distmult_decoder", "distmult_decoder_init",
    "dot_decoder", "gat_apply", "gat_conv", "gat_init", "gat_model_init",
    "gatv2_apply", "gatv2_conv", "gatv2_init", "gatv2_model_init",
    "gcn_apply", "gcn_conv", "gcn_init", "gcn_model_init", "gin_apply",
    "gin_conv", "gin_init", "gin_model_init", "graphsage_apply",
    "graphsage_init", "hits_at_k", "jax_params_from_state_dict",
    "link_prediction_loss", "make_batches", "make_linkpred_train_step",
    "make_train_step", "masked_cross_entropy", "mlp_decoder",
    "mlp_decoder_init", "roc_auc", "sage_conv", "sage_init",
    "sage_minibatch_forward", "sample_negatives", "state_dict_from_jax",
]
