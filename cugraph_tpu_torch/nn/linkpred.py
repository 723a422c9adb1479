"""Link-prediction heads and training utilities.

Counterpart of ``cugraph_tpu.nn.linkpred`` (reference feed path:
cpp/src/sampling/negative_sampling_impl.cuh:270,
readme_pages/gnn_support.md): a GNN encoder gives vertex embeddings, a
decoder scores (src, dst) pairs, and the loss contrasts observed edges
with sampled non-edges.  Each decoder is a plain function over the JAX
package's parameter dict and an ``nn.Module`` (``DotDecoder``,
``MLPDecoder``, ``DistMultDecoder``) whose forward calls it;
``nn/convert.py`` carries the JAX package's decoder parameters across.  ``torch.optim.Adam`` takes optax's place in
``make_linkpred_train_step``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cugraph_tpu_torch.algos.sampling import negative_sampling
from cugraph_tpu_torch.core.structure import resolve_device
from cugraph_tpu_torch.nn.layers import (_MLP, _JaxLeaves, _linear, _mlp2,
                                         params_of)
from cugraph_tpu_torch.nn.models import functional_step


def _ends(z, src, dst):
    return z[src.to(torch.int64)], z[dst.to(torch.int64)]


# ---------------------------------------------------------------------------
# decoders: embeddings [V, F] + pair (src, dst) -> score logits [P]
# ---------------------------------------------------------------------------

def dot_decoder(z: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """score = <z[src], z[dst]> (parameter-free)."""
    zs, zd = _ends(z, src, dst)
    return torch.sum(zs * zd, dim=-1)


def mlp_decoder(params, z: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """2-layer MLP over concatenated endpoint embeddings; ``params`` is the
    JAX package's dict (``w1`` [2·in, hidden], ``b1``, ``w2`` [hidden, 1],
    ``b2``)."""
    return _mlp2(params, torch.cat(_ends(z, src, dst), dim=-1))[:, 0]


def distmult_decoder(params, z: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor,
                     rel: torch.Tensor | None = None) -> torch.Tensor:
    """score = <z[src], r * z[dst]> with a per-relation diagonal r
    (DistMult), ``params["rel"]`` [num_relations, in]; ``rel`` defaults to
    relation 0 for homogeneous graphs."""
    r = params["rel"][torch.zeros_like(src, dtype=torch.int64) if rel is None
                      else rel.to(torch.int64)]
    zs, zd = _ends(z, src, dst)
    return torch.sum(zs * r * zd, dim=-1)


class DotDecoder(nn.Module):
    def forward(self, z, src, dst):
        return dot_decoder(z, src, dst)


class MLPDecoder(_JaxLeaves, nn.Module):
    """``mlp_decoder`` with its weights: Glorot from ``generator``, zero
    biases (JAX mlp_decoder_init)."""

    JAX_LEAVES = _MLP

    def __init__(self, in_dim: int, hidden_dim: int = 64, *,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.w1 = _linear(2 * in_dim, hidden_dim, generator, device,
                          bias=True)
        self.w2 = _linear(hidden_dim, 1, generator, device, bias=True)

    def forward(self, z, src, dst):
        return mlp_decoder(self.jax_params(), z, src, dst)


class DistMultDecoder(_JaxLeaves, nn.Module):
    """``distmult_decoder`` with ``rel`` [num_relations, in], N(0, 0.1²)
    from ``generator`` (JAX distmult_decoder_init)."""

    JAX_LEAVES = (("rel", "rel"),)

    def __init__(self, in_dim: int, num_relations: int = 1, *,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        rel = torch.randn((num_relations, in_dim), generator=generator) * 0.1
        self.rel = nn.Parameter(rel.to(device))

    def forward(self, z, src, dst, rel=None):
        return distmult_decoder(self.jax_params(), z, src, dst, rel)


def mlp_decoder_init(generator, in_dim: int, hidden_dim: int = 64, *,
                     device=None):
    """``MLPDecoder``'s initial weights as the JAX dict (``generator`` in
    place of the JAX key; ``device`` None means the card)."""
    return params_of(MLPDecoder(in_dim, hidden_dim, generator=generator,
                                  device=device))


def distmult_decoder_init(generator, in_dim: int, num_relations: int = 1, *,
                          device=None):
    return params_of(DistMultDecoder(in_dim, num_relations,
                                       generator=generator, device=device))


# ---------------------------------------------------------------------------
# loss + metrics
# ---------------------------------------------------------------------------

def link_prediction_loss(pos_logits: torch.Tensor,
                         neg_logits: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits: positives -> 1, negatives -> 0."""
    pos = torch.mean(F.softplus(-pos_logits))
    neg = torch.mean(F.softplus(neg_logits))
    return 0.5 * (pos + neg)


def roc_auc(pos_logits: torch.Tensor,
            neg_logits: torch.Tensor) -> torch.Tensor:
    """Exact AUC by the rank-sum (Mann-Whitney U) statistic with one sort;
    ties get their average rank (midrank), as
    sklearn.metrics.roc_auc_score."""
    n_pos, n_neg = pos_logits.shape[0], neg_logits.shape[0]
    scores = torch.cat([pos_logits, neg_logits])
    labels = torch.cat([torch.ones_like(pos_logits),
                        torch.zeros_like(neg_logits)])
    order = torch.argsort(scores, stable=True)
    s_sorted, l_sorted = scores[order], labels[order]
    n = n_pos + n_neg
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)
    new_run = torch.ones(n, dtype=torch.bool, device=scores.device)
    new_run[1:] = s_sorted[1:] != s_sorted[:-1]
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    # the tie runs are contiguous after the stable sort: their rank sums
    # in a fixed order (float32 sums of integers stop being exact past
    # 2^24, so the order would show there)
    lengths = torch.bincount(run_id, minlength=n)
    run_sum = torch.segment_reduce(ranks, "sum", lengths=lengths)
    run_cnt = lengths.to(ranks.dtype)
    midrank = run_sum[run_id] / torch.clamp(run_cnt[run_id], min=1.0)
    u = torch.sum(midrank * l_sorted) - n_pos * (n_pos + 1) / 2.0
    return u / max(n_pos * n_neg, 1)


def hits_at_k(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
              k: int) -> torch.Tensor:
    """Fraction of positives scoring above the k-th best negative (the OGB
    linkproppred convention)."""
    kk = min(int(k), int(neg_logits.shape[0]))
    thresh = torch.topk(neg_logits, kk).values[-1]
    return torch.mean((pos_logits > thresh).to(torch.float32))


# ---------------------------------------------------------------------------
# end-to-end training
# ---------------------------------------------------------------------------

def make_linkpred_train_step(encoder, decoder, optimizer):
    """For an encoder ``nn.Module``: ``step(g, x, pos_src, pos_dst,
    neg_src, neg_dst)``, which zeroes the gradients, embeds with
    ``encoder(g, x)``, scores both pair sets with ``decoder``
    (``dot_decoder`` or a decoder module), takes the link-prediction loss,
    runs backward and ``optimizer.step()``, and returns the loss (a 0-d
    tensor).  The optimizer holds the encoder's and the decoder's
    parameters.

    For an encoder apply function (``graphsage_apply`` ...) and a
    ``torch.optim`` factory: the JAX package's ``step(params, opt_state,
    g, x, pos_src, pos_dst, neg_src, neg_dst) -> (params, opt_state,
    loss)`` over ``params = {"encoder": ..., "decoder": ...}``, the
    decoder ``dot_decoder`` (no "decoder" entry needed) or a decoder
    function (``mlp_decoder``, ``distmult_decoder``) of
    ``params["decoder"]``.  Negatives come from ``sample_negatives``
    outside the step."""
    if not isinstance(encoder, nn.Module):
        def score(params, z, src, dst):
            if decoder is dot_decoder:
                return dot_decoder(z, src, dst)
            return decoder(params.get("decoder", {}), z, src, dst)

        def loss_fn(params, g, x, pos_src, pos_dst, neg_src, neg_dst):
            z = encoder(params["encoder"], g, x)
            return link_prediction_loss(score(params, z, pos_src, pos_dst),
                                        score(params, z, neg_src, neg_dst))

        return functional_step(loss_fn, optimizer)

    def train_step(g, x, pos_src, pos_dst, neg_src, neg_dst):
        optimizer.zero_grad()
        z = encoder(g, x)
        loss = link_prediction_loss(decoder(z, pos_src, pos_dst),
                                    decoder(z, neg_src, neg_dst))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def sample_negatives(G, num_samples: int, random_state: int = 0,
                     degree_biased: bool = False):
    """Negative pairs for training loops through ``negative_sampling``:
    (src, dst) int32 tensors of internal ids on G's device.  Uniform
    endpoint draws by default; ``degree_biased=True`` weights endpoints by
    degree like the reference's typical GNN usage.  The bias is taken in
    ``G.nodes()`` order, the order ``negative_sampling`` pairs it with
    (``G.degree()`` lists vertices in that order); the JAX package sorts
    it by external id first, which gives a renumbered vertex another
    vertex's degree."""
    kw = {}
    if degree_biased:
        deg = G.degree()["degree"].to_numpy(np.float64)
        kw = dict(src_bias=deg, dst_bias=deg)
    df = negative_sampling(G, num_samples=num_samples,
                           random_state=random_state, **kw)
    src = np.asarray(G.lookup_internal_vertex_id(np.asarray(df["src"])),
                     np.int32)
    dst = np.asarray(G.lookup_internal_vertex_id(np.asarray(df["dst"])),
                     np.int32)
    return (torch.as_tensor(src, device=G.device),
            torch.as_tensor(dst, device=G.device))
