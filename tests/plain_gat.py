"""Plain GAT, written out in plain torch from the published description:
the check that the port's ``nn.GAT`` and its kernel K6 are held to on the
CPU.  It imports nothing of the port.

GATConv (Veličković et al. 2018; PyG's ``GATConv``): h = x W, per head
e(u→v) = LeakyReLU(a_srcᵀ h[u] + a_dstᵀ h[v]), α the softmax of e over
v's in-edges (the self-loops among them where the model adds them, as
explicit edges), h'[v] = Σ_u α(u→v) h[u] per head, the heads concatenated
or averaged, then the bias.  The model (PyG's
``examples/ogbn_products_gat.py``): each layer's output plus a ``Linear``
skip of its input (where the model has skips), ELU between layers, raw
logits out; the loss is the mean softmax cross-entropy over the train
vertices, and Adam is written out as ``torch.optim.Adam`` computes it.

The attention runs over blocks of edges, with a hand-written backward that
recomputes each block, so that no [m, H, D] tensor is made.  Its sums over
edges run in float64 whatever the dtype of the activations; the caller
picks that dtype (float64 in the tests).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 1 << 19  # edges a block


def with_self_loops(src: torch.Tensor, dst: torch.Tensor, n: int):
    """The edge list with one explicit self-loop per vertex appended."""
    loops = torch.arange(n, dtype=src.dtype, device=src.device)
    return torch.cat([src, loops]), torch.cat([dst, loops])


def _leaky(z, slope):
    return torch.where(z > 0, z, slope * z)


def _leaky_grad(z, slope):
    """LeakyReLU's derivative in z's dtype (a ``torch.where`` over two
    Python floats would round the slope to float32)."""
    return torch.where(z > 0, torch.ones_like(z), slope)


def _blocks(num: int, block: int):
    return [(i, min(i + block, num)) for i in range(0, num, block)]


def _softmax_stats(s, t, src, dst, n, slope):
    """float64 per-edge logits' max and denominator per (vertex, head)."""
    z = s.double()[src] + t.double()[dst]
    e = _leaky(z, slope)
    mx = torch.full((n, s.shape[1]), -torch.inf, dtype=torch.float64,
                    device=s.device)
    mx.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
    den = torch.zeros_like(mx).index_add_(0, dst, torch.exp(e - mx[dst]))
    return mx, den


class Attention(torch.autograd.Function):
    """y[v, h] = Σ over edges (u, v) of α(u→v, h) x[u, h], α the softmax of
    LeakyReLU(s[u] + t[v]) over v's edges; a vertex with no edge gets 0."""

    @staticmethod
    def forward(ctx, x, s, t, src, dst, slope, block):
        n = x.shape[0]
        mx, den = _softmax_stats(s, t, src, dst, n, slope)
        y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
        for a, b in _blocks(src.numel(), block):
            u, v = src[a:b], dst[a:b]
            p = torch.exp(_leaky(s.double()[u] + t.double()[v], slope)
                          - mx[v]) / den[v]
            y.index_add_(0, v, p[:, :, None] * x[u].double())
        ctx.save_for_backward(x, s, t, src, dst, mx, den)
        ctx.slope, ctx.block = slope, block
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, s, t, src, dst, mx, den = ctx.saved_tensors
        slope = ctx.slope
        blocks = _blocks(src.numel(), ctx.block)

        def block_terms(a, b):
            u, v = src[a:b], dst[a:b]
            z = s.double()[u] + t.double()[v]
            alpha = torch.exp(_leaky(z, slope) - mx[v]) / den[v]
            dot = (dy[v].double() * x[u].double()).sum(-1)
            return u, v, z, alpha, dot

        delta = torch.zeros_like(mx)
        for a, b in blocks:
            _, v, _, alpha, dot = block_terms(a, b)
            delta.index_add_(0, v, alpha * dot)
        dx = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
        ds = torch.zeros_like(mx)
        dt = torch.zeros_like(mx)
        for a, b in blocks:
            u, v, z, alpha, dot = block_terms(a, b)
            dlogit = alpha * _leaky_grad(z, slope) * (dot - delta[v])
            ds.index_add_(0, u, dlogit)
            dt.index_add_(0, v, dlogit)
            dx.index_add_(0, u, alpha[:, :, None] * dy[v].double())
        return (dx.to(x.dtype), ds.to(s.dtype), dt.to(t.dtype), None, None,
                None, None)


def attention(x, s, t, src, dst, slope=0.2, block=BLOCK):
    return Attention.apply(x, s, t, src, dst, slope, block)


def gat_layer(p, x, src, dst, *, concat=True, slope=0.2, mm=torch.matmul,
              block=BLOCK):
    """One GATConv (and its skip, where ``p`` holds ``skip_w``): ``p`` in
    the JAX layout, w [in, H·D], a_src and a_dst [H, D], b [H·D] or [D]."""
    heads, width = p["a_src"].shape
    n = x.shape[0]
    h = mm(x, p["w"]).view(n, heads, width)
    s = (h * p["a_src"]).sum(-1)
    t = (h * p["a_dst"]).sum(-1)
    out = attention(h, s, t, src, dst, slope, block)
    out = out.reshape(n, heads * width) if concat else out.mean(dim=1)
    out = out + p["b"]
    if "skip_w" in p:
        out = out + mm(x, p["skip_w"]) + p["skip_b"]
    return out


def gat_model(params, x, src, dst, *, concat_out=True, slope=0.2,
              mm=torch.matmul, block=BLOCK):
    """The layers in turn, ELU between them; the last concatenates its
    heads or, where not ``concat_out``, averages them."""
    for i, p in enumerate(params):
        last = i + 1 == len(params)
        x = gat_layer(p, x, src, dst, concat=concat_out or not last,
                      slope=slope, mm=mm, block=block)
        if not last:
            x = F.elu(x)
    return x


def masked_cross_entropy(logits, labels, mask):
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def adam_steps(params, loss_fn, steps, lr, betas=(0.9, 0.999), eps=1e-8):
    """``steps`` Adam steps of ``loss_fn(params)`` on the leaves of
    ``params`` (a list of dicts), in place: (losses, the first step's
    gradients by (layer, key))."""
    leaves = [(i, k, t) for i, p in enumerate(params) for k, t in p.items()]
    m1 = [torch.zeros_like(t) for *_, t in leaves]
    m2 = [torch.zeros_like(t) for *_, t in leaves]
    b1, b2 = betas
    losses, first = [], None
    for step in range(1, steps + 1):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, [t for *_, t in leaves])
        if first is None:
            first = {(i, k): g for (i, k, _), g in zip(leaves, grads)}
        losses.append(loss.item())
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for (*_, t), g, a, v in zip(leaves, grads, m1, m2):
                a.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                t.sub_(lr / bc1 * a / (v.sqrt() / bc2 ** 0.5 + eps))
    return losses, first
