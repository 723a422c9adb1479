"""Plain full-batch GAT training, PyG's ogbn-products model, and the
comparison that decides the GAT cell's ``correct``.

The model is written out from the published description, as
``tests/plain_gat.py`` has it (this is the benchmark's copy of that
file's attention and layer): per layer h = x W, per head e(u→v) =
LeakyReLU(a_srcᵀ h[u] + a_dstᵀ h[v]) over the stored edges and one
explicit self-loop per vertex, α the softmax of e over v's edges, h'[v] =
Σ α h[u], the heads concatenated (hidden layers) or averaged (the last),
plus the bias, plus a skip x W_skip + b_skip; ELU between layers; the mean
softmax cross-entropy over the train vertices; torch's Adam written out.
It starts from the harness's initial weights and follows the program's
first ``steps`` steps.  The attention runs over blocks of edges with a
hand-written backward that recomputes each block, so that no [m, H, D]
tensor is made.

Precision: every sum over edges runs in float64; the activations, GEMMs
and the rest are float32 on the card (TF32 off) and float64 on the CPU.
Float64 activations do not fit the card: the saved [n, 512] activations
of the two hidden layers alone come to ~39 GB in float64, ~58 GB with the
backward's accumulators, and the blocks' gathers on top.

The numbers compared are those of ``sage_fullbatch.readings`` (the first
step's loss, each leaf's first-gradient and change norms, the first step's
logits), with this model's leaves.  The control is this reference with
every GEMM's operands rounded to TF32, the precision below the
configuration's.  The faults: the self-loops left out; one head's
coefficients made uniform (its logits zeroed) in the first layer; half of
the batch left out (every second train vertex), the mean over the rest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.graph import undirected
# the harness reads ``readings`` and the calibration ``detail`` from here
from portbench.reference.sage_fullbatch import (_Tf32Mm, detail,  # noqa: F401
                                                masked_cross_entropy,
                                                readings)

LEAVES = ("w", "a_src", "a_dst", "b", "skip_w", "skip_b")
BLOCK = 1 << 20  # edges a block


# -- the attention and the layer: tests/plain_gat.py's ----------------------

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


def gat_layer(p, x, src, dst, *, concat=True, slope=0.2, mm=torch.matmul,
              block=BLOCK, uniform_head=None):
    """One GATConv and its skip; ``uniform_head``, where given, zeroes that
    head's logits (a fault: its coefficients become uniform)."""
    heads, width = p["a_src"].shape
    n = x.shape[0]
    h = mm(x, p["w"]).view(n, heads, width)
    s = (h * p["a_src"]).sum(-1)
    t = (h * p["a_dst"]).sum(-1)
    if uniform_head is not None:
        keep = torch.ones(heads, dtype=s.dtype, device=s.device)
        keep[uniform_head] = 0.0
        s, t = s * keep, t * keep
    out = Attention.apply(h, s, t, src, dst, slope, block)
    out = out.reshape(n, heads * width) if concat else out.mean(dim=1)
    return out + p["b"] + mm(x, p["skip_w"]) + p["skip_b"]


# -- the steps ---------------------------------------------------------------

def train(inputs: dict, device, *, dtype=None, tf32_gemms=False,
          self_loops=None, uniform_head=None, mask=None) -> dict:
    """The first ``inputs['steps']`` steps from ``inputs['init']``: losses,
    first-gradient and change norms per leaf, and the first step's logits
    (rows in sorted external id order, ``rows``).  ``dtype`` None: float64
    on the CPU, float32 on the card; ``mask`` None: ``inputs['mask']``."""
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    # float32 GEMMs in full float32 (the control rounds its operands itself)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = torch.as_tensor(inputs["src"]).to(device)
    dst = torch.as_tensor(inputs["dst"]).to(device)
    ids, s, d = undirected(src, dst)
    del src, dst
    n = ids.numel()
    loops = inputs["self_loops"] if self_loops is None else self_loops
    if loops:
        s, d = with_self_loops(s, d, n)
    x = torch.as_tensor(inputs["x"]).to(device, dtype)
    if x.shape[0] != n:
        raise ValueError(f"features for {x.shape[0]} vertices, graph has {n}")
    labels = torch.as_tensor(inputs["labels"]).to(device, torch.int64)
    mask = torch.as_tensor(inputs["mask"] if mask is None else mask).to(
        device)
    params = [{k: torch.as_tensor(layer[k]).to(device, dtype).clone()
               .requires_grad_(True) for k in LEAVES}
              for layer in inputs["init"]]
    start = [{k: p[k].detach().clone() for k in LEAVES} for p in params]
    leaves = [(f"l{i}.{k}", p[k]) for i, p in enumerate(params)
              for k in LEAVES]
    mm = _Tf32Mm.apply if tf32_gemms else torch.matmul
    slope = inputs["slope"]

    def forward():
        h = x
        for i, p in enumerate(params):
            last = i + 1 == len(params)
            h = gat_layer(p, h, s, d, concat=inputs["concat_out"] or not last,
                          slope=slope, mm=mm,
                          uniform_head=uniform_head if i == 0 else None)
            if not last:
                h = F.elu(h, inplace=True)
        return h

    lr, (b1, b2), eps = inputs["lr"], inputs["betas"], inputs["eps"]
    m1 = [torch.zeros_like(t) for _, t in leaves]
    m2 = [torch.zeros_like(t) for _, t in leaves]
    out = {"losses": [], "rows": ids.cpu()}
    for step in range(1, inputs["steps"] + 1):
        logits = forward()
        loss = masked_cross_entropy(logits, labels, mask)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        if step == 1:
            out["logits"] = logits.detach().double()
            out["grad_norms"] = {name: float(torch.linalg.vector_norm(
                g.double())) for (name, _), g in zip(leaves, grads)}
        del logits
        out["losses"].append(loss.item())
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for (_, t), g, a, v in zip(leaves, grads, m1, m2):
                a.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                t.sub_(lr / bc1 * a / (v.sqrt() / bc2 ** 0.5 + eps))
        del grads
    out["change_norms"] = {
        f"l{i}.{k}": float(torch.linalg.vector_norm(
            (p[k].detach() - start[i][k]).double()))
        for i, p in enumerate(params) for k in LEAVES}
    return out


def reference(judged, device) -> dict:
    return train(judged["inputs"], device)


def program_outputs(judged) -> dict:
    return judged["outputs"]


def control_outputs(judged, device) -> dict:
    """The control in the program's place: float32 with TF32 GEMM
    operands."""
    return train(judged["inputs"], device, dtype=torch.float32,
                 tf32_gemms=True)


def fault_outputs(judged, device) -> dict:
    """The faults a GAT step can have on one card, planted in the reference
    put in the program's place: the self-loops left out of every softmax;
    the first layer's first head with uniform coefficients; half of the
    batch left out (every second train vertex), the mean over the rest.
    A step that leaves its state unchanged reads 1 on ``change_norm_gap``
    by definition."""
    inputs = judged["inputs"]
    half = torch.as_tensor(inputs["mask"]).clone()
    half[torch.nonzero(half)[1::2, 0]] = False
    return {"no_self_loops": train(inputs, device, self_loops=False),
            "uniform_head": train(inputs, device, uniform_head=0),
            "half_batch": train(inputs, device, mask=half)}
