"""Entry: full-batch training steps of ``cugraph_tpu_torch.nn.GAT`` as
PyG's ogbn-products example builds it (skips, four averaged output heads,
self-loops) through ``make_train_step`` with ``torch.optim.Adam``.

The model is built first, so that a program without these options fails
at once.  Set-up then makes, from the seed and in this order on the
device, what ``sage_train`` makes (the edge list, X, the labels, the train
vertices) and the initial weights: per layer W [in, H·D], a_src and a_dst
[H, D], the skip's weight [in, out], all Glorot uniform over the JAX
layout's fans, and the biases 0.  The steps the judge follows are the
first of the same step object that the window then drives, read as
``sage_train`` reads them.
"""

from __future__ import annotations

import math

import torch

from portbench import kronecker
from portbench.entries import _graph
from portbench.reference.gat_fullbatch import LEAVES
from portbench.reference.graph import positions
from portbench.roofline_gat import gat_layers


def _glorot(shape, gen):
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(*shape, generator=gen, device=gen.device) * 2 - 1) \
        * limit


def _inputs(config: dict, gen, ids):
    dev = gen.device
    n = ids.numel()
    x = torch.randn(n, config["in_dim"], generator=gen, device=dev)
    rule = torch.randn(config["in_dim"], config["out_dim"], generator=gen,
                       device=dev)
    labels = torch.argmax(x @ rule, dim=1)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.randperm(n, generator=gen, device=dev)[
        :config["train_vertices"]]] = True
    init = []
    for fan_in, heads, width, out in gat_layers(config):
        init.append({"w": _glorot((fan_in, heads * width), gen),
                     "a_src": _glorot((heads, width), gen),
                     "a_dst": _glorot((heads, width), gen),
                     "b": torch.zeros(out, device=dev),
                     "skip_w": _glorot((fan_in, out), gen),
                     "skip_b": torch.zeros(out, device=dev)})
    return x, labels, mask, init


def _leaf_tensors(model):
    """(name, tensor) of every leaf, named as the reference names them."""
    out = []
    for i, (conv, skip) in enumerate(zip(model.layers, model.skips)):
        held = {"w": conv.w.weight, "a_src": conv.a_src, "a_dst": conv.a_dst,
                "b": conv.b, "skip_w": skip.weight, "skip_b": skip.bias}
        out += [(f"l{i}.{k}", held[k]) for k in LEAVES]
    return out


class Session:
    def __init__(self, ctx):
        from cugraph_tpu_torch.nn import GAT, make_train_step

        cfg = ctx.config
        self.model = GAT(cfg["in_dim"], cfg["hidden_dim"], cfg["out_dim"],
                         cfg["num_layers"], num_heads=cfg["num_heads"],
                         skip=cfg["skip"], out_heads=cfg["out_heads"],
                         concat_out=cfg["concat_out"],
                         add_self_loops=cfg["add_self_loops"],
                         device=ctx.device,
                         generator=torch.Generator().manual_seed(0))
        gen = kronecker.generator(ctx.seed, ctx.device)
        src, dst = _graph.edges(cfg, gen)
        self.stats = _graph.counts(src, dst)
        ids = torch.unique(torch.cat([src, dst]))
        x, labels, mask, init = _inputs(cfg, gen, ids)
        self.inputs = {
            "src": src.cpu().numpy(), "dst": dst.cpu().numpy(),
            "x": x.cpu(), "labels": labels.cpu(), "mask": mask.cpu(),
            "init": [{k: t.cpu() for k, t in layer.items()}
                     for layer in init],
            "concat_out": cfg["concat_out"],
            "self_loops": cfg["add_self_loops"],
            "slope": cfg["negative_slope"],
            "lr": cfg["lr"], "betas": tuple(cfg["betas"]), "eps": cfg["eps"],
            "steps": ctx.workload["judged_steps"]}
        del src, dst
        self.G, self.graph_build_s = _graph.build(
            ctx, self.inputs["src"], self.inputs["dst"])
        self.g = self.G.structure
        rows = torch.as_tensor(self.G.nodes()).to(ctx.device)
        pos, _ = positions(ids, rows)
        self.x, self.labels, self.mask = x[pos], labels[pos], mask[pos]
        del x, labels, mask, ids, pos
        with torch.no_grad():
            for (_, p), (k, w) in zip(_leaf_tensors(self.model),
                                      ((k, layer[k]) for layer in init
                                       for k in LEAVES)):
                # a Linear keeps [out, in], the JAX layout's transpose
                p.copy_(w.T if k in ("w", "skip_w") else w)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["lr"],
                                    betas=tuple(cfg["betas"]), eps=cfg["eps"])
        self.step = make_train_step(self.model, self.opt)
        self.outputs = self._judged_steps(ctx.workload["judged_steps"], rows)
        for _ in range(ctx.traffic.get("warmup_calls", 1)):
            self.call()
        ctx.sync()

    def _judged_steps(self, steps: int, rows) -> dict:
        leaves = _leaf_tensors(self.model)
        start = {k: p.detach().clone() for k, p in leaves}
        seen = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: seen.append(out.detach().cpu()))
        losses = [self.call()]
        hook.remove()
        beta1 = self.opt.param_groups[0]["betas"][0]
        # a leaf the optimizer never saw has no moment: its gradient reads 0
        grads = {k: float(torch.linalg.vector_norm(self.opt.state.get(
            p, {}).get("exp_avg", torch.zeros(1)).double()) / (1 - beta1))
            for k, p in leaves}
        losses += [self.call() for _ in range(steps - 1)]
        change = {k: float(torch.linalg.vector_norm(
            (p.detach() - start[k]).double())) for k, p in leaves}
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change, "logits": seen[0],
                "rows": rows.cpu()}

    def call(self) -> float:
        return float(self.step(self.g, self.x, self.labels, self.mask))

    @staticmethod
    def counters() -> dict:
        """The spmv and spmm launch counters, and K6's as ``gat.*``."""
        from cugraph_tpu_torch.kernels import gat

        out = _graph.launch_counters()
        out.update({f"gat.{k}": v for k, v in gat.GAT_LAUNCHES.items()})
        return out

    def judged(self, kept: list) -> dict:
        return {"inputs": self.inputs, "outputs": self.outputs}

    def close(self) -> None:
        self.G = self.g = self.model = self.opt = self.step = None
        self.x = self.labels = self.mask = None


def setup(ctx) -> Session:
    return Session(ctx)
