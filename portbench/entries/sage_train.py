"""Entry: full-batch training steps of ``cugraph_tpu_torch.nn.GraphSAGE``
through ``make_train_step`` with ``torch.optim.Adam``.

Set-up makes, from the seed and in this order on the device: the edge
list, the features X [n, in_dim] N(0, 1) by sorted external id, labels
argmax(X R) for R [in_dim, out_dim] N(0, 1), the train vertices, and the
initial weights (Glorot uniform in [in, out], biases 0).  It builds the
``Graph``, lays the inputs out in the port's vertex order and loads the
weights into the model.  The steps the judge follows are the first of the
same step object that the window then drives: the first step's logits (a
forward hook), each step's loss, the first gradient from Adam's first
moment, and each leaf's change after the last judged step.
"""

from __future__ import annotations

import math

import torch

from portbench import kronecker
from portbench.entries import _graph
from portbench.reference.graph import positions
from portbench.reference.sage_fullbatch import LEAVES


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
    dims = [config["in_dim"]] + [config["hidden_dim"]] * (
        config["num_layers"] - 1) + [config["out_dim"]]
    init = []
    for a, b in zip(dims, dims[1:]):
        limit = math.sqrt(6.0 / (a + b))
        layer = {k: (torch.rand(a, b, generator=gen, device=dev) * 2 - 1)
                 * limit for k in ("w_self", "w_nbr")}
        layer["b"] = torch.zeros(b, device=dev)
        init.append(layer)
    return x, labels, mask, init


class Session:
    def __init__(self, ctx):
        from cugraph_tpu_torch.nn import GraphSAGE, make_train_step

        cfg = ctx.config
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
        self.model = GraphSAGE(cfg["in_dim"], cfg["hidden_dim"],
                               cfg["out_dim"], cfg["num_layers"],
                               device=ctx.device,
                               generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for layer, w in zip(self.model.layers, init):
                layer.w_self.weight.copy_(w["w_self"].T)
                layer.w_nbr.weight.copy_(w["w_nbr"].T)
                layer.b.copy_(w["b"])
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["lr"],
                                    betas=tuple(cfg["betas"]), eps=cfg["eps"])
        self.step = make_train_step(self.model, self.opt)
        self.outputs = self._judged_steps(ctx.workload["judged_steps"], rows)
        for _ in range(ctx.traffic.get("warmup_calls", 1)):
            self.call()
        ctx.sync()

    def _leaves(self):
        return [(f"l{i}.{k}", getattr(layer, k).weight if k != "b"
                 else layer.b)
                for i, layer in enumerate(self.model.layers) for k in LEAVES]

    def _judged_steps(self, steps: int, rows) -> dict:
        start = {k: p.detach().clone() for k, p in self._leaves()}
        seen = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: seen.append(out.detach().cpu()))
        losses = [self.call()]
        hook.remove()
        beta1 = self.opt.param_groups[0]["betas"][0]
        # a leaf the optimizer never saw has no moment: its gradient reads 0
        grads = {k: float(torch.linalg.vector_norm(self.opt.state.get(
            p, {}).get("exp_avg", torch.zeros(1)).double()) / (1 - beta1))
            for k, p in self._leaves()}
        losses += [self.call() for _ in range(steps - 1)]
        change = {k: float(torch.linalg.vector_norm(
            (p.detach() - start[k]).double())) for k, p in self._leaves()}
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change, "logits": seen[0],
                "rows": rows.cpu()}

    def call(self) -> float:
        return float(self.step(self.g, self.x, self.labels, self.mask))

    counters = staticmethod(_graph.launch_counters)

    def judged(self, kept: list) -> dict:
        return {"inputs": self.inputs, "outputs": self.outputs}

    def close(self) -> None:
        self.G = self.g = self.model = self.opt = self.step = None
        self.x = self.labels = self.mask = None


def setup(ctx) -> Session:
    return Session(ctx)
