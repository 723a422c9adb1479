"""Entry: ``cugraph_tpu_torch.betweenness_centrality`` with sampled
sources, as cuGraph's users call it (``k`` a list of vertices).

Set-up makes the configuration's edge list from the seed, builds the
undirected ``Graph`` and its structure, and warms up with the traffic's own
call.  Each call draws ``k`` vertex ids uniformly without replacement from
the sorted external ids (numpy's generator seeded with the run's seed, so
that a program's vertex order never moves the draw) and returns (those
ids, the frame ['vertex', 'betweenness_centrality']); the judge sees a
sample of those and the edge list.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import kronecker
from portbench.entries import _graph


class Session:
    def __init__(self, ctx):
        from cugraph_tpu_torch import betweenness_centrality

        self._bc = betweenness_centrality
        self.kwargs = dict(ctx.traffic["call"])
        self.k = self.kwargs.pop("k")
        self.rng = np.random.default_rng(ctx.seed)
        gen = kronecker.generator(ctx.seed, ctx.device)
        src, dst = _graph.edges(ctx.config, gen)
        self.stats = _graph.counts(src, dst)
        self.ids = torch.unique(torch.cat([src, dst])).cpu().numpy()
        self.src, self.dst = src.cpu().numpy(), dst.cpu().numpy()
        del src, dst
        self.G, self.graph_build_s = _graph.build(ctx, self.src, self.dst)
        for _ in range(ctx.traffic.get("warmup_calls", 1)):
            self.call()
        ctx.sync()

    def call(self):
        sources = self.ids[self.rng.choice(self.ids.size, size=self.k,
                                           replace=False)]
        return sources, self._bc(self.G, k=sources, **self.kwargs)

    counters = staticmethod(_graph.launch_counters)

    def judged(self, kept: list) -> dict:
        return {"src": self.src, "dst": self.dst, "call": self.kwargs,
                "frames": kept}

    def close(self) -> None:
        self.G = None


def setup(ctx) -> Session:
    return Session(ctx)
