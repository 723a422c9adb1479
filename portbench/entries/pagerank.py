"""Entry: ``cugraph_tpu_torch.pagerank`` as a graph analyst calls it.

Set-up makes the configuration's edge list from the seed, builds the
undirected ``Graph`` and its structure, and warms up with the traffic's own
call (``warmup_calls`` of them).  Each call of the window returns the
pandas frame ['vertex', 'pagerank'] in external ids; the judge sees a
sample of those frames and the edge list.
"""

from __future__ import annotations

from portbench import kronecker
from portbench.entries import _graph


class Session:
    def __init__(self, ctx):
        from cugraph_tpu_torch import pagerank

        self._pagerank = pagerank
        self.kwargs = dict(ctx.traffic["call"])
        gen = kronecker.generator(ctx.seed, ctx.device)
        src, dst = _graph.edges(ctx.config, gen)
        self.stats = _graph.counts(src, dst)
        self.src, self.dst = src.cpu().numpy(), dst.cpu().numpy()
        del src, dst
        self.G, self.graph_build_s = _graph.build(ctx, self.src, self.dst)
        for _ in range(ctx.traffic.get("warmup_calls", 1)):
            self.call()
        ctx.sync()

    def call(self):
        out = self._pagerank(self.G, **self.kwargs)
        return out[0] if isinstance(out, tuple) else out

    counters = staticmethod(_graph.launch_counters)

    def judged(self, kept: list) -> dict:
        return {"src": self.src, "dst": self.dst, "call": self.kwargs,
                "frames": kept}

    def close(self) -> None:
        self.G = None


def setup(ctx) -> Session:
    return Session(ctx)
