"""What every graph entry shares: the configuration's edge list, made on the
device from the seed, and the port's ``Graph`` built from it on the host
clock, with the port's launch counters."""

from __future__ import annotations

from portbench import kronecker
from portbench.reference.graph import simple_pairs


def edges(config: dict, gen):
    """(src, dst) int64 on the generator's device."""
    return kronecker.kronecker_edges(
        config["scale"], config["requested_edges"], gen,
        a=config["a"], b=config["b"], c=config["c"])


def counts(src, dst) -> dict:
    """The harness's own count of what the edge list holds: vertices,
    undirected pairs (each once) and stored edges (both ways)."""
    ids, a, b = simple_pairs(src, dst)
    loops = int((a == b).sum())
    return {"n": ids.numel(), "pairs": a.numel(),
            "stored_edges": 2 * a.numel() - loops}


def build(ctx, src_host, dst_host):
    """The port's undirected ``Graph`` and its structure on the device, and
    the seconds from the call of ``from_edgelist`` to the structure's
    synchronised end."""
    from cugraph_tpu_torch import Graph

    t = ctx.clock()
    G = Graph(directed=False, device=ctx.device).from_edgelist(src_host,
                                                               dst_host)
    G.structure
    ctx.sync()
    return G, ctx.clock() - t


def launch_counters() -> dict:
    """The port's kernel launch counters, flat."""
    from cugraph_tpu_torch.kernels import spmm, spmv

    out = {f"spmv.{k}": v for k, v in spmv.LAUNCHES_BY_COMBINE.items()}
    out.update({f"spmm.{k}": v for k, v in spmm.SPMM_LAUNCHES.items()})
    return out
