"""The undirected simple graph of an edge list, worked out again in plain
torch: its vertices, its pairs and the stored (directed) edges, and a pull
sum over them in blocks.  Imports nothing of the system under test."""

from __future__ import annotations

import torch


def simple_pairs(src: torch.Tensor, dst: torch.Tensor):
    """(external ids sorted, a, b): every unordered pair {u, v} of the edge
    list once, a <= b, as int64 indices into the sorted ids."""
    ids, inverse = torch.unique(torch.cat([src, dst]), return_inverse=True)
    n = ids.numel()
    u, v = inverse[:src.numel()], inverse[src.numel():]
    key = torch.unique(torch.minimum(u, v) * n + torch.maximum(u, v))
    return ids, key // n, key % n


def undirected(src: torch.Tensor, dst: torch.Tensor):
    """(external ids sorted, s, d): the pairs stored both ways, a self-loop
    once."""
    ids, a, b = simple_pairs(src, dst)
    loop = a == b
    return ids, torch.cat([a, b[~loop]]), torch.cat([b, a[~loop]])


def pull_sum(s: torch.Tensor, d: torch.Tensor, x: torch.Tensor, n: int,
             block: int = 1 << 27) -> torch.Tensor:
    """y[v] = sum over stored edges (u, v) of x[u], in x's dtype, gathering
    at most ``block`` elements at a time."""
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    rows = max(1, block // max(1, x[0].numel()))
    for i in range(0, s.numel(), rows):
        y.index_add_(0, d[i:i + rows], x[s[i:i + rows]])
    return y


def positions(ids: torch.Tensor, external: torch.Tensor):
    """(index of each external id in the sorted ``ids``, whether it is
    there)."""
    pos = torch.searchsorted(ids, external).clamp(max=ids.numel() - 1)
    return pos, ids[pos] == external
