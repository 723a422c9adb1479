"""Linear assignment on dense cost matrices and weighted bipartite graphs.

Counterpart of ``cugraph_tpu.algos.linear_assignment`` (reference legacy
cpp/src/linear_assignment/legacy/hungarian.cu, raft::lap;
python/cugraph/cugraph/linear_assignment/lap.py).  Bertsekas' auction with
ε-scaling on the graph's device in float32: each round every unassigned
bidder takes its best and second-best value over its whole row of the
dense [N, N] benefit, and the highest bid on each object wins, ties to the
smallest bidder.  ``jax.lax.top_k`` takes the lowest index among equal
values and ``torch.topk`` promises no order among ties, so the best object
is ``argmax`` (the first maximum) and the second-best value the maximum
with that one index masked.  One host sync per round (the assigned count).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

_NEG_BID = -3e38
_ROUNDS_PER_BIDDER = 50  # each ε phase stops after 50·N rounds


def _auction_round(benefit, price, owner, eps):
    """One synchronous round over benefit [N, N] (maximized), price [N]
    float32 and owner [N] int64 (object -> bidder, or -1); ``eps`` a
    float32 0-d tensor.  Returns the new (price, owner)."""
    N = benefit.shape[0]
    dev = benefit.device
    # unowned objects mark the spare slot N
    assigned = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    assigned[torch.where(owner >= 0, owner, N)] = True
    unassigned = ~assigned[:N]

    value = benefit - price[None, :]
    best_obj = torch.argmax(value, dim=1)
    best_v = value.gather(1, best_obj[:, None])
    second_v = value.scatter(1, best_obj[:, None], float("-inf")).amax(1)
    bid_amount = price[best_obj] + (best_v[:, 0] - second_v) + eps

    # the highest bid on each object wins; bidders that bid nothing go to
    # the spare slot N
    bids = torch.where(unassigned, bid_amount,
                       torch.full_like(bid_amount, _NEG_BID))
    obj = torch.where(unassigned, best_obj, N)
    best_bid = torch.full((N + 1,), float("-inf"), device=dev).scatter_reduce_(
        0, obj, bids, "amax")[:N]
    cand = unassigned & (bids >= best_bid[obj.clamp(max=N - 1)])
    big = torch.iinfo(torch.int64).max
    bidder = torch.arange(N, device=dev)
    win = torch.full((N + 1,), big, dtype=torch.int64,
                     device=dev).scatter_reduce_(
        0, obj, torch.where(cand, bidder, big), "amin")[:N]
    has_bid = win < big
    return (torch.where(has_bid, best_bid, price),
            torch.where(has_bid, win, owner))


def _auction_solve(benefit: np.ndarray, device, eps_start=None,
                   eps_final=1e-6):
    """The assignment bidder -> object maximizing the total benefit (JAX
    ``_auction_solve``): ε from C/2 down by 4 until ε <= eps_final·C, with
    C = max|benefit| + 1, the owners reset and the prices kept at each
    phase."""
    N = benefit.shape[0]
    b = torch.as_tensor(np.asarray(benefit, np.float32), device=device)
    price = torch.zeros(N, dtype=torch.float32, device=device)
    owner = torch.full((N,), -1, dtype=torch.int64, device=device)
    C = float(np.abs(benefit).max()) + 1.0
    eps = C / 2 if eps_start is None else eps_start
    while True:
        eps_t = torch.tensor(eps, dtype=torch.float32, device=device)
        it = 0
        while int((owner >= 0).sum()) < N and it < _ROUNDS_PER_BIDDER * N:
            price, owner = _auction_round(b, price, owner, eps_t)
            it += 1
        if eps <= eps_final * C or eps <= 1e-9:
            break
        eps /= 4.0
        owner = torch.full((N,), -1, dtype=torch.int64, device=device)
    owner = owner.cpu().numpy()
    assign = np.empty(N, np.int64)
    assign[owner] = np.arange(N)
    return assign


def dense_hungarian(costs, num_rows: int = None, num_cols: int = None,
                    epsilon=None, device=None):
    """Min-cost assignment on a dense cost matrix (row-major flattened or
    2-D), padded square with max + 1.  Returns (total cost, the column of
    each row).  ``device`` (the card by default) runs the auction."""
    from cugraph_tpu_torch.core.structure import resolve_device

    C = np.asarray(costs, dtype=np.float64)
    if C.ndim == 1:
        C = C.reshape(num_rows, num_cols)
    n, m = C.shape
    N = max(n, m)
    pad = np.full((N, N), C.max() + 1.0)
    pad[:n, :m] = C
    assign = _auction_solve(-pad, resolve_device(device))
    cols = assign[:n]
    total = float(C[np.arange(n), np.minimum(cols, m - 1)].sum())
    return total, cols


def hungarian(G, workers, epsilon=None):
    """Assignment on a weighted bipartite graph whose ``workers`` are one
    side; returns (cost, ['vertex', 'assignment']).  A missing edge costs
    10·max|w| + 1."""
    workers = np.asarray(workers)
    src, dst, w = G.edgelist_arrays()
    if w is None:
        raise ValueError("hungarian requires edge weights")
    n = G.number_of_vertices()
    wid = G.lookup_internal_vertex_id(workers)
    row_of = np.full(n, -1, np.int64)
    row_of[wid] = np.arange(len(wid))
    tasks = np.flatnonzero(row_of < 0)
    col_of = np.full(n, -1, np.int64)
    col_of[tasks] = np.arange(len(tasks))
    big = float(np.abs(w).max()) * 10 + 1.0
    C = np.full((len(wid), len(tasks)), big)
    sel = (row_of[src] >= 0) & (col_of[dst] >= 0)
    C[row_of[src[sel]], col_of[dst[sel]]] = w[sel]
    cost, cols = dense_hungarian(C, device=G.device)
    assign_ext = G.number_map.to_external(
        tasks[np.minimum(cols, len(tasks) - 1)])
    return cost, pd.DataFrame({"vertex": workers, "assignment": assign_ext})
