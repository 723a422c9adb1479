"""Plain sampled betweenness and the comparison that decides a
betweenness cell's ``correct``.

The reference is Brandes' algorithm (Brandes 2001) for the judged call's
own sources, all at once as [n, k] panels, on the undirected simple graph
of the edge list, in float64: path counts level by level by sparse
products (``torch.sparse``) from the sources, then the dependencies back
from the deepest level; a source's own dependency is 0.  Scaled as
cuGraph and networkx scale sampled, normalised betweenness without
endpoints: 1 / ((n - 1)(n - 2)) times n / k.  The program's frames are
judged in external ids: every vertex once (``vertex_mismatch``, exact),
and the gaps over the largest reference value (``bc_max_gap``) and in L1
(``bc_l1_rel_err``).  The control is this reference with every panel
rounded to bfloat16 after each operation, the precision below the float32
that the configuration states.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from portbench.reference.graph import positions, undirected


def _adjacency(s, d, n, dtype):
    """The symmetric adjacency of the stored edges, sparse CSR."""
    with warnings.catch_warnings():  # "beta" notices of torch.sparse
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([d, s]), torch.ones(s.numel(), dtype=dtype,
                                            device=s.device),
            (n, n)).coalesce().to_sparse_csr()


def brandes(adj, sources, n, dtype=torch.float64, rnd=lambda t: t):
    """Σ over ``sources`` (row positions) of the dependencies δ_s(v),
    unscaled, in ``dtype``; ``rnd`` rounds every panel after each
    operation (the control's bfloat16)."""
    dev = adj.device
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    onehot = torch.arange(n, device=dev)[:, None] == src[None, :]
    dist = torch.where(onehot, 0, -1).to(torch.int32)
    sigma = onehot.to(dtype)
    level = 0
    while True:
        sig_in = rnd(adj @ torch.where(dist == level, sigma, 0.0))
        newly = (dist == -1) & (sig_in > 0)
        dist.masked_fill_(newly, level + 1)
        sigma = rnd(sigma + torch.where(newly, sig_in, 0.0))
        level += 1
        if not bool(newly.any()):
            break
    delta = torch.zeros_like(sigma)
    for lv in range(level - 1, -1, -1):
        y = rnd(torch.where(dist == lv + 1, (1.0 + delta)
                            / sigma.clamp(min=1.0), 0.0))
        a = torch.where(dist == lv, sigma, 0.0)
        delta = rnd(delta + rnd(a * (adj @ y)))
    delta.masked_fill_(onehot, 0.0)
    return delta.sum(1)


def _bfloat16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def reference_values(judged, device, dtype=torch.float64, rnd=lambda t: t):
    """(sorted external ids, [the scaled betweenness for each judged
    frame's sources])."""
    src = torch.as_tensor(judged["src"]).to(device)
    dst = torch.as_tensor(judged["dst"]).to(device)
    ids, s, d = undirected(src, dst)
    del src, dst
    n = ids.numel()
    call = judged["call"]
    if not call.get("normalized", True) or call.get("endpoints", False):
        raise ValueError("the reference scales normalized betweenness "
                         "without endpoints")
    adj = _adjacency(s, d, n, dtype)
    del s, d
    out = []
    for sources, _ in judged["frames"]:
        ext = torch.as_tensor(np.asarray(sources, np.int64)).to(device)
        pos, found = positions(ids, ext)
        if not bool(found.all()):
            raise ValueError("a source is not a vertex of the graph")
        k = pos.numel()
        scale = (1.0 / ((n - 1) * (n - 2))) * (n / k if k < n else 1.0)
        out.append(brandes(adj, pos, n, dtype, rnd) * scale)
    return ids, out


def readings(ref, frames) -> dict:
    """The numbers compared, over the frames judged (each a (vertex ids,
    values) pair of host arrays, in the reference's frame order)."""
    ids, values = ref
    n = ids.numel()
    mismatch, worst, l1 = 0, 0.0, 0.0
    for (vertex, value), want in zip(frames, values):
        ext = torch.as_tensor(np.array(vertex, np.int64)).to(ids.device)
        val = torch.as_tensor(np.array(value, np.float64)).to(ids.device)
        pos, found = positions(ids, ext)
        hit = torch.zeros(n, dtype=torch.int64, device=ids.device)
        hit.index_add_(0, pos[found], torch.ones_like(pos[found]))
        mismatch += int((~found).sum()) + int((hit != 1).sum())
        if not bool(found.any()):
            worst = l1 = float("inf")
            continue
        r = want[pos[found]].double()
        gap = torch.nan_to_num(torch.abs(val[found] - r), nan=np.inf)
        worst = max(worst, float(gap.max() / want.abs().max()))
        l1 = max(l1, float(gap.sum() / want.abs().sum()))
    if not frames or len(frames) != len(values):
        mismatch, worst, l1 = n, float("inf"), float("inf")
    return {"vertex_mismatch": float(mismatch), "bc_max_gap": worst,
            "bc_l1_rel_err": l1}


def reference(judged, device):
    return reference_values(judged, device)


def program_outputs(judged) -> list:
    return [(f["vertex"].to_numpy(), f["betweenness_centrality"].to_numpy())
            for _, f in judged["frames"]]


def control_outputs(judged, device) -> list:
    """The control in the program's place: the reference with bfloat16
    panels."""
    ids, values = reference_values(judged, device, torch.float32, _bfloat16)
    host = ids.cpu().numpy()
    return [(host, v.cpu().numpy()) for v in values]


def fault_outputs(judged, device) -> dict:
    """No fault needs a chip run here: the CPU tests plant each one in the
    program."""
    return {}
