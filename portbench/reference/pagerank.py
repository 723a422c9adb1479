"""Plain PageRank and the comparison that decides a PageRank cell's
``correct``.

The reference is the power iteration of networkx and cuGraph on the
undirected simple graph of the edge list: p0 = 1/n, then ``max_iter`` times
p = alpha (A^T (p / out-degree) + dangling mass / n) + (1 - alpha) / n, with
``tol`` 0, in float64.  The program's frames are judged against it in
external ids: every vertex once (``vertex_mismatch``, exact) and the widest
relative gap of a value (``pagerank_max_rel_err``).  The control is this
reference computed in bfloat16, the precision below the float32 that the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.graph import positions, pull_sum, undirected


def pagerank(s, d, n: int, alpha: float, iterations: int,
             dtype=torch.float64) -> torch.Tensor:
    out_deg = torch.bincount(s, minlength=n).to(dtype)
    dangling = out_deg == 0
    inv = torch.where(dangling, torch.zeros_like(out_deg), 1.0 / out_deg)
    p = torch.full((n,), 1.0 / n, dtype=dtype, device=s.device)
    for _ in range(iterations):
        pulled = pull_sum(s, d, p * inv, n)
        p = alpha * (pulled + p[dangling].sum() / n) + (1.0 - alpha) / n
    return p


def _graph(judged, device):
    src = torch.as_tensor(judged["src"]).to(device)
    dst = torch.as_tensor(judged["dst"]).to(device)
    return undirected(src, dst)


def reference_frame(judged, device, dtype=torch.float64):
    """(sorted external ids, values) of the reference in ``dtype``."""
    ids, s, d = _graph(judged, device)
    call = judged["call"]
    if call.get("tol", 0.0) != 0.0:
        raise ValueError("the reference runs a fixed count: tol must be 0")
    p = pagerank(s, d, ids.numel(), call.get("alpha", 0.85),
                 call["max_iter"], dtype)
    return ids, p


def readings(ref, frames) -> dict:
    """The numbers compared, over the frames judged (each a
    (vertex ids, values) pair of host arrays)."""
    ids, p_ref = ref
    n = ids.numel()
    mismatch, worst = 0, 0.0
    for vertex, value in frames:
        ext = torch.as_tensor(np.array(vertex, np.int64)).to(ids.device)
        val = torch.as_tensor(np.array(value, np.float64)).to(ids.device)
        pos, found = positions(ids, ext)
        hit = torch.zeros(n, dtype=torch.int64, device=ids.device)
        hit.index_add_(0, pos[found], torch.ones_like(pos[found]))
        mismatch += int((~found).sum()) + int((hit != 1).sum())
        if bool(found.any()):
            r = p_ref[pos[found]]
            rel = torch.abs(val[found] - r) / r
            worst = max(worst, float(torch.nan_to_num(rel, nan=np.inf).max()))
        else:
            worst = float("inf")
    if not frames:
        mismatch, worst = n, float("inf")
    return {"vertex_mismatch": float(mismatch), "pagerank_max_rel_err": worst}


def reference(judged, device):
    return reference_frame(judged, device)


def program_outputs(judged) -> list:
    return [(f["vertex"].to_numpy(), f["pagerank"].to_numpy())
            for f in judged["frames"]]



def control_outputs(judged, device) -> list:
    """The control in the program's place: the reference in bfloat16."""
    ids, p_low = reference_frame(judged, device, torch.bfloat16)
    return [(ids.cpu().numpy(), p_low.float().cpu().numpy())]


def fault_outputs(judged, device) -> dict:
    """No fault needs a chip run here: only a training cell's faults set
    limits (the CPU tests plant each one in the program)."""
    return {}
