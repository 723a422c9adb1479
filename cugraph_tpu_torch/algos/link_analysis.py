"""Link analysis: PageRank (incl. personalized) and HITS.

Counterpart of ``cugraph_tpu.algos.link_analysis`` (reference
cpp/src/link_analysis/pagerank_impl.cuh:224-330, hits_impl.cuh:47-194).
The power iteration is a host loop over device tensors: one sum SpMV per
PageRank iteration (pull, over the CSC) and two per HITS iteration (pull,
then push over the CSR), both through the hand-written kernel on the card.
The out-weight sums, the dangling sum, the update and the L1 error are plain
torch; the convergence test reads the error back once per iteration, as the
reference's host_scalar_allreduce does (pagerank_impl.cuh:209).

A graph whose resident structure exceeds the spill budget
(``kernels/dispatch.plan_needs_spill``) runs PageRank without building
it: the edges stay on the host as a chunked CSC and each iteration's pull
streams through the card (``kernels/spill.spmv_spilled``), the JAX
package's ``_pagerank_spilled``.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.algos._utils import vertex_frame
from cugraph_tpu_torch.api.exceptions import FailedToConvergeError
from cugraph_tpu_torch.kernels.dispatch import (get_pull_plan_spilled,
                                                out_weight_vectors,
                                                plan_needs_spill)
from cugraph_tpu_torch.kernels.spill import spmv_spilled
from cugraph_tpu_torch.prims.vertex_edge import spmv_pull, spmv_push
from cugraph_tpu_torch.utils.profiling import span


def _check_precision(precision: str) -> None:
    """The JAX package maps "exact"/"fast" to split-bf16 or single-bf16
    one-hot products on the TPU; on the card both run the same fp32
    kernel, so the knob is validated and otherwise has no effect."""
    if precision not in ("exact", "fast"):
        raise ValueError(
            f"precision must be 'exact' or 'fast', got {precision!r}")


def _vertex_values(G, x):
    """(internal ids, float32 values) of a dict or a ['vertex', value]
    DataFrame keyed by external id."""
    if isinstance(x, dict):
        keys = np.array(list(x.keys()))
        vals = np.array(list(x.values()), dtype=np.float32)
    else:
        keys = x["vertex"].to_numpy()
        cols = [c for c in x.columns if c != "vertex"]
        vals = x[cols[0]].to_numpy().astype(np.float32)
    return G.lookup_internal_vertex_id(keys), vals


def _normalized_vector(G, x, default, n: int) -> np.ndarray:
    v = np.zeros(n, dtype=np.float32)
    if x is None:
        v[:] = default
        return v
    ids, vals = _vertex_values(G, x)
    v[ids] = vals
    s = v.sum()
    if s <= 0:
        raise ValueError("personalization/dangling sums to zero")
    return v / s


def _out_weight_inverse(out_w):
    """(1 / out_w where it is positive, else 0; where it is not)."""
    return (torch.where(out_w > 0, 1.0 / out_w, torch.zeros_like(out_w)),
            out_w <= 0)


def pagerank(
    G,
    alpha: float = 0.85,
    personalization=None,
    precomputed_vertex_out_weight=None,
    max_iter: int = 100,
    tol: float = 1.0e-5,
    nstart=None,
    weight=None,           # accepted for nx parity; weights come from the graph
    dangling=None,
    fail_on_nonconvergence: bool = True,
    precision: str = "exact",
):
    """PageRank.  Returns a DataFrame ['vertex', 'pagerank'], or
    ``(df, converged)`` when ``fail_on_nonconvergence`` is False.

    Dangling mass is redistributed through the personalization vector, or
    the explicit ``dangling`` dict/frame, and scaled by alpha (networkx
    semantics, as the reference).  ``precision`` is "exact" or "fast"; both
    run the same fp32 kernel here.  Above the spill budget the pull
    streams the host CSC through the card; the result is the same bits.
    """
    with span("cugraph.pagerank"):
        with span("cugraph.pagerank.prepare"):
            _check_precision(precision)
            n = G.number_of_vertices()
            dev = G.device
            # decided before G.structure is built
            spilled = plan_needs_spill(G)
            if spilled:
                plan = get_pull_plan_spilled(G)

                def pull(x):
                    return spmv_spilled(plan, x)
            else:
                g = G.structure

                def pull(x):
                    return spmv_pull(g, x)  # pagerank_impl.cuh:262-275

            reset_np = _normalized_vector(G, personalization, 1.0 / n, n)
            dang_np = (_normalized_vector(G, dangling, None, n)
                       if dangling is not None else reset_np)
            p0_np = _normalized_vector(G, nstart, 1.0 / n, n)

            if precomputed_vertex_out_weight is not None:
                # caller-supplied per-vertex out-weight sums replace the
                # graph's (reference pagerank.py
                # precomputed_vertex_out_weight)
                ids, vals = _vertex_values(G, precomputed_vertex_out_weight)
                pre_ow = np.zeros(n, np.float32)
                pre_ow[ids] = vals
                inv_out, is_dangling = _out_weight_inverse(
                    torch.from_numpy(pre_ow).to(dev))
            elif spilled:
                inv_np, dangling_np = out_weight_vectors(G)
                inv_out = torch.from_numpy(inv_np).to(dev)
                is_dangling = torch.from_numpy(dangling_np).to(dev)
            else:
                # float64 sums over the CSR's rows rounded once, as the
                # host bincount of out_weight_vectors
                inv_out, is_dangling = _out_weight_inverse(g.out_weight_sums)

            reset = torch.from_numpy(reset_np).to(dev)
            dang = torch.from_numpy(dang_np).to(dev)
            p = torch.from_numpy(p0_np).to(dev)
            # the update's scalars in float32, as the JAX package computes
            # them
            alpha32 = np.float32(alpha)
            alpha_f = float(alpha32)
            one_minus_alpha = float(np.float32(1.0) - alpha32)
            teleport = one_minus_alpha * reset
            tol = float(np.float32(tol))
        with span("cugraph.pagerank.loop"):
            err, it = float("inf"), 0
            while err >= tol and it < max_iter:
                # pagerank_impl.cuh:239 divide by out-weight
                scaled = p * inv_out
                dangling_sum = torch.where(is_dangling, p, 0.0).sum()
                pulled = pull(scaled)
                p_new = alpha_f * (pulled + dangling_sum * dang) + teleport
                # pagerank_impl.cuh:311
                err = torch.sum(torch.abs(p_new - p)).item()
                p = p_new
                it += 1
        converged = err < tol
        if not converged and fail_on_nonconvergence:
            raise FailedToConvergeError(
                f"pagerank failed to converge in {max_iter} iterations "
                f"(err={err:.3e})")
        df = vertex_frame(G, {"pagerank": p})
        if fail_on_nonconvergence:
            return df
        return df, converged


def _scaled_by_max(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.max(torch.abs(v)), min=1e-30)


def hits(G, max_iter: int = 100, tol: float = 1.0e-5, nstart=None,
         normalized: bool = True, precision: str = "exact"):
    """HITS hubs/authorities (reference hits_impl.cuh:47-194).
    Returns DataFrame ['vertex', 'hubs', 'authorities'].
    ``precision``: see pagerank."""
    _check_precision(precision)
    n = G.number_of_vertices()
    g = G.structure
    h0 = np.zeros(n, dtype=np.float32)
    if nstart is None:
        h0[:] = 1.0 / n
    else:
        ids = G.lookup_internal_vertex_id(nstart["vertex"].to_numpy())
        h0[ids] = nstart["values"].to_numpy()
    h = torch.from_numpy(h0).to(g.device)
    a = torch.zeros_like(h)
    tol = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol and it < max_iter:
        a = _scaled_by_max(spmv_pull(g, h))      # a = A^T h
        h_new = _scaled_by_max(spmv_push(g, a))  # h = A a
        err = torch.sum(torch.abs(h_new - h)).item()
        h = h_new
        it += 1
    if normalized:
        h = h / torch.clamp(torch.sum(h), min=1e-30)
        a = a / torch.clamp(torch.sum(a), min=1e-30)
    return vertex_frame(G, {"hubs": h, "authorities": a})
