"""Link prediction: Jaccard, Sorensen, Overlap and Cosine similarity,
weighted and unweighted, and their all-pairs forms with top-k.

Counterpart of ``cugraph_tpu.algos.link_prediction`` (reference
cpp/src/link_prediction/{jaccard,sorensen,overlap,cosine}_impl.cuh over
detail/similarity_impl.cuh).  The pair intersections run on the graph's
device (``prims/intersection.pair_intersection``, the min-degree probe in
torch gathers and searches over the CSR); the coefficients are float64
NumPy over the returned statistics, as in the JAX package.  The default
pairs (``vertex_pair=None``) are the graph's edges, each undirected edge
once.  ``all_pairs_*`` enumerates the two-hop candidates with a scipy
sparse product on the host, whose values are already the unweighted
intersection counts.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from cugraph_tpu_torch.prims.intersection import pair_intersection


def _default_pairs(G):
    src, dst, _ = G.edgelist_arrays()
    if not G.is_directed():
        keep = src < dst
        return src[keep], dst[keep]
    return src, dst


def _resolve_pairs(G, vertex_pair):
    if vertex_pair is None:
        return _default_pairs(G)
    first = G.lookup_internal_vertex_id(vertex_pair["first"].to_numpy())
    second = G.lookup_internal_vertex_id(vertex_pair["second"].to_numpy())
    return first, second


def _coefficients(kind, inter, su, sv):
    """float64 coefficients from the intersection and the two endpoint
    sizes (degrees, or weight sums when weighted); 0 where undefined."""
    union = su + sv - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        if kind == "jaccard":
            return np.where(union > 0, inter / union, 0.0)
        if kind == "sorensen":
            return np.where(su + sv > 0, 2.0 * inter / (su + sv), 0.0)
        if kind == "overlap":
            mins = np.minimum(su, sv)
            return np.where(mins > 0, inter / mins, 0.0)
        if kind == "cosine":
            denom = np.sqrt(su * sv)
            return np.where(denom > 0, inter / denom, 0.0)
    raise ValueError(kind)


def _similarity(G, vertex_pair, kind: str, use_weight: bool):
    us, vs = _resolve_pairs(G, vertex_pair)
    if len(us) == 0:
        return pd.DataFrame({"first": [], "second": [], f"{kind}_coeff": []})
    if use_weight and not G.is_weighted():
        raise ValueError("use_weight=True requires a weighted graph")
    stats = pair_intersection(G.structure, us, vs, weighted=use_weight)

    def host(name):
        return stats[name].cpu().numpy().astype(np.float64)

    if use_weight:
        coeff = _coefficients(kind, host("sum_min"), host("wsum_u"),
                              host("wsum_v"))
    else:
        coeff = _coefficients(kind, host("count"), host("deg_u"),
                              host("deg_v"))
    return pd.DataFrame({
        "first": G.number_map.to_external(us),
        "second": G.number_map.to_external(vs),
        f"{kind}_coeff": coeff,
    })


def jaccard(G, vertex_pair=None, use_weight: bool = False):
    """Jaccard similarity |N(u)∩N(v)| / |N(u)∪N(v)| (reference
    jaccard_impl.cuh); returns ['first', 'second', 'jaccard_coeff']."""
    return _similarity(G, vertex_pair, "jaccard", use_weight)


def sorensen(G, vertex_pair=None, use_weight: bool = False):
    return _similarity(G, vertex_pair, "sorensen", use_weight)


def overlap(G, vertex_pair=None, use_weight: bool = False):
    return _similarity(G, vertex_pair, "overlap", use_weight)


def cosine(G, vertex_pair=None, use_weight: bool = False):
    return _similarity(G, vertex_pair, "cosine", use_weight)


def jaccard_coefficient(G, ebunch=None):
    """NetworkX-flavoured alias (the reference keeps it for
    compatibility)."""
    vp = None
    if ebunch is not None:
        vp = pd.DataFrame({"first": [u for u, _ in ebunch],
                           "second": [v for _, v in ebunch]})
    return jaccard(G, vp)


def _sorted_unique(a):
    """``np.unique(a)`` by one sort: the same sorted values.  NumPy 2.3
    and later take a hash path for ``np.unique`` without return arrays,
    which took 37 s for the 31.4 M edge keys of RMAT-20 on the H100
    machine's host, against 0.5 s for the sort."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if len(a) else a


def _two_hop_candidates(G, ids=None):
    """All two-hop pairs (one endpoint in ``ids`` when given) with their
    common-neighbour counts: the values of the scipy product A·Aᵀ that
    enumerates them (JAX link_prediction.py:121-153).  Returns (us, vs,
    counts)."""
    import scipy.sparse as sp

    src, dst, _ = G.edgelist_arrays()
    n = G.number_of_vertices()
    # one entry per directed edge, so the counts are set intersections
    ekey = _sorted_unique(src.astype(np.int64) * n + dst.astype(np.int64))
    A = sp.csr_matrix((np.ones(len(ekey)), (ekey // n, ekey % n)),
                      shape=(n, n))
    B = A if ids is None else A[ids]
    P = (B @ A.T).tocoo()  # values = common out-neighbour counts
    row = P.row if ids is None else ids[P.row.astype(np.int64)]
    col, cnt = P.col.astype(np.int64), P.data
    if not G.is_directed():
        lo = np.minimum(row, col)
        hi = np.maximum(row, col)
        mask = lo != hi
        key, idx = np.unique(lo[mask] * n + hi[mask], return_index=True)
        return ((key // n).astype(np.int32), (key % n).astype(np.int32),
                cnt[mask][idx].astype(np.int64))
    mask = row != col
    return (row[mask].astype(np.int32), col[mask].astype(np.int32),
            cnt[mask].astype(np.int64))


def _all_pairs(G, kind: str, use_weight: bool, vertices, topk):
    ids = None
    if vertices is not None:
        ids = np.unique(G.lookup_internal_vertex_id(np.asarray(vertices)))
    us, vs, cnt = _two_hop_candidates(G, ids)
    col = f"{kind}_coeff"
    if use_weight:
        vp = pd.DataFrame({"first": G.number_map.to_external(us),
                           "second": G.number_map.to_external(vs)})
        df = _similarity(G, vp, kind, use_weight)
    else:
        offs = G.structure.csr.offsets.cpu().numpy()
        deg = (offs[1:] - offs[:-1]).astype(np.float64)
        df = pd.DataFrame({"first": G.number_map.to_external(us),
                           "second": G.number_map.to_external(vs),
                           col: _coefficients(kind, cnt.astype(np.float64),
                                              deg[us], deg[vs])})
    df = df.sort_values(col, ascending=False).reset_index(drop=True)
    if topk is not None:
        df = df.head(int(topk)).reset_index(drop=True)
    return df


def all_pairs_jaccard(G, vertices=None, use_weight=False, topk=None):
    return _all_pairs(G, "jaccard", use_weight, vertices, topk)


def all_pairs_sorensen(G, vertices=None, use_weight=False, topk=None):
    return _all_pairs(G, "sorensen", use_weight, vertices, topk)


def all_pairs_overlap(G, vertices=None, use_weight=False, topk=None):
    return _all_pairs(G, "overlap", use_weight, vertices, topk)


def all_pairs_cosine(G, vertices=None, use_weight=False, topk=None):
    return _all_pairs(G, "cosine", use_weight, vertices, topk)
