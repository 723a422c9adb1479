"""Host-side edge list transforms used at graph-construction time.

NumPy counterparts of ``cugraph_tpu.core.preprocess`` (reference
cpp/src/structure/{symmetrize_graph_impl.cuh,remove_multi_edges_impl.cuh,
remove_self_loops_impl.cuh};
Python symmetrize at python/cugraph/cugraph/structure/symmetrize.py).
Duplicate pairs over a dense id space go through the native counting-sort
dedupe (``core/native.py``), under the JAX package's guard
(preprocess.py:25-45); ``_remove_multi_edges_numpy`` is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core import native

_MODES = {"first": 0, "sum": 1, "min": 2, "max": 3}


def remove_self_loops(src, dst, weight=None):
    """The edges with src != dst, in input order; NumPy in and out
    (reference remove_self_loops_impl.cuh)."""
    keep = src != dst
    return src[keep], dst[keep], None if weight is None else weight[keep]


def remove_multi_edges(src, dst, weight=None, *, keep="first"):
    """Drop duplicate (src, dst) pairs.

    ``keep='first'`` keeps the first occurrence and the input order;
    ``keep='sum'``/``'min'``/``'max'`` reduce the weights of each pair and
    return the pairs in key order.
    """
    n_ids = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1 \
        if len(src) else 0
    mode = _MODES.get(keep)
    # the counting sort pays only for a dense id space: O(max id) buckets
    # over sparse huge raw ids would dwarf an O(m log m) sort
    if (n_ids and mode is not None
            and np.issubdtype(src.dtype, np.integer)
            and np.issubdtype(dst.dtype, np.integer)
            and n_ids < (1 << 31) and n_ids <= 4 * len(src) + 1024
            and src.min(initial=0) >= 0 and dst.min(initial=0) >= 0
            and (mode in (0, 1) or weight is None
                 or _min_max_agree(weight))):
        idx, w_out = native.dedupe_edges_native(
            src, dst, weight, n_ids, 0 if weight is None else mode)
        if mode == 0 or weight is None:
            idx.sort()  # the input order, as np.unique's first index
            return (src[idx], dst[idx],
                    None if weight is None else weight[idx])
        return src[idx], dst[idx], w_out.astype(weight.dtype)
    return _remove_multi_edges_numpy(src, dst, weight, keep=keep)


def _sorted_runs(key, device):
    """One stable sort of the int64 ``key`` on ``device``: (the sorted
    keys, their positions in ``key``, the first of each run of equal
    keys).  NumPy 2.3's hash ``np.unique``, which the JAX package calls,
    is ~100x slower than a sort at tens of millions of keys."""
    ks, order = torch.sort(torch.as_tensor(np.asarray(key, np.int64),
                                           device=device), stable=True)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    return ks, order, first


def first_occurrences(key, device) -> np.ndarray:
    """The position of the first occurrence of each distinct value of the
    int64 ``key``, in input order: ``np.unique(key, return_index=True)[1]``
    sorted."""
    _, order, first = _sorted_runs(key, device)
    return torch.sort(order[first]).values.cpu().numpy()


def unique_by_sort(key, device, return_index=False, return_inverse=False):
    """``np.unique`` of the int64 ``key`` by one stable sort on ``device``:
    the distinct keys ascending, then, as asked, the position of each
    one's first occurrence and the inverse map, as host arrays equal to
    ``np.unique``'s."""
    ks, order, first = _sorted_runs(key, device)
    out = [ks[first].cpu().numpy()]
    if return_index:
        out.append(order[first].cpu().numpy())
    if return_inverse:
        inv = torch.empty_like(order)
        inv[order] = torch.cumsum(first, 0) - 1
        out.append(inv.cpu().numpy())
    return out[0] if len(out) == 1 else tuple(out)


def _min_max_agree(weight) -> bool:
    """Whether the C++ min/max of a pair's weights equal NumPy's: they
    differ on a NaN, which ``np.minimum.at`` keeps and ``std::min`` may
    drop, and on a tie of -0.0 with +0.0, where NumPy keeps the later
    zero and ``std::min`` the first."""
    return not (np.isnan(weight).any()
                or ((weight == 0) & np.signbit(weight)).any())


def _remove_multi_edges_numpy(src, dst, weight=None, *, keep="first"):
    """The plain version of ``remove_multi_edges``: a sort of 64-bit keys."""
    # (src<<32)|uint32(dst) would alias once ids reach 2^32: build a
    # collision-free key from factorized endpoints for huge or negative ids
    if len(src) and (src.max(initial=0) >= (1 << 31)
                     or dst.max(initial=0) >= (1 << 31)
                     or src.min(initial=0) < 0 or dst.min(initial=0) < 0):
        uniq_ids, inv = np.unique(np.concatenate([src, dst]),
                                  return_inverse=True)
        e = len(src)
        key = inv[:e].astype(np.int64) * len(uniq_ids) + inv[e:]
    else:
        key = ((src.astype(np.int64) << 32)
               | dst.astype(np.uint32).astype(np.int64))
    if keep == "first" or weight is None:
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        if weight is None:
            return src[idx], dst[idx], None
        return src[idx], dst[idx], weight[idx]
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], weight[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    seg = np.repeat(np.arange(uniq_key.shape[0]),
                    np.diff(np.append(start, key_s.shape[0])))
    if keep == "sum":
        w_out = np.bincount(seg, weights=w_s)
    elif keep == "min":
        w_out = np.full(uniq_key.shape[0], np.inf)
        np.minimum.at(w_out, seg, w_s)
    elif keep == "max":
        w_out = np.full(uniq_key.shape[0], -np.inf)
        np.maximum.at(w_out, seg, w_s)
    else:
        raise ValueError(f"unknown keep={keep!r}")
    first = order[start]
    return src[first], dst[first], w_out.astype(weight.dtype)


def symmetrize_edgelist(src, dst, weight=None):
    """Union of the edge list with its reverse, duplicates removed.

    Duplicate weights coalesce with MIN, matching the reference's
    ``groupby(...).min()`` (structure/symmetrize.py:75).
    """
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = None if weight is None else np.concatenate([weight, weight])
    return remove_multi_edges(s2, d2, w2,
                              keep="first" if weight is None else "min")
