"""Top-k maximal-biclique heuristic for bipartite graphs.

Counterpart of ``cugraph_tpu.experimental.bicliques`` (reference
python/cugraph/cugraph/experimental/structure/bicliques.py,
EXPERIMENTAL__find_bicliques:10), a copy of its NumPy and pandas: walk the
features (dst) by descending degree; for each, take its machines (src),
hop back out to every feature those machines carry, and keep the features
present on at least ``support``·degree of them; record (machines × kept
features) as a biclique when both sides clear their minimum sizes.  Sparse
relational work on the host, as in the JAX package; its ``np.unique``
calls are sorts with run boundaries here, and its dict lookups
``searchsorted``: the same values.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def _runs(a):
    """(distinct values, first positions, run lengths) of the sorted
    ``a``: ``np.unique(a, return_index=True, return_counts=True)`` without
    NumPy's hash path."""
    first = np.flatnonzero(np.r_[True, a[1:] != a[:-1]]) if len(a) else \
        np.zeros(0, np.int64)
    return a[first], first, np.diff(np.r_[first, len(a)])


def find_bicliques(df, k, offset=0, max_iter=-1, support=1.0,
                   min_features=1, min_machines=10):
    """Find (up to) the top-k maximal bicliques of a bipartite edge list.

    df must have columns 'src' (machines), 'dst' (features) and 'flag'
    (1 marks a bad machine, feeding the bad_ratio statistic).  Returns
    (B, S): B['id','vert','type' (0=machine, 1=feature)] membership rows,
    S['id','total','machines','features','bad_ratio'] per-biclique stats.
    """
    for col in ("src", "dst", "flag"):
        if col not in df.columns:
            raise NameError(f"{col} column not found")
    if support > 1.0 or support < 0.1:
        raise NameError("support must be between 0.1 and 1.0")

    src = df["src"].to_numpy(np.int64)
    dst = df["dst"].to_numpy(np.int64) - int(offset)
    flag = df["flag"].to_numpy()

    # feature -> machines CSR (sorted by feature), machine -> features CSR
    f_order = np.argsort(dst, kind="stable")
    f_sorted, m_of_f = dst[f_order], src[f_order]
    f_uniq, f_start, f_deg = _runs(f_sorted)
    m_order = np.argsort(src, kind="stable")
    m_sorted, f_of_m = src[m_order], dst[m_order]
    m_uniq, m_start, m_deg = _runs(m_sorted)
    bad = np.zeros(len(m_uniq), bool)
    np.logical_or.at(bad, np.searchsorted(m_uniq, src), flag == 1)

    # features by descending degree (ties: ascending id, like the reference's
    # sorted count table)
    by_deg = np.lexsort((f_uniq, -f_deg))

    iter_max = len(f_uniq) if max_iter == -1 else min(max_iter, len(f_uniq))
    b_rows, s_rows = [], []
    answer_id = 0
    machines_old = None
    for i in range(iter_max):
        fi = by_deg[i]
        degree = int(f_deg[fi])
        machines = _runs(np.sort(m_of_f[f_start[fi]:
                                        f_start[fi] + degree]))[0]
        if machines_old is None or len(machines) != len(machines_old) \
                or not np.array_equal(machines, machines_old):
            # all features carried by these machines, with multiplicity
            midx = np.searchsorted(m_uniq, machines)
            feats = np.concatenate([
                f_of_m[m_start[j]: m_start[j] + m_deg[j]] for j in midx
            ]) if len(midx) else np.zeros(0, np.int64)
            fvals, _, fcnt = _runs(np.sort(feats))
            goal = int(degree * support)
            kept = fvals[fcnt >= goal]
            if len(kept) > min_features and len(machines) >= min_machines:
                for m in machines:
                    b_rows.append((answer_id, int(m), 0))
                for f in kept:
                    b_rows.append((answer_id, int(f) + int(offset), 1))
                total = len(machines) + len(kept)
                num_bad = int(bad[midx].sum())
                s_rows.append((answer_id, total, len(machines), len(kept),
                               num_bad / total))
                answer_id += 1
        machines_old = machines
        if k > -1 and answer_id == k:
            break

    B = pd.DataFrame(b_rows, columns=["id", "vert", "type"])
    S = pd.DataFrame(s_rows,
                     columns=["id", "total", "machines", "features",
                              "bad_ratio"])
    return B, S
