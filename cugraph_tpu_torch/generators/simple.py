"""Simple generators: path, complete, star, 2D and 3D mesh, Erdős–Rényi
G(n, p) and G(n, m), and bipartite R-MAT (reference
cpp/src/generators/{simple_generators.cuh, erdos_renyi_generator.cuh},
cpp/include/cugraph/graph_generators.hpp:26-174).

The port's own copy of ``cugraph_tpu.generators.simple``: NumPy and
pandas, each frame bit for bit the JAX package's, the random ones drawn
from the same ``np.random.default_rng(seed)`` streams.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def path_graph(n: int, base: int = 0):
    s = np.arange(base, base + n - 1)
    return pd.DataFrame({"src": s, "dst": s + 1})


def complete_graph(n: int, base: int = 0):
    i, j = np.triu_indices(n, k=1)
    return pd.DataFrame({"src": i + base, "dst": j + base})


def star_graph(n: int, center: int = 0):
    leaves = np.array([v for v in range(n) if v != center])
    return pd.DataFrame({"src": np.full(n - 1, center), "dst": leaves})


def mesh_2d_graph(rows: int, cols: int):
    v = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], axis=1)
    down = np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down])
    return pd.DataFrame({"src": e[:, 0], "dst": e[:, 1]})


def mesh_3d_graph(x: int, y: int, z: int):
    v = np.arange(x * y * z).reshape(x, y, z)
    e = np.concatenate([
        np.stack([v[:, :, :-1].ravel(), v[:, :, 1:].ravel()], axis=1),
        np.stack([v[:, :-1, :].ravel(), v[:, 1:, :].ravel()], axis=1),
        np.stack([v[:-1].ravel(), v[1:].ravel()], axis=1)])
    return pd.DataFrame({"src": e[:, 0], "dst": e[:, 1]})


def _unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by one sort: the same sorted values, where NumPy
    2.3's ``np.unique`` hashes a large int64 array, many times slower."""
    a = np.sort(a)
    keep = np.ones(len(a), bool)
    keep[1:] = a[1:] != a[:-1]
    return a[keep]


def _sample_distinct(rng, total: int, m: int) -> np.ndarray:
    """m distinct uniform draws from [0, total) in O(m) memory:
    ``choice(total, replace=False)`` would permute the whole domain, so
    large domains oversample and de-duplicate instead."""
    if m >= total:
        return np.arange(total, dtype=np.int64)
    if total <= 4 * m or total < 1 << 20:
        return rng.choice(total, size=m, replace=False).astype(np.int64)
    out = _unique(rng.integers(0, total, int(m * 1.2) + 16, dtype=np.int64))
    while len(out) < m:
        extra = rng.integers(0, total, m, dtype=np.int64)
        out = _unique(np.concatenate([out, extra]))
    return rng.permutation(out)[:m]


def _upper_pair(picks, n):
    """The (i, j), i < j, of each linear index into the upper triangle."""
    i = (n - 2 - np.floor(np.sqrt(-8 * picks + 4 * n * (n - 1) - 7) / 2.0
                          - 0.5)).astype(np.int64)
    j = (picks + i + 1 - n * (n - 1) // 2
         + (n - i) * ((n - i) - 1) // 2).astype(np.int64)
    return i, j


def erdos_renyi_gnp(n: int, p: float, seed: int = 42, directed: bool = False):
    """G(n, p): a binomial edge count, then that many distinct pairs."""
    rng = np.random.default_rng(seed)
    total = n * (n - 1) if directed else n * (n - 1) // 2
    m = rng.binomial(total, p)
    picks = _sample_distinct(rng, total, m)
    if directed:
        src = picks // (n - 1)
        off = picks % (n - 1)
        dst = np.where(off >= src, off + 1, off)
    else:
        src, dst = _upper_pair(picks, n)
    return pd.DataFrame({"src": src, "dst": dst})


def erdos_renyi_gnm(n: int, m: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    total = n * (n - 1) // 2
    i, j = _upper_pair(_sample_distinct(rng, total, min(m, total)), n)
    return pd.DataFrame({"src": i, "dst": j})


def bipartite_rmat(scale_src: int, scale_dst: int, num_edges: int,
                   a: float = 0.57, b: float = 0.19, c: float = 0.19,
                   seed: int = 42):
    """Bipartite R-MAT (reference graph_generators.hpp:125) over the
    port's native ``rmat``: sources in [0, 2^scale_src), destinations in
    the disjoint range that follows."""
    from cugraph_tpu_torch.generators.rmat import rmat

    df = rmat(max(scale_src, scale_dst), num_edges, a, b, c, seed=seed)
    src = df["src"].to_numpy() % (2 ** scale_src)
    dst = df["dst"].to_numpy() % (2 ** scale_dst) + 2 ** scale_src
    return pd.DataFrame({"src": src, "dst": dst})
