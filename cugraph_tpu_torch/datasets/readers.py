"""Edge-list file readers and a writer: CSV and MatrixMarket.

Counterpart of ``cugraph_tpu.datasets.readers`` (reference ingestion:
datasets/karate.csv, space-separated src dst wgt; .mtx through
tests/utilities/matrix_market_file_utilities; cudf.read_csv in
dataset.py:165 get_edgelist).  NumPy and pandas on the host.
"""

from __future__ import annotations

import gzip

import numpy as np
import pandas as pd


def read_csv_edgelist(path: str, *, delimiter=None, names=("src", "dst", "wgt"),
                      header=None, comment="#", dtype=None) -> pd.DataFrame:
    """A whitespace or CSV edge list as ['src', 'dst'(, 'wgt')]; columns
    beyond ``names`` are named col_<i>."""
    df = pd.read_csv(path, sep=delimiter if delimiter is not None else r"\s+",
                     header=header, comment=comment, engine="python")
    cols = list(names)[: df.shape[1]]
    cols += [f"col_{i}" for i in range(len(cols), df.shape[1])]
    df.columns = cols
    if dtype:
        df = df.astype(dtype)
    return df


def read_mtx(path: str) -> pd.DataFrame:
    """A MatrixMarket coordinate file as ['src', 'dst'(, 'wgt')]: general
    or symmetric, optionally gzipped, pattern or real/integer values;
    1-based indices become 0-based (the reference's mm_to_coo)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        banner = f.readline().strip().lower()
        if not banner.startswith("%%matrixmarket"):
            raise ValueError("not a MatrixMarket file")
        symmetric = "symmetric" in banner
        pattern = "pattern" in banner
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = map(int, line.split()[:3])  # the size line
        data = np.loadtxt(f, ndmin=2)
    if data.size == 0:
        data = data.reshape(0, 3 if not pattern else 2)
    src = data[:, 0].astype(np.int64) - 1
    dst = data[:, 1].astype(np.int64) - 1
    w = None if (pattern or data.shape[1] < 3) else data[:, 2].astype(np.float32)
    if symmetric:
        keep = src != dst
        src, dst = (np.concatenate([src, dst[keep]]),
                    np.concatenate([dst, src[keep]]))
        if w is not None:
            w = np.concatenate([w, w[keep]])
    out = {"src": src, "dst": dst}
    if w is not None:
        out["wgt"] = w
    return pd.DataFrame(out)


def write_csv_edgelist(G, path: str, *, delimiter=" ") -> None:
    """A Graph's edge list in external ids, one edge per line, no
    header."""
    from cugraph_tpu_torch.algos.structure import decompress_to_edgelist

    decompress_to_edgelist(G).to_csv(path, sep=delimiter, header=False,
                                     index=False)
