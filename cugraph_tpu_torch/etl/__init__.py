"""ETL: renumbering string and multi-column keys for ingest pipelines
(reference cpp/libcugraph_etl/src/renumbering.cu, SURVEY.md N29).

Counterpart of ``cugraph_tpu.etl``: ingest is host work, and pandas'
factorize plays the part of the reference's hash kernels.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def renumber_strings(df: pd.DataFrame, src_col: str, dst_col: str):
    """Two key columns as dense int32 ids in one shared id space
    [0, n_unique), in order of first appearance (src column first).
    Returns (the frame [src_col, dst_col] int32, the map ['id', 'value'])."""
    both = pd.concat([df[src_col], df[dst_col]], ignore_index=True)
    codes, uniques = pd.factorize(both, use_na_sentinel=False)
    m = len(df)
    out = pd.DataFrame({
        src_col: codes[:m].astype(np.int32),
        dst_col: codes[m:].astype(np.int32),
    })
    map_df = pd.DataFrame({
        "id": np.arange(len(uniques), dtype=np.int32),
        "value": np.asarray(uniques),
    })
    return out, map_df


def renumber_multi_columns(df: pd.DataFrame, src_cols: list, dst_cols: list):
    """Composite keys over several columns as dense int32 ids (NumberMap's
    multi-column mode, python/cugraph/cugraph/structure/number_map.py:480).
    Keys compare by value in their own dtypes; the map frame holds
    ['id', 'key_0', ...] in those dtypes."""
    src_idx = pd.MultiIndex.from_frame(
        df[src_cols].set_axis(range(len(src_cols)), axis=1))
    dst_idx = pd.MultiIndex.from_frame(
        df[dst_cols].set_axis(range(len(dst_cols)), axis=1))
    codes, uniques = pd.factorize(src_idx.append(dst_idx))
    e = len(df)
    out = pd.DataFrame({"src": codes[:e].astype(np.int32),
                        "dst": codes[e:].astype(np.int32)})
    map_df = uniques.to_frame(index=False)
    map_df.columns = [f"key_{i}" for i in range(map_df.shape[1])]
    map_df.insert(0, "id", np.arange(len(uniques), dtype=np.int32))
    return out, map_df
