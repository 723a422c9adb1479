"""Shared sampling-frontier state machine (sampling_flags_t semantics,
reference sampling_functions.hpp:36-76 + prepare_next_frontier_impl.cuh).

A copy of ``cugraph_tpu.algos._frontier``, which is NumPy only: the port
keeps its own so that it never imports the JAX package.

One implementation of the per-label frontier rules consumed by all three
multi-hop drivers (SG homogeneous, SG masked het/temporal, MG core):

* frontiers are per-BATCH (label) (vertex, batch[, time]) tuples WITH
  multiplicity — dedupe only under ``dedupe_sources``;
* ``prior_sources_behavior``: "default" (next frontier = sampled
  destinations), "carry_over" (+ the current frontier, hence inductively
  every prior source), "exclude" (drop destinations already used as a
  source in the batch).
"""

from __future__ import annotations

import numpy as np

BEHAVIORS = ("default", "carry_over", "exclude")

# reference temporal comparison modes (sampling_functions.hpp:38-46,
# temporal_sampling_comparison_t; pyx spelling, heterogeneous_*_temporal_
# neighbor_sample.pyx:210-212).  "last" = deterministic recency: among
# edges in the vertex's past, take the k most recent.
TEMPORAL_COMPARISONS = ("strictly_increasing", "monotonically_increasing",
                        "strictly_decreasing", "monotonically_decreasing",
                        "last")


def pop_dedupe_sources(kw: dict) -> bool:
    """Pop the dedupe flag under either spelling (dedupe_sources here and in
    the C API; deduplicate_sources in the reference pyx) — the single alias
    rule every driver shares."""
    v = kw.pop("dedupe_sources", None)
    alias = kw.pop("deduplicate_sources", None)
    if v is None:
        v = alias
    return bool(v) if v is not None else False


def resolve_temporal_comparison(comparison, strict: bool = True) -> str:
    """Normalize the (comparison, legacy strict bool) pair to one mode."""
    if comparison is None:
        return "strictly_increasing" if strict else "monotonically_increasing"
    c = str(comparison).lower()
    if c not in TEMPORAL_COMPARISONS:
        raise ValueError(f"unknown temporal_sampling_comparison {comparison!r}"
                         f"; options: {TEMPORAL_COMPARISONS}")
    return c


def temporal_eligible(t, lim, comparison: str):
    """Edge-time eligibility vs the frontier vertex's arrival time (works on
    numpy and jax arrays)."""
    if comparison == "strictly_increasing":
        return t > lim
    if comparison == "monotonically_increasing":
        return t >= lim
    if comparison == "strictly_decreasing":
        return t < lim
    if comparison == "monotonically_decreasing":
        return t <= lim
    if comparison == "last":
        return t < lim
    raise ValueError(comparison)


class FrontierState:
    """(vertex, batch[, time]) frontier with the reference's flag rules.

    ``key_mod``: multiplier making (batch, vertex) keys unique
    (≥ the vertex id space size).
    """

    def __init__(self, vertices, batches, key_mod: int, *,
                 prior_sources_behavior: str = "default",
                 dedupe_sources: bool = False, times=None,
                 batch_id_list=None):
        self.behavior = (prior_sources_behavior or "default").lower()
        if self.behavior == "carryover":   # the reference pyx spelling
            self.behavior = "carry_over"
        if self.behavior not in BEHAVIORS:
            raise ValueError(f"unknown prior_sources_behavior "
                             f"{prior_sources_behavior!r}")
        self.dedupe = bool(dedupe_sources)
        self.key_mod = max(int(key_mod), 1)
        self.v = np.asarray(vertices)
        if batch_id_list is not None:
            batches = np.asarray(batch_id_list, np.int32)
            if len(batches) != len(self.v):
                raise ValueError("batch_id_list must align with start_list")
        self.b = np.asarray(batches, np.int32)
        self.t = None if times is None else np.asarray(times, np.float32)
        self._prior = np.empty(0, np.int64)

    def __len__(self):
        return len(self.v)

    def _key(self, v, b):
        return b.astype(np.int64) * self.key_mod + v

    def begin_hop(self):
        """Apply dedupe_sources; returns the (v, b[, t]) arrays to sample.

        Temporal + dedupe keeps the MIN arrival time per (batch, vertex) —
        the canonical choice (the reference's thrust sort/unique keeps an
        implementation-defined instance; earliest-arrival is deterministic
        AND a pure function of the row SET, which is what lets the fused
        device path reproduce it exactly with a min-reduce time plane)."""
        if self.dedupe and len(self.v):
            if self.t is not None:
                keys = self._key(self.v, self.b)
                order = np.lexsort((self.t, keys))
                ks = keys[order]
                first = np.ones(len(ks), bool)
                first[1:] = ks[1:] != ks[:-1]
                idx = np.sort(order[first])   # each key's min-time row,
                self.v, self.b = self.v[idx], self.b[idx]  # arrival order
                self.t = self.t[idx]
            else:
                _, idx = np.unique(self._key(self.v, self.b),
                                   return_index=True)
                idx.sort()
                self.v, self.b = self.v[idx], self.b[idx]
        return self.v, self.b, self.t

    def advance(self, dest_v, dest_b, dest_t=None):
        """Fold this hop's sampled destinations into the next frontier."""
        nv = np.asarray(dest_v)
        nb = np.asarray(dest_b, np.int32)
        nt = None if dest_t is None else np.asarray(dest_t, np.float32)
        src_keys = np.unique(self._key(self.v, self.b))
        if self.behavior == "exclude":
            self._prior = np.union1d(self._prior, src_keys)
            keep = ~np.isin(self._key(nv, nb), self._prior)
            nv, nb = nv[keep], nb[keep]
            nt = nt[keep] if nt is not None else None
        elif self.behavior == "carry_over":
            nv = np.concatenate([nv, self.v])
            nb = np.concatenate([nb, self.b])
            if nt is not None:
                nt = np.concatenate([nt, self.t])
        self.v, self.b, self.t = nv.astype(self.v.dtype), nb, nt
