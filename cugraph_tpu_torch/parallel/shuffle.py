"""Distributed shuffle: route (key, payload) tuples to the keys' owners.

Counterpart of ``cugraph_tpu/parallel/shuffle.py`` (reference
utilities/shuffle_comm.cuh:467 ``groupby_gpu_id_and_shuffle_values``,
:533 ``..._kv_pairs``).  XLA needs static shapes, so the JAX package
exchanges fixed-capacity buckets in two stages (along "major", then
"minor") and retries with a doubled capacity when one overflows; here
the ranks first exchange their counts, then one ``all_to_all_single``
with those split sizes moves every tuple straight to its owner.  So
``capacity`` is accepted and does nothing, and the result holds the
arrived tuples only, with no -1 padding.  The arrivals
are put in the JAX package's order (its two stages deliver them by the
sender's mesh column, then its row, each sender's tuples in their
order): the order that sorting the JAX result's valid slots by position
gives.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cugraph_tpu_torch.parallel.prims import block_segment_reduce


def exchange_counts(mesh, send_counts: torch.Tensor) -> torch.Tensor:
    """Per-target send counts [P] (int64, on ``mesh.device``) → the
    per-sender receive counts [P]."""
    recv = torch.empty_like(send_counts)
    dist.all_to_all_single(recv, send_counts, group=mesh.world)
    return recv


def all_to_all(mesh, x: torch.Tensor, send: list, recv: list):
    """One variable-size exchange along dim 0: ``send[t]`` rows to mesh
    position t (``x`` grouped by target), ``recv[s]`` rows from s."""
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=mesh.world)
    return out


def _jax_order(recv: list, pmaj: int, pmin: int) -> torch.Tensor:
    """Positions of the arrivals (grouped by sender position
    i·pmin + j) in the order (j, i, own order)."""
    starts = np.concatenate([[0], np.cumsum(recv)])
    senders = sorted(range(pmaj * pmin), key=lambda s: (s % pmin, s // pmin))
    return torch.from_numpy(np.concatenate(
        [np.arange(starts[s], starts[s + 1]) for s in senders]
        + [np.zeros(0, np.int64)]))


def shuffle_to_owners(mesh, part, keys, payload, *,
                      capacity: int | None = None):
    """Route this rank's (key, payload) tuples to the ranks owning ``key``
    (``part.owner``); key −1 is an empty slot and stays.  ``payload`` has
    the keys' leading dim.  Returns this rank's arrived (keys, payload)
    on ``mesh.device``."""
    del capacity
    keys = torch.as_tensor(keys).to(mesh.device)
    payload = torch.as_tensor(payload).to(mesh.device)
    valid = keys >= 0
    keys, payload = keys[valid], payload[valid]
    target = (keys // part.chunk).to(torch.int64)
    order = torch.sort(target, stable=True).indices
    send_counts = torch.bincount(target, minlength=mesh.size)
    recv_counts = exchange_counts(mesh, send_counts)
    send, recv = send_counts.tolist(), recv_counts.tolist()
    k_out = all_to_all(mesh, keys[order], send, recv)
    p_out = all_to_all(mesh, payload[order], send, recv)
    pos = _jax_order(recv, mesh.pmaj, mesh.pmin).to(mesh.device)
    return k_out[pos], p_out[pos]


def shuffle_reduce_by_key(mesh, part, keys, values, op: str = "sum"):
    """Shuffle values to their keys' owners and reduce them per key
    (``shuffle_comm.cuh:533`` + the owner-side reduce).  Returns this
    rank's dense owned slice [Vc]: the sum, min or max of the tuples of
    each key (0 for sum, the dtype's max for min and min for max where a
    key has none, as ``jax.ops.segment_*``)."""
    ko, vo = shuffle_to_owners(mesh, part, keys, values)
    local = ko.to(torch.int64) - mesh.rank * part.chunk
    return block_segment_reduce(vo, local, part.chunk, op)
