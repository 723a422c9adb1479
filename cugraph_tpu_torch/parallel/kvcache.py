"""(key, value)-compressed minor-block endpoint cache.

Counterpart of ``cugraph_tpu/parallel/kvcache.py`` (reference: the
hypersparse (key, value) endpoint property caches of graph_view.hpp:
239-242 and the compressed edge-property update path,
update_edge_src_dst_property.cuh:163-224 "kv_store" branch).

``prims.gather_minor_block`` gathers the whole pmin·Vc row block on every
rank of a mesh row, however few of those sources the rank's edges touch.
This cache exchanges only the referenced values:

* build (``build_minor_cache``, collective): each rank's requests are the
  sorted distinct sources of its pull block (``indices``), split by the
  row peer that owns them; one count exchange and one ``all_to_all`` on
  the row group deliver each request list to its owner, which keeps it as
  its ``send_idx``.  Lists are padded to R, the longest over the mesh
  (an all-reduce MAX, as U), so the value exchange is one equal-split
  ``all_to_all`` and ``perm_recv`` lands each value at its source's rank
  among the distinct ones; ``src_comp`` is every edge's source in that
  order.  A rank holds only its own part, the JAX package's slice [i, j].
* run (``pull_spmv_compressed``): one row-group ``all_to_all`` of the
  requested values, K1 (mul) over the pull block's rows with ``src_comp``
  as column indices, and the reduce-scatter along the column group.  The
  rows, their edges and their order are ``prims.pull_spmv``'s, and each
  edge reads the same value, so the result is ``pull_spmv``'s bit for bit.

Memory per rank: U (distinct sources) + pmin·R (exchange buffer) instead
of pmin·Vc.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from cugraph_tpu_torch.kernels.spmv import spmv_csr
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import DistGraph, _pad_rows


@dataclass(frozen=True)
class MinorCache:
    """This rank's static compressed-gather routing for one DistGraph's
    pull block."""

    send_idx: torch.Tensor    # int32 [pmin, R] positions in the own slice
    send_valid: torch.Tensor  # bool  [pmin, R]
    perm_recv: torch.Tensor   # int64 [U] into the flattened [pmin·R] buffer
    src_comp: torch.Tensor    # int32 [E] each edge's compressed source
    u_max: int                # the most distinct sources on a rank (≥ 1)
    r_max: int                # R: the longest request list (≥ 1)
    block: int                # pmin·Vc, the gathered row block's length

    @property
    def compression_ratio(self) -> float:
        """Replicated-block entries per compressed-cache entry (>1 = win):
        the JAX package's value, from the mesh-wide U and R."""
        return float(self.block) / max(
            self.u_max + self.send_idx.shape[0] * self.r_max, 1)


def _max_over_ranks(mesh, value: int) -> int:
    x = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.world)
    return int(x.item())


def build_minor_cache(g: DistGraph, mesh) -> MinorCache:
    """This rank's cache of ``g``'s pull block; every rank calls it."""
    chunk, pmin, dev = g.chunk, g.pmin, mesh.device
    src = g.pull.indices.to(torch.int64)
    u = torch.unique(src)                 # sorted
    owner = u // chunk
    counts = torch.bincount(owner, minlength=pmin)
    u_max = _max_over_ranks(mesh, max(len(u), 1))
    r_max = _max_over_ranks(mesh, max(int(counts.max()) if len(u) else 0,
                                      1))
    # requests to each row peer j2, in sorted order (u is sorted)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=mesh.minor)
    asked = torch.empty(int(recv_counts.sum()), dtype=torch.int64,
                        device=dev)
    dist.all_to_all_single(asked, u % chunk,
                           output_split_sizes=recv_counts.tolist(),
                           input_split_sizes=counts.tolist(),
                           group=mesh.minor)
    # what this rank sends each peer = what that peer asked of it
    send_idx = torch.zeros(pmin, r_max, dtype=torch.int32, device=dev)
    send_valid = torch.zeros(pmin, r_max, dtype=torch.bool, device=dev)
    peer = torch.repeat_interleave(torch.arange(pmin, device=dev),
                                   recv_counts)
    slot = torch.arange(len(asked), device=dev) - torch.repeat_interleave(
        torch.cumsum(recv_counts, 0) - recv_counts, recv_counts)
    send_idx[peer, slot] = asked.to(torch.int32)
    send_valid[peer, slot] = True
    # where each distinct source lands in the received buffer
    first = torch.cumsum(counts, 0) - counts
    rank_in_peer = torch.arange(len(u), device=dev) - first[owner]
    perm_recv = owner * r_max + rank_in_peer
    src_comp = torch.searchsorted(u, src).to(torch.int32)
    return MinorCache(send_idx=send_idx, send_valid=send_valid,
                      perm_recv=perm_recv, src_comp=src_comp, u_max=u_max,
                      r_max=r_max, block=pmin * chunk)


def fetch_compressed(mesh, cache: MinorCache,
                     x_own: torch.Tensor) -> torch.Tensor:
    """The requested values exchanged along the row group: this rank's
    compressed cache [U], in distinct-source order."""
    vals = torch.where(cache.send_valid,
                       x_own[cache.send_idx.to(torch.int64)], 0.0)
    recv = torch.empty_like(vals)
    dist.all_to_all_single(recv, vals.contiguous(), group=mesh.minor)
    return recv.reshape(-1)[cache.perm_recv]


def pull_spmv_compressed(g: DistGraph, cache: MinorCache, mesh,
                         x_own: torch.Tensor) -> torch.Tensor:
    """y[dst] = Σ w·x[src] through the compressed cache, x and y owned
    slices [Vc]: ``prims.pull_spmv`` with O(U + pmin·R) gathered memory
    instead of O(pmin·Vc).  K1 (mul) takes square CSRs, so the rows and
    the cache are padded to the larger of the two."""
    b = g.pull
    x_comp = fetch_compressed(mesh, cache, x_own)
    side = max(b.num_segments, x_comp.shape[0])
    part = spmv_csr(_pad_rows(b.offsets, side), cache.src_comp, b.weights,
                    prims.pad_rows(x_comp, side), "mul")
    return prims.scatter_reduce_major_sum(mesh, part[:b.num_segments])
