"""Host-spill streamed SpMV for graphs whose edge structure exceeds the card.

Counterpart of ``cugraph_tpu.kernels.spill`` (the reference's
large_buffer_manager pinned-host spill,
cpp/include/cugraph/large_buffer_manager.hpp:28-60): the O(E) edge arrays
of one CSC stay on the host in pinned memory and stream through the card
one chunk of whole rows at a time, while the O(V) vector x stays on the
card whole.  Each chunk runs the hand-written kernels unchanged: K1
(``spmv.spmv_csr``) for sum, K2 (``semiring.spmv_semiring``) for min/max.

The JAX package pads every chunk to one tile shape so that one XLA
compilation serves them all, and splits a hub's block across chunks that
fold with the reduce.  Here a chunk holds whole rows (a row longer than the
budget gets a chunk of its own), so each chunk writes its own slice of y
and nothing folds, and a spilled sum equals the resident one bit for bit:

* K1 and K2 cut the edge array into spans at multiples of the span counted
  from edge 0 (``csrc/csr_spans.cuh``), and a heavy row sums its span
  pieces in span order.  A chunk whose first edge is o therefore starts its
  device arrays at the aligned edge o - o % SPILL_ALIGN, with a leading
  *ghost row* holding those o % SPILL_ALIGN edges; every span boundary
  keeps its place, and the ghost row's output is dropped.  Light rows sum
  from their own first edge, wherever it lies.
* On the card a side stream copies chunk i + 1 from pinned memory into
  the second of two device buffers while the current stream runs chunk i;
  events order the two, and nothing in the loop waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import check_edge_count, resolve_device
from cugraph_tpu_torch.kernels import semiring, spmv

# chunk starts are aligned to every span K1 and K2 cut the edges at
SPILL_ALIGN = math.lcm(spmv.SPMV_SPAN, semiring.SPMV_SEMIRING_SPAN)
REDUCES = ("sum", "min", "max")
BUFFER_ALIGN = 256  # bytes: where each array of a device buffer starts


@dataclass(frozen=True)
class SpilledSpmvPlan:
    """One CSC (edges sorted by (dst, src), stably, as ``build_csr`` sorts
    them) on the host, cut into chunks of whole rows.

    ``indices``, ``weights`` and ``chunk_offsets`` are pinned when the plan
    was built for the card, allocated once.  Chunk i covers rows
    ``ranges[i] = (r0, r1)`` and the edges ``edge_ranges[i] = (e0, e1)``,
    e0 = offsets[r0] rounded down to a multiple of ``align``; its local
    int32 offsets (rows r1 - r0 + 1, the ghost row first) start at
    ``chunk_offsets[offset_starts[i]]``.  On the card a chunk lands in one
    of two byte buffers of ``chunk_bytes()``, the largest chunk's
    ``_layout``: at most the build's budget unless one row alone exceeds
    it.  ``capacity`` is the most edges a chunk holds, its ghost row's
    included."""

    offsets: torch.Tensor        # int64 [V + 1]: whole-graph row offsets
    indices: torch.Tensor        # int32 [E]: source of each in-edge
    weights: torch.Tensor        # float32 [E]
    chunk_offsets: torch.Tensor  # int32: each chunk's local offsets
    ranges: tuple                # ((r0, r1), ...): [0, V) in order
    edge_ranges: tuple           # ((e0, e1), ...): each chunk's edges
    offset_starts: tuple         # each chunk's start in chunk_offsets
    capacity: int                # edges per chunk at most
    buffer_bytes: int            # one device buffer: the largest chunk
    num_vertices: int
    align: int
    pinned: bool                 # built for the card: the host arrays pinned

    @property
    def pad_v(self) -> int:
        """The length of x and y: the vertex count (nothing is padded)."""
        return self.num_vertices

    @property
    def num_chunks(self) -> int:
        return len(self.ranges)

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def chunk_bytes(self) -> int:
        """Bytes of one of the two device buffers."""
        return self.buffer_bytes

    def materialize_chunk(self, i: int):
        """(local offsets int32 [rows + 2], indices, weights) of chunk i:
        host views into the plan's arrays, no copy."""
        r0, r1 = self.ranges[i]
        e0, e1 = self.edge_ranges[i]
        c0 = self.offset_starts[i]
        return (self.chunk_offsets[c0:c0 + r1 - r0 + 2],
                self.indices[e0:e1], self.weights[e0:e1])

    @property
    def chunks(self):
        """Every chunk's host views (tests and introspection; the stream
        takes one at a time)."""
        return tuple(self.materialize_chunk(i)
                     for i in range(self.num_chunks))


def _sorted_csc(src, dst, weight, num_vertices, pin):
    """int64 offsets, and int32 indices and float32 weights allocated once
    (pinned for the card): the stable sort of the int64 key dst << 32 | src,
    ``build_csr``'s order, whose low word is the source."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    m = src.shape[0]
    if dst.shape[0] != m or (weight is not None and len(weight) != m):
        raise ValueError("src, dst and weight differ in length")
    if m and not (0 <= min(src.min(), dst.min())
                  and max(src.max(), dst.max()) < num_vertices):
        raise ValueError(f"a vertex id lies outside [0, {num_vertices})")
    # a copy: the key is built in place
    key = torch.from_numpy(np.array(dst, np.int64)).bitwise_left_shift_(32)
    key.bitwise_or_(torch.from_numpy(np.asarray(src, np.int64)))
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key >> 32, minlength=num_vertices)
    offsets = torch.zeros(num_vertices + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    indices = torch.empty(m, dtype=torch.int32, pin_memory=pin)
    indices.copy_(key.bitwise_and_(0xFFFFFFFF))
    del key
    weights = torch.empty(m, dtype=torch.float32, pin_memory=pin)
    if weight is None:
        weights.fill_(1.0)
    else:
        torch.index_select(torch.from_numpy(np.asarray(weight, np.float32)),
                           0, order, out=weights)
    return offsets, indices, weights


def _layout(rows: int, edges: int):
    """Byte offsets of the indices and the weights in a device buffer that
    holds a chunk of ``rows`` rows (the ghost row not counted) and
    ``edges`` edges (its own included), after its local offsets, each
    array on a BUFFER_ALIGN boundary; and the buffer's bytes."""
    a = -(-4 * (rows + 2) // BUFFER_ALIGN) * BUFFER_ALIGN
    b = a + -(-4 * edges // BUFFER_ALIGN) * BUFFER_ALIGN
    return a, b, b + 4 * edges


def _row_ranges(offsets: np.ndarray, max_chunk_bytes: int, align: int):
    """Greedy chunks of whole rows: as many rows as fit max_chunk_bytes at
    8 bytes an edge and 4 a row, less room for a ghost row of align - 1
    edges, two more offsets and the layout's padding; a row that does not
    fit alone gets a chunk of its own."""
    n = offsets.shape[0] - 1
    cost = offsets * 8 + np.arange(n + 1, dtype=np.int64) * 4
    room = max_chunk_bytes - 8 * (align - 1) - 8 - 2 * BUFFER_ALIGN
    ranges, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(cost, cost[r0] + room, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        ranges.append((r0, r1))
        r0 = r1
    return ranges


def build_spilled_spmv_plan(src, dst, weight, num_vertices: int,
                            max_chunk_bytes: int = 256 << 20, *,
                            device=None) -> SpilledSpmvPlan:
    """The host CSC of the edge list (src, dst, weight; weight None is 1.0)
    over ``num_vertices`` rows, cut into chunks whose device buffer fits
    ``max_chunk_bytes`` where rows allow.  ``device`` is the card the plan
    streams to (None: the card), whose host arrays are pinned; a CPU plan's
    are not.  The whole graph may exceed 2^31 edges; each chunk may not."""
    if max_chunk_bytes <= 0:
        raise ValueError("max_chunk_bytes must be positive")
    align = SPILL_ALIGN
    pin = resolve_device(device).type == "cuda"
    offsets, indices, weights = _sorted_csc(src, dst, weight, num_vertices,
                                            pin)
    off = offsets.numpy()
    ranges = _row_ranges(off, max_chunk_bytes, align)
    edge_ranges = [(int(off[r0] - off[r0] % align), int(off[r1]))
                   for r0, r1 in ranges]
    starts = np.cumsum([0] + [r1 - r0 + 2 for r0, r1 in ranges])
    chunk_offsets = torch.empty(int(starts[-1]), dtype=torch.int32,
                                pin_memory=pin)
    local = chunk_offsets.numpy()
    for (r0, r1), (e0, e1), c0 in zip(ranges, edge_ranges, starts):
        check_edge_count(e1 - e0)
        local[c0] = 0
        local[c0 + 1:c0 + r1 - r0 + 2] = off[r0:r1 + 1] - e0
    return SpilledSpmvPlan(
        offsets=offsets, indices=indices, weights=weights,
        chunk_offsets=chunk_offsets, ranges=tuple(ranges),
        edge_ranges=tuple(edge_ranges),
        offset_starts=tuple(int(c) for c in starts[:-1]),
        capacity=max((e1 - e0 for e0, e1 in edge_ranges), default=0),
        buffer_bytes=max((_layout(r1 - r0, e1 - e0)[2] for (r0, r1), (
            e0, e1) in zip(ranges, edge_ranges)), default=0),
        num_vertices=num_vertices, align=align, pinned=pin)


def _chunk_kernel(reduce, combine):
    """The wrapper one chunk runs, and whether it reads the weights."""
    if reduce == "sum":
        return (lambda o, i, w, x: spmv.spmv_csr(o, i, w, x, combine,
                                                 square=False),
                combine == "mul")
    return (lambda o, i, w, x: semiring.spmv_semiring(
        o, i, w, x, reduce, combine, square=False), combine != "left")


def spmv_spilled(plan: SpilledSpmvPlan, x: torch.Tensor, reduce: str = "sum",
                 combine: str = "mul") -> torch.Tensor:
    """y [V] = REDUCE over each row's in-edges of COMBINE(x[src], w), the
    semantics of ``spmv_csr`` (sum) and ``spmv_semiring`` (min, max; a row
    with no edges gets the identity), on x's device.  On the card the
    chunks stream from the plan's pinned memory, one counted launch each;
    on the CPU each chunk runs the kernels' plain versions."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    if not isinstance(x, torch.Tensor) or x.dim() != 1 \
            or x.shape[0] != plan.num_vertices:
        raise ValueError(f"x must be a tensor of shape ({plan.num_vertices},)")
    kernel, needs_w = _chunk_kernel(reduce, combine)
    dtype = torch.float32 if reduce == "sum" else x.dtype
    y = torch.empty(plan.num_vertices, dtype=dtype, device=x.device)
    if x.device.type == "cuda":
        _stream_chunks(plan, x, y, kernel, needs_w)
    elif x.device.type == "cpu":
        for i, (r0, r1) in enumerate(plan.ranges):
            o, idx, w = plan.materialize_chunk(i)
            y[r0:r1] = kernel(o, idx, w if needs_w else None, x)[1:]
    else:
        raise ValueError(f"no spmv_spilled for device {x.device}")
    return y


def _stream_chunks(plan, x, y, kernel, needs_w):
    """Two device byte buffers: a side stream fills one from pinned memory
    while the current stream runs the kernel on the other.  ``copied[b]``
    orders a chunk's kernel after its copy, ``free[b]`` the next copy into
    buffer b after that kernel."""
    if not plan.pinned:
        raise ValueError("the plan's host arrays are not pinned: build it "
                         "for the card (device=None or 'cuda')")
    dev = x.device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    # the buffers reuse memory that work on the current stream may still use
    side.wait_stream(cur)
    bufs = [torch.empty(plan.chunk_bytes(), dtype=torch.uint8, device=dev)
            for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    free = [torch.cuda.Event(), torch.cuda.Event()]

    def stage(i):
        o, idx, w = plan.materialize_chunk(i)
        a, b, _ = _layout(o.shape[0] - 2, idx.shape[0])
        buf, ne = bufs[i % 2], idx.shape[0]
        views = [buf[:4 * o.shape[0]].view(torch.int32),
                 buf[a:a + 4 * ne].view(torch.int32),
                 buf[b:b + 4 * ne].view(torch.float32) if needs_w else None]
        with torch.cuda.stream(side):
            if i >= 2:
                side.wait_event(free[i % 2])
            for view, h in zip(views, (o, idx, w)):
                if view is not None:
                    view.copy_(h, non_blocking=True)
            copied[i % 2].record(side)
        return views

    staged = stage(0) if plan.num_chunks else None
    for i, (r0, r1) in enumerate(plan.ranges):
        o, idx, w = staged
        if i + 1 < plan.num_chunks:
            staged = stage(i + 1)
        cur.wait_event(copied[i % 2])
        part = kernel(o, idx, w, x)
        free[i % 2].record(cur)
        y[r0:r1].copy_(part[1:])
