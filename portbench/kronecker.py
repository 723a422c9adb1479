"""The Graph500 Kronecker (R-MAT) edge generator, in torch on the device.

A frozen copy of the Graph500 reference generator (``kronecker_generator.m``
of the specification): per edge and per bit, one uniform draw picks the
source bit (1 with probability C + D) and a second the destination bit given
it; the vertex labels are then permuted at random, and so are the edges.
Self-loops are dropped, as LDBC Graphalytics' graph500 datasets have none;
duplicate edges stay, for the system under test to remove.  The benchmark
owns this copy so that a change to the port's own ``rmat`` cannot move the
inputs.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` taken modulo
    2**64, so that any whole number is a seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def kronecker_edges(scale: int, num_edges: int, gen: torch.Generator, *,
                    a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """(src, dst) int64 tensors on ``gen``'s device: ``num_edges`` Kronecker
    edges over 2**scale labels with the self-loops removed."""
    device = gen.device
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(num_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(num_edges, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(num_edges, generator=gen, device=device) > ab
        jj = torch.rand(num_edges, generator=gen, device=device) > torch.where(
            ii, c_norm, a_norm)
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    labels = torch.randperm(1 << scale, generator=gen, device=device)
    order = torch.randperm(num_edges, generator=gen, device=device)
    src, dst = labels[src[order]], labels[dst[order]]
    keep = src != dst
    return src[keep], dst[keep]
