"""The 2D process mesh of the multi-device layer.

Counterpart of ``cugraph_tpu/parallel/mesh.py``.  The JAX layer is one
``shard_map`` program over a ``Mesh`` with the axes ("major", "minor");
here each device is one process (torchrun style), and the two axes are
``torch.distributed`` process groups: one "minor" group per mesh row (the
ranks (i, *), which gather a row block of sources) and one "major" group
per mesh column (the ranks (*, j), which reduce destination partials to
their owners).  Rank r sits at (i, j) = divmod(r, pmin), the row-major
device order of the JAX mesh (``mesh.py:37``).  NCCL carries the
collectives between cards and gloo between CPU processes (the tests);
a mesh never moves its tensors between the two.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """(pmaj, pmin) as close to square as possible, pmaj ≥ pmin."""
    pmin = int(math.isqrt(n_devices))
    while n_devices % pmin:
        pmin -= 1
    return n_devices // pmin, pmin


@dataclass(frozen=True)
class Mesh2D:
    """This process's place in a pmaj × pmin mesh.

    ``world`` is the group the mesh spans, ``minor`` this rank's row group
    (ranks (i, *), in j order), ``major`` its column group (ranks (*, j),
    in i order); ``ranks`` maps mesh position i·pmin + j to the global
    rank.  ``device`` holds every tensor of this rank."""

    pmaj: int
    pmin: int
    i: int
    j: int
    device: torch.device
    world: object
    minor: object
    major: object
    ranks: tuple

    @property
    def size(self) -> int:
        return self.pmaj * self.pmin

    @property
    def rank(self) -> int:
        """This rank's mesh position, i·pmin + j."""
        return self.i * self.pmin + self.j


def _backends(group) -> set:
    """The backend names of a group: "gloo", "nccl", or both for a group
    of several backends ("cpu:gloo,cuda:nccl")."""
    name = str(dist.get_backend(group))
    return {part.split(":")[-1] for part in name.split(",")}


def _device_for(device, backends: set) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' over a gloo group")
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else dist.get_rank() % torch.cuda.device_count())
        device = f"cuda:{index}"
    dev = torch.device(device)
    if dev.type == "cuda" and "nccl" not in backends:
        raise ValueError(f"a CUDA device ({dev}) over a {sorted(backends)} "
                         "group: the collectives of CUDA tensors need NCCL")
    if dev.type == "cpu" and "gloo" not in backends:
        raise ValueError(f"a CPU device over a {sorted(backends)} group: "
                         "the collectives of CPU tensors need gloo")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no mesh for device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return dev


def make_mesh_2d(pmaj: int | None = None, pmin: int | None = None, *,
                 group=None, device=None) -> Mesh2D:
    """The mesh over an initialised process group (the default one when
    ``group`` is None), which the caller brings up
    (``torch.distributed.init_process_group``).  Every process of the
    default group calls this, in the same order, since each builds every
    row and column group.  (pmaj, pmin) defaults to ``mesh_shape_for`` of
    the group's size; ``device`` defaults to ``cuda:$LOCAL_RANK`` (or the
    rank modulo the card count), and ``device="cpu"`` asks for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call "
                           "init_process_group first")
    world = group if group is not None else dist.group.WORLD
    ranks = tuple(dist.get_process_group_ranks(world))
    n = len(ranks)
    if pmaj is None or pmin is None:
        pmaj, pmin = mesh_shape_for(n)
    if pmaj * pmin != n:
        raise ValueError(f"a {pmaj}x{pmin} mesh over {n} ranks")
    dev = _device_for(device, _backends(world))
    rows = [dist.new_group([ranks[i * pmin + j] for j in range(pmin)])
            for i in range(pmaj)]
    cols = [dist.new_group([ranks[i * pmin + j] for i in range(pmaj)])
            for j in range(pmin)]
    i, j = divmod(ranks.index(dist.get_rank()), pmin)
    return Mesh2D(pmaj, pmin, i, j, dev, world, rows[i], cols[j], ranks)


def shard_dist_graph(g, mesh: Mesh2D):
    """This rank's DistGraph with every tensor moved to ``mesh.device``."""
    return g.to(mesh.device)
