"""Memory helpers: sizing a graph before it is built, the card's memory
counters, and a host array staged to the card on demand (reference
large_buffer_manager, host_staging_buffer_manager, RMM pool statistics;
SURVEY.md N30).

Counterpart of ``cugraph_tpu.utils.memory``.  ``estimate_graph_bytes``
sizes the port's own ``GraphStructure`` (``core/structure.py``: unpadded,
no ``majors``), not the JAX package's padded one, and
``estimate_dist_graph_bytes`` the port's ``DistGraph``
(``parallel/partition.py``: per-rank CSR blocks, no ``valid`` mask, no
``E_ALIGN`` padding).
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import resolve_device


def estimate_graph_bytes(num_vertices: int, num_edges: int, *,
                         weighted: bool = True, both_orientations: bool = True,
                         dtype_bytes: int = 4) -> int:
    """Device bytes of a ``GraphStructure`` built from an edge list, per
    orientation: int32 offsets (V + 1), int32 indices, the kept int32
    sort permutation and the weights (E each; stored as 1.0 when the
    graph is unweighted, so ``weighted`` changes nothing)."""
    per = (num_vertices + 1) * 4 + num_edges * (4 + 4 + dtype_bytes)
    return per * (2 if both_orientations else 1)


def estimate_dist_graph_bytes(num_vertices: int, num_edges: int, pmaj: int,
                              pmin: int, *, store_push: bool = True,
                              store_eid: bool = False) -> int:
    """Device bytes of a ``DistGraph`` summed over its pmaj·pmin ranks:
    per orientation and rank, int32 offsets over the pmaj·Vc dst slots
    (+1), and per edge an int32 source slot and a float32 weight (stored
    as 1.0 when unweighted); the push block's int32 instance index with
    ``store_eid`` (``build_dist_graph`` keeps it for weighted or property
    graphs); each rank's two float32 degree vectors [Vc]."""
    p = pmaj * pmin
    chunk = -(-max(-(-num_vertices // p) * p // p, 1) // 8) * 8
    per = p * (pmaj * chunk + 1) * 4 + num_edges * 8
    orient = per * (2 if store_push else 1)
    eid = num_edges * 4 if store_push and store_eid else 0
    return orient + eid + 2 * p * chunk * 4


def device_memory_stats(device=None) -> dict:
    """Bytes in use, the card's total and the peak in use (the RMM pool
    statistics analog), from ``torch.cuda.memory_stats`` and
    ``torch.cuda.mem_get_info``; -1 for a device with no such counters
    (the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": -1, "bytes_limit": -1,
                "peak_bytes_in_use": -1}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
        "bytes_limit": torch.cuda.mem_get_info(dev)[1],
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
    }


def fits_on_device(num_vertices: int, num_edges: int, device=None,
                   safety: float = 0.8) -> bool:
    """Whether the structure's bytes fit in ``safety`` of what is free;
    True where the device has no counters."""
    stats = device_memory_stats(device)
    limit = stats["bytes_limit"]
    if limit in (-1, 0, None):
        return True  # unknown: let the allocator decide
    need = estimate_graph_bytes(num_vertices, num_edges)
    avail = limit - max(stats["bytes_in_use"], 0)
    return need <= avail * safety


class HostStagingBuffer:
    """A cold array kept on the host, copied to a device on demand through
    pinned memory and dropped after use (host_staging_buffer_manager.hpp
    analog)."""

    def __init__(self, array: np.ndarray):
        self._host = np.asarray(array)
        self._device = None

    def to_device(self, device=None, *, mesh=None) -> torch.Tensor:
        """The array on ``device`` (None: the card); with a
        ``parallel.Mesh2D``, this rank's equal chunk of its rows on
        ``mesh.device`` (the JAX package's vertex-sharded placement), the
        row count a multiple of the mesh size."""
        if self._device is None:
            host = self._host
            if mesh is not None:
                rows = host.shape[0]
                if rows % mesh.size:
                    raise ValueError(f"{rows} rows do not split into "
                                     f"{mesh.size} equal chunks")
                c = rows // mesh.size
                host = host[mesh.rank * c:(mesh.rank + 1) * c]
                device = mesh.device
            dev = resolve_device(device)
            t = torch.from_numpy(np.ascontiguousarray(host))
            self._device = (t.pin_memory().to(dev, non_blocking=True)
                            if dev.type == "cuda" else t.clone())
        return self._device

    def release(self):
        self._device = None

    @property
    def nbytes(self) -> int:
        return self._host.nbytes
