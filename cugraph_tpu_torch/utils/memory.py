"""Memory helpers: sizing a graph before it is built, the card's memory
counters, and a host array staged to the card on demand (reference
large_buffer_manager, host_staging_buffer_manager, RMM pool statistics;
SURVEY.md N30).

Counterpart of ``cugraph_tpu.utils.memory``.  ``estimate_graph_bytes``
sizes the port's own ``GraphStructure`` (``core/structure.py``: unpadded,
no ``majors``), not the JAX package's padded one.  The multi-device
estimate waits for the port's multi-device layer.
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

    def to_device(self, device=None) -> torch.Tensor:
        if self._device is None:
            dev = resolve_device(device)
            t = torch.from_numpy(np.ascontiguousarray(self._host))
            self._device = (t.pin_memory().to(dev, non_blocking=True)
                            if dev.type == "cuda" else t.clone())
        return self._device

    def release(self):
        self._device = None

    @property
    def nbytes(self) -> int:
        return self._host.nbytes
