"""MTMG — multi-thread multi-device execution.

Counterpart of ``cugraph_tpu.mtmg`` (reference include/cugraph/mtmg/:
resource_manager/instance_manager own one raft handle per GPU, per-thread
handles bind thread → stream, a thread-safe edge-list append; SURVEY.md
N28).  The same shape of API, so MTMG-structured reference code ports
directly:

* ``ResourceManager``   — registers the usable devices
* ``InstanceManager``   — hands out per-thread handles round-robin
* ``PerThreadEdgelist`` — thread-safe chunked edge-list append + flush
* ``GraphHandle``       — builds the DistGraph once every thread flushed

The port runs one process per device (``torch.distributed``), so a
process drives the one device it owns: ``GraphHandle.create_graph``
builds this rank's DistGraph over the calling process's mesh (the
initialised default group), and an instance manager that holds more
devices than that one raises.  The JAX package's single process drives
every local device at once.
"""

from __future__ import annotations

import threading

import numpy as np


class ResourceManager:
    """Tracks which local devices participate (mtmg/resource_manager.hpp)."""

    def __init__(self):
        self._ranks = []

    def register_local_gpu(self, rank: int, device=None):
        """Register device ``rank``: ``cuda:{rank}`` unless ``device`` is
        given (``"cpu"`` allowed)."""
        import torch

        device = torch.device(device if device is not None
                              else f"cuda:{rank}")
        self._ranks.append((rank, device))

    # parity alias (reference naming)
    register_local_device = register_local_gpu

    def _sorted(self):
        return sorted(self._ranks, key=lambda t: t[0])

    def registered_ranks(self):
        return [r for r, _ in self._sorted()]

    def devices(self):
        return [d for _, d in self._sorted()]

    def create_instance_manager(self, ranks=None):
        devs = self.devices()
        if ranks is not None:
            devs = [d for (r, d) in self._sorted() if r in set(ranks)]
        return InstanceManager(devs)


class Handle:
    """Per-thread handle (mtmg/handle.hpp): a device binding."""

    def __init__(self, device, index: int):
        self.device = device
        self.index = index

    def get_rank(self) -> int:
        return self.index

    def sync(self):
        """Wait for the device's queued work (nothing on the CPU)."""
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)


class InstanceManager:
    """Round-robin handle dispenser (mtmg/instance_manager.hpp)."""

    def __init__(self, devices):
        self._devices = list(devices)
        if not self._devices:
            raise ValueError("no devices registered (register_local_gpu "
                             "before create_instance_manager)")
        self._next = 0
        self._lock = threading.Lock()

    def get_handle(self) -> Handle:
        with self._lock:
            i = self._next
            self._next = (self._next + 1) % len(self._devices)
        return Handle(self._devices[i], i)

    def size(self) -> int:
        return len(self._devices)


class PerThreadEdgelist:
    """Thread-safe chunked append of (src, dst[, wgt]) edges
    (mtmg/per_thread_edgelist.hpp).  Each thread appends into its own chunk
    list; ``consolidate`` concatenates everything."""

    def __init__(self, handle: Handle | None = None, chunk_size: int = 1 << 20):
        self._local = threading.local()
        self._all = []
        self._lock = threading.Lock()
        # parity knob: the reference flushes per-thread staging buffers at
        # this granularity; chunks here are host lists already, so it only
        # bounds the per-append coalescing below (not a correctness knob)
        self.chunk_size = chunk_size

    def _bufs(self):
        if not hasattr(self._local, "bufs"):
            self._local.bufs = ([], [], [])
            with self._lock:
                self._all.append(self._local.bufs)
        return self._local.bufs

    def append(self, src, dst, wgt=None):
        src = np.atleast_1d(np.asarray(src))
        dst = np.atleast_1d(np.asarray(dst))
        if len(src) != len(dst):
            raise ValueError(f"src/dst length mismatch: {len(src)} vs "
                             f"{len(dst)}")
        if wgt is not None:
            wgt = np.atleast_1d(np.asarray(wgt))
            if len(wgt) != len(src):
                raise ValueError(f"wgt length mismatch: {len(wgt)} weights "
                                 f"for {len(src)} edges")
        # append the TRIPLE under the lock so a concurrent consolidate()
        # can never observe a torn (src-without-dst) chunk
        s, d, w = self._bufs()
        with self._lock:
            s.append(src)
            d.append(dst)
            if wgt is not None:
                w.append(wgt)

    def flush(self):  # parity no-op: chunks are already host-resident
        pass

    def consolidate(self):
        with self._lock:
            srcs = [np.concatenate(s) for s, _, _ in self._all if s]
            dsts = [np.concatenate(d) for _, d, _ in self._all if d]
            ws = [np.concatenate(w) for _, _, w in self._all if w]
        src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
        w = np.concatenate(ws) if ws else None
        if w is not None and len(w) != len(src):
            raise ValueError(
                "mixed weighted/unweighted appends: every append must either "
                f"include wgt or none may ({len(w)} weights for {len(src)} edges)")
        return src, dst, w


class GraphHandle:
    """Builds the 2D-partitioned DistGraph from a consolidated edge list
    (mtmg graph view analog) over this process's mesh."""

    def __init__(self, instance_manager: InstanceManager):
        self.im = instance_manager

    def create_graph(self, edgelist: PerThreadEdgelist, num_vertices=None,
                     symmetrize: bool = False):
        """(this rank's DistGraph, mesh) over the initialised default
        process group (``make_mesh_2d`` raises without one), on the one
        device this process owns: an instance manager holding more
        raises."""
        from cugraph_tpu_torch.parallel import build_dist_graph
        from cugraph_tpu_torch.parallel.mesh import make_mesh_2d

        if self.im.size() != 1:
            raise ValueError(
                f"{self.im.size()} devices registered: the port runs one "
                "process per device, so each process registers the one "
                "device it owns")
        mesh = make_mesh_2d(device=self.im._devices[0])
        src, dst, w = edgelist.consolidate()
        n = (int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
             if num_vertices is None else num_vertices)
        g = build_dist_graph(src, dst, w, n, mesh, store_push=True,
                             symmetrize=symmetrize)
        return g, mesh
