"""Dask-free multi-process comms bootstrap.

Counterpart of ``cugraph_tpu/plc/comms/cugraph_comms.py``; mirrors
pylibcugraph/comms/cugraph_nccl_comms.py:69-182 (``nccl_init`` /
``cugraph_comms_init`` / ``cugraph_comms_shutdown`` /
``cugraph_comms_create_unique_id`` / ``cugraph_comms_get_raft_handle``),
the reference's torch/DDP-style launch path where each process brings up
NCCL from a broadcast unique id, builds a raft handle and splits the 2D
subcomms, with no Dask in the loop.

Here the transport is ``torch.distributed``: the "unique id" is the
``host:port`` of a ``TCPStore`` that rank 0 serves and every rank joins;
the group is NCCL on ``cuda:{device}``, or gloo for ``device="cpu"``; the
raft-handle analog is a ``ResourceHandle`` carrying the 2D ``Mesh2D``.
The grid split follows the reference's ``__get_2D_div``
(cugraph_nccl_comms.py:127-136).
"""

from __future__ import annotations

import datetime
import math
import socket

__all__ = [
    "cugraph_comms_init",
    "cugraph_comms_shutdown",
    "cugraph_comms_create_unique_id",
    "cugraph_comms_get_raft_handle",
]

_raft_handle = None
_initialized_distributed = False
_STORE_TIMEOUT = datetime.timedelta(seconds=300)


def _get_2D_div(ndevices):
    """(prows, pcols) split, reference cugraph_nccl_comms.py:127-136."""
    prows = int(math.sqrt(ndevices))
    while ndevices % prows != 0:
        prows = prows - 1
    return prows, int(ndevices / prows)


def _primary_ip():
    """Best-effort address other hosts can reach this one at (falls back to
    loopback on an isolated box).  The UDP connect never sends a packet —
    it only asks the kernel which interface would route out."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def cugraph_comms_create_unique_id(host=None):
    """The store address for rank 0 to broadcast (the NCCL-uid analog).

    Call it ON the rank-0 host: the address carries that host's reachable
    IP.  Pass ``host=`` to pin an interface (``"127.0.0.1"`` for ranks of
    one machine).  The port is free when probed; as with any
    probe-then-bind scheme it can race with other services, and rank 0's
    store then fails fast."""
    host = host or _primary_ip()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("0.0.0.0", 0))
        port = s.getsockname()[1]
    return f"{host}:{port}"


def _device(device):
    import torch

    if isinstance(device, str) and device == "cpu":
        return torch.device("cpu")
    if isinstance(device, torch.device):
        return device
    return torch.device(f"cuda:{int(device)}")


def cugraph_comms_init(rank, world_size, uid=None, device=0, **init_kwargs):
    """Bring up the process group and the 2D mesh handle.

    ``rank``/``world_size`` are process coordinates; ``uid`` is the store
    address from ``cugraph_comms_create_unique_id`` (required when
    ``world_size > 1``; a world of one uses a ``HashStore``).  ``device``
    is a card index (NCCL on ``cuda:{device}``) or ``"cpu"`` (gloo).
    ``init_kwargs`` go to ``init_process_group`` (``timeout`` also bounds
    the store's wait).  A group the caller already initialised is used as
    it is, and ``cugraph_comms_shutdown`` leaves it up."""
    global _raft_handle, _initialized_distributed
    if _raft_handle is not None:
        raise RuntimeError("cuGraph has already been initialized!")

    import torch.distributed as dist

    from cugraph_tpu_torch.plc.comms.comms_wrapper import init_subcomms
    from cugraph_tpu_torch.plc.graphs import ResourceHandle

    rank, world_size = int(rank), int(world_size)
    dev = _device(device)
    if not dist.is_initialized():
        if world_size > 1:
            if uid is None:
                raise ValueError("multi-process init needs the unique id "
                                 "(store address) from "
                                 "cugraph_comms_create_unique_id()")
            host, port = str(uid).rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world_size, rank == 0,
                                  timeout=init_kwargs.get(
                                      "timeout", _STORE_TIMEOUT))
        else:
            store = dist.HashStore()
        if dev.type != "cpu":
            init_kwargs.setdefault("device_id", dev)
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                store=store, rank=rank,
                                world_size=world_size, **init_kwargs)
        _initialized_distributed = True

    handle = ResourceHandle(device=dev)
    # row_comm_size = the FIRST element of the div (the reference's own
    # cugraph_nccl_comms.py:179 binds it as `pcols, _` despite __get_2D_div
    # documenting a (prows, pcols) return — we keep the value, not the name)
    row_comm_size, _ = _get_2D_div(dist.get_world_size())
    init_subcomms(handle, row_comm_size)
    _raft_handle = handle
    return handle


def cugraph_comms_shutdown():
    """Drop the handle, and destroy the process group if
    ``cugraph_comms_init`` started it."""
    global _raft_handle, _initialized_distributed
    if _initialized_distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
        _initialized_distributed = False
    _raft_handle = None


def cugraph_comms_get_raft_handle():
    return _raft_handle
