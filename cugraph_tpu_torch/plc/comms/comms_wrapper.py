"""init_subcomms — the 2D subcommunicator bootstrap on a ResourceHandle.

Counterpart of ``cugraph_tpu/plc/comms/comms_wrapper.py``; mirrors
pylibcugraph/comms/comms_wrapper.pyx:14 ``init_subcomms(handle,
row_comm_size)``: the reference splits the raft communicator into a
row(major) × col(minor) 2D grid.  Here the grid is a ``parallel.Mesh2D``
over the initialised default process group, whose row and column process
groups are the subcommunicators; it is attached to the handle, and MGGraph
construction on that handle uses it.
"""

from __future__ import annotations

__all__ = ["init_subcomms"]


def init_subcomms(handle, row_comm_size):
    """Attach a row_comm_size × (world size // row_comm_size) mesh on the
    handle's device.  Every rank of the default group calls it."""
    import torch.distributed as dist

    from cugraph_tpu_torch.parallel.mesh import make_mesh_2d

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call "
                           "cugraph_comms_init or init_process_group first")
    n = dist.get_world_size()
    row = int(row_comm_size)
    if row <= 0 or n % row:
        raise ValueError(
            f"row_comm_size {row} does not divide device count {n}")
    handle.mesh = make_mesh_2d(row, n // row, device=handle._device_arg)
    handle.device = handle.mesh.device
    return handle
