"""pylibcugraph.comms parity (comms_wrapper.pyx + cugraph_nccl_comms.py).

Counterpart of ``cugraph_tpu.plc.comms`` over ``torch.distributed``."""

from cugraph_tpu_torch.plc.comms.comms_wrapper import init_subcomms
from cugraph_tpu_torch.plc.comms.cugraph_comms import (
    cugraph_comms_create_unique_id,
    cugraph_comms_get_raft_handle,
    cugraph_comms_init,
    cugraph_comms_shutdown,
)

# reference import-path spelling: pylibcugraph.comms.cugraph_nccl_comms
from cugraph_tpu_torch.plc.comms import cugraph_comms as cugraph_nccl_comms  # noqa

__all__ = [
    "init_subcomms",
    "cugraph_comms_init",
    "cugraph_comms_shutdown",
    "cugraph_comms_create_unique_id",
    "cugraph_comms_get_raft_handle",
    "cugraph_nccl_comms",
]
