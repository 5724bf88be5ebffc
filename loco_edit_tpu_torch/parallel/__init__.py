from loco_edit_tpu_torch.core.mesh import (
    DATA_AXIS,
    PROBE_AXIS,
    initialize_distributed,
    local_mesh,
    make_mesh,
    replicated,
    shard_leading,
)
from loco_edit_tpu_torch.parallel.checks import replicated_params_checksum

__all__ = [
    "DATA_AXIS",
    "PROBE_AXIS",
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
    "replicated",
    "shard_leading",
    "replicated_params_checksum",
]
