"""Multi-device: the library models' cell-indexed operators split over the
ranks of a torch.distributed process group (port of
femo_alpha_tpu/parallel)."""

from .product import (
    CellShardSpec,
    DeviceMesh,
    grad_all_reduce,
    shard_aux,
    shard_mg_state,
    shard_model,
    shard_ops,
)
from .sharding import (
    ShardedAssembler,
    ShardedPlateStep,
    ShardedShellStep,
    make_device_mesh,
)

__all__ = ["make_device_mesh", "ShardedAssembler", "ShardedShellStep",
           "ShardedPlateStep", "CellShardSpec", "DeviceMesh",
           "grad_all_reduce", "shard_aux", "shard_mg_state", "shard_model",
           "shard_ops"]
