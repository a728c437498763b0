"""repro_torch.distributed — mesh-aware sharding rules and the collectives
of the sharded batched solve (port of ``repro.distributed``)."""

from .collectives import BatchShard, counts, reset_counts
from .sharding import (
    DEFAULT_SERVE_RULES,
    DEFAULT_TRAIN_RULES,
    AxisRules,
    NoProcessGroupError,
    P,
    batch_partition_axes,
    batch_shard_count,
    data_axis_names,
    device_mesh,
    fit_spec_to_shape,
    fit_specs,
    logical_to_spec,
    mesh_shape,
    model_axis_size,
    shard_mesh,
    spec_to_placements,
    world_size,
)

__all__ = [
    "AxisRules",
    "BatchShard",
    "DEFAULT_SERVE_RULES",
    "DEFAULT_TRAIN_RULES",
    "NoProcessGroupError",
    "P",
    "batch_partition_axes",
    "batch_shard_count",
    "counts",
    "data_axis_names",
    "device_mesh",
    "fit_spec_to_shape",
    "fit_specs",
    "logical_to_spec",
    "mesh_shape",
    "model_axis_size",
    "reset_counts",
    "shard_mesh",
    "spec_to_placements",
    "world_size",
]
