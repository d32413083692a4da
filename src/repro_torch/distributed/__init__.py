"""``repro_torch.distributed`` — device placement for sharded serving:
:func:`shard_devices` (the launch loop's round robin) and
:func:`serving_mesh` (the stacked pass's layout over the :data:`SHARD_AXIS`
axis, split over device slots)."""
from repro_torch.distributed.serving import (SHARD_AXIS, ServingMesh,
                                             serving_mesh, shard_devices)

__all__ = ["SHARD_AXIS", "ServingMesh", "serving_mesh", "shard_devices"]
