"""``repro_torch.distributed`` — device placement for sharded serving.

Only the launch-loop half of the reference package's
``repro.distributed.serving`` is ported: :func:`shard_devices`.  The SPMD
mesh (``serving_mesh``) comes with the multi-card slice of the port.
"""
from repro_torch.distributed.serving import shard_devices

__all__ = ["shard_devices"]
