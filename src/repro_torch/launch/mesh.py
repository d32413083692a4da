"""Production mesh definitions (NVIDIA H100 target).

single pod : (16, 16)    axes (data, model)            = 256 GPUs
multi pod  : (2, 16, 16) axes (pod, data, model)       = 512 GPUs

Both meshes are built over the default process group, which the caller
starts (``torch.distributed.init_process_group``; the dry run uses a fake
group of 256 or 512 ranks).  They are functions, never module state, so
importing this module starts no group and touches no device.
"""
from __future__ import annotations

import math

from repro_torch._device import resolve_device

PRODUCTION_SHAPE = ((16, 16), ("data", "model"))
MULTI_POD_SHAPE = ((2, 16, 16), ("pod", "data", "model"))

# H100 SXM5 80GB hardware constants for the roofline terms (per GPU), from
# NVIDIA's H100 SXM5 80GB (700 W) datasheet: published peaks, not
# measurements of this port
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s a direction a GPU (NVLink 4, 900 GB/s both)
IB_BW = 50e9                  # B/s a GPU across nodes (400 Gb/s InfiniBand)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _init_mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) or (2, 16, 16) mesh over the default process group on
    ``device``'s type (default ``"cuda"``).  Raises ``ValueError`` when
    the group does not have the 256 or 512 ranks the mesh needs (the
    reference's ``jax.make_mesh`` error)."""
    shape, names = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    need, have = math.prod(shape), _world_size()
    if have != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'production'} "
                         f"mesh {shape} needs {need} ranks; the process "
                         f"group has {have}")
    return _init_mesh(device, shape, names)


def make_local_mesh(model: int = 1, data: int | None = None, device=None):
    """A (data, model) mesh over every rank of the default process group
    (one rank: a 1x1 mesh)."""
    n = _world_size()
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {n}")
    return _init_mesh(device, (data, model), ("data", "model"))
