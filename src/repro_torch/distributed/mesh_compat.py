"""A mesh without devices: the port's counterpart of the reference's
``abstract_mesh`` (``jax.sharding.AbstractMesh``).

The sharding rules (:mod:`repro_torch.distributed.sharding`) read only a
mesh's axis names and sizes, so they take either this record or a
``torch.distributed.device_mesh.DeviceMesh``; this one needs no process
group, so the rules can be evaluated for a 256- or 512-rank mesh on any
host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names in mesh order and their sizes (``shape``: name ->
    size, as ``jax.sharding.AbstractMesh.shape`` gives them)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis_sizes {axis_sizes!r} and axis_names "
                         f"{axis_names!r} must have equal length")
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))
