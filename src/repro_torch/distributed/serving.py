"""Device placement for the sharded serving engine.

The engine (``repro_torch.serving.engine``) row-partitions a graph into
shards over a 1-D layout whose single axis is named ``"shards"``.  Two
helpers cover its two execution modes:

  * :func:`shard_devices` — a round-robin device per shard for the launch
    loop.  With fewer devices than shards, shards share a device and the
    engine's double-buffered operand dispatch degrades to plain
    sequencing, so one card serves a 4-shard layout.
  * :func:`serving_mesh` — the layout of the stacked (``"spmd"``) pass.
    The reference package places one shard per device and runs one
    ``shard_map`` program.  Here the shards are split in shard order over
    device *slots*, each slot's shards stacked on its device and served by
    one blocked pass; slots may name the same device, so ``["cpu"] * 4``
    or ``["cuda:0"] * 2`` exercise the split on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device

#: The one axis sharded serving partitions rows over.
SHARD_AXIS = "shards"


@dataclass(frozen=True)
class ServingMesh:
    """The stacked pass's layout: ``shape == (num_shards,)`` over the axis
    ``axis_names == (SHARD_AXIS,)``; slot ``i`` stacks shards
    ``range(*groups[i])`` on ``devices[i]``."""

    shape: tuple
    axis_names: tuple
    devices: tuple
    groups: tuple

    @property
    def device(self) -> torch.device:
        """The first slot's device, where the graph and its features live
        and where a pass's output is gathered."""
        return self.devices[0]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_devices(num_shards: int, devices=None) -> list:
    """Round-robin ``torch.device`` per shard for the launch loop.

    ``devices`` defaults to every CUDA device (raising without a card, as
    :func:`~repro_torch._device.resolve_device` does); the CPU is used only
    when the caller passes it (``devices=["cpu"]``).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if not devices:
        raise ValueError("no devices to place shards on")
    return [devices[s % len(devices)] for s in range(int(num_shards))]


def serving_mesh(num_shards: int, devices=None) -> ServingMesh:
    """The ``(num_shards,)`` layout over :data:`SHARD_AXIS`, split over
    device slots.

    ``devices`` is one device (one slot), or a list with one slot an entry
    (repeats allowed).  The default is one slot on the current CUDA
    device, every shard stacked there; a missing card raises.  The
    reference places one shard a device, but a pass spread over cards
    dispatches its slots one after another and moves their outputs
    between cards, which is slower than one card's stack, so the shards
    spread over cards only where ``devices`` lists them.  Shards split in
    shard order into contiguous groups as equal as possible, the first
    slots taking one more: 4 shards over 3 slots are 2/1/1.  Where the
    reference raises for fewer devices than shards, a slot here stacks
    several shards.

    Raises ``ValueError`` for ``num_shards < 1``, for more slots than
    shards, and for a slot that is neither a ``cpu`` nor a ``cuda``
    device.
    """
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is None:
        devices = [resolve_device("cuda")]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    for i, d in enumerate(devices):
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"serving_mesh: slot {i} is a {d.type!r} "
                             "device; a slot is a 'cpu' or 'cuda' device")
    if not devices or len(devices) > num_shards:
        raise ValueError(
            f"serving_mesh({num_shards}) needs 1 to {num_shards} device "
            f"slots, got {len(devices)}: a slot holds at least one shard")
    base, extra = divmod(num_shards, len(devices))
    groups, lo = [], 0
    for i in range(len(devices)):
        hi = lo + base + (i < extra)
        groups.append((lo, hi))
        lo = hi
    return ServingMesh((num_shards,), (SHARD_AXIS,), devices, tuple(groups))
