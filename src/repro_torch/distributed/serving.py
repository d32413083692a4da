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
    ``shard_map`` program; here every shard's operand is stacked on one
    device and the pass is one blocked-kernel launch per width bucket.
    Spreading the stack over several cards is not ported.
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
    ``axis_names == (SHARD_AXIS,)``, every shard on ``device``."""

    shape: tuple
    axis_names: tuple
    device: torch.device


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


def serving_mesh(num_shards: int, device=None) -> ServingMesh:
    """The ``(num_shards,)`` layout over :data:`SHARD_AXIS` with the whole
    stack on one device.

    ``device`` is a device, or a list of devices that must name one device
    (default: the current CUDA device; a missing card raises).  Raises
    ``ValueError`` for a list of several distinct devices: the stacked pass
    runs on one device, and spreading it over cards is not ported.
    """
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if device is None or isinstance(device, (str, torch.device)):
        device = [device]
    devices = {_indexed(resolve_device(d)) for d in device}
    if len(devices) != 1:
        raise ValueError(
            f"serving_mesh({num_shards}) stacks every shard on one device, "
            f"got {len(devices)} distinct devices {sorted(map(str, devices))}"
            "; spreading the stacked pass over several cards is not ported "
            "(use mode='loop' to place shards round robin)")
    return ServingMesh((num_shards,), (SHARD_AXIS,), devices.pop())
