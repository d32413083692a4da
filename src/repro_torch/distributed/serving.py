"""Device placement for the sharded serving engine's launch loop.

The engine (``repro_torch.serving.engine``) row-partitions a graph into
shards and runs one launch per shard, each on a device from
:func:`shard_devices`.  With fewer devices than shards, shards share a
device and the engine's double-buffered operand dispatch degrades to plain
sequencing, so one card serves a 4-shard layout.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device


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
