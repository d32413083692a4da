"""Scalar feature quantization (paper §2.3 / §3.1, Eq. 1-2).

Features are quantized with a single global (x_min, x_max) pair to
``b``-bit unsigned integers (the paper uses INT8, b=8), stored in the
compact dtype, and dequantized on the device before or during aggregation:

    q    = floor((x - x_min) / (x_max - x_min) * (2^b - 1) + 0.5)  (Eq. 1)
    x^   = q * (x_max - x_min) / (2^b - 1) + x_min                 (Eq. 2)

Eq. 1 rounds to the nearest level (|x - x^| <= scale/2) and keeps the
reference package's operation order, so ``q`` is bit-identical to it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_TINY = torch.finfo(torch.float32).tiny


class QuantizedFeatures(NamedTuple):
    """Quantized feature matrix + the dequantization constants stored
    alongside it."""

    q: torch.Tensor       # uint8/uint16[nodes, feat]
    x_min: torch.Tensor   # f32 scalar
    x_max: torch.Tensor   # f32 scalar
    bits: int

    @property
    def scale(self) -> torch.Tensor:
        return (self.x_max - self.x_min) / (2**self.bits - 1)


def storage_dtype(bits: int) -> torch.dtype:
    if bits <= 8:
        return torch.uint8
    if bits <= 16:
        return torch.uint16
    return torch.uint32


def _quantize(x, x_min, x_max, bits: int) -> torch.Tensor:
    levels = 2**bits - 1
    span = torch.clamp(x_max - x_min, min=_TINY)
    q = torch.floor((x - x_min) / span * levels + 0.5)
    return torch.clamp(q, 0, levels).to(storage_dtype(bits))


def quantize(x: torch.Tensor, bits: int = 8) -> QuantizedFeatures:
    """Quantization (Eq. 1) with the global min/max over the feature set."""
    x = torch.as_tensor(x, dtype=torch.float32)
    x_min, x_max = x.min(), x.max()
    return QuantizedFeatures(q=_quantize(x, x_min, x_max, bits), x_min=x_min,
                             x_max=x_max, bits=bits)


def as_quantized(features, bits: int) -> QuantizedFeatures:
    """``features`` as a ``bits``-wide :class:`QuantizedFeatures`: a
    matching-width operand passes through untouched, a mismatched one is
    re-quantized from its Eq. 2 reconstruction, a dense matrix is
    quantized (Eq. 1)."""
    if isinstance(features, QuantizedFeatures):
        if features.bits == bits:
            return features
        features = dequantize(features)
    return quantize(features, bits)


def dequantize(qf: QuantizedFeatures) -> torch.Tensor:
    """Eq. 2: ``q * scale + x_min`` as f32."""
    return qf.q.to(torch.float32) * qf.scale + qf.x_min


#: Fraction of the stored quantization span by which the operand's value
#: range may move before :func:`requantize_within_range` re-derives the
#: range instead of re-encoding against the stale one.
DRIFT_THRESHOLD = 0.25


def range_drift(qf: QuantizedFeatures, x) -> float:
    """How far ``x``'s value range has moved from ``qf``'s stored
    ``(x_min, x_max)``, as a fraction of the stored span (overhang and
    shrinkage both count)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.numel() == 0:
        return 0.0
    span = max(float(qf.x_max - qf.x_min), _TINY)
    return max(abs(float(x.min()) - float(qf.x_min)),
               abs(float(x.max()) - float(qf.x_max))) / span


def requantize_within_range(qf: QuantizedFeatures,
                            x) -> Optional[QuantizedFeatures]:
    """Re-encode a full matrix ``x`` (Eq. 1) with ``qf``'s stored range,
    or return ``None`` when the range no longer covers it (more than half
    a quantization step of overhang: the caller takes the float path).

    Past :data:`DRIFT_THRESHOLD` the matrix is re-quantized with a freshly
    derived range instead.  For ``x == dequantize(qf)`` the round trip is
    bit-exact, which makes this safe to apply on the first layer.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    half_step = qf.scale * 0.5
    drift = (x.min() < qf.x_min - half_step) | (x.max() > qf.x_max + half_step)
    if bool(drift):
        return None
    if range_drift(qf, x) > DRIFT_THRESHOLD:
        return quantize(x, qf.bits)
    return QuantizedFeatures(q=_quantize(x, qf.x_min, qf.x_max, qf.bits),
                             x_min=qf.x_min, x_max=qf.x_max, bits=qf.bits)
