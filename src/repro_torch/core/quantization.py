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


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


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


def requantize_rows(qf: QuantizedFeatures, rows, values) -> QuantizedFeatures:
    """Re-encode only ``rows`` of a quantized matrix (Eq. 1) with its
    stored global ``(x_min, x_max)`` range, on ``qf.q``'s device.

    The rest of the operand is kept byte for byte; the range is not
    widened, so updated values outside it clip to the boundary levels
    (the incremental patch path re-quantizes the whole matrix past
    :data:`DRIFT_THRESHOLD` instead).
    """
    rows = torch.as_tensor(rows, dtype=torch.int64, device=qf.q.device)
    if rows.numel() == 0:
        return qf
    values = torch.as_tensor(values, dtype=torch.float32, device=qf.q.device)
    q = qf.q.clone()
    new = _quantize(values, qf.x_min, qf.x_max, qf.bits)
    # torch has no index_put for uint16/uint32: write the same bytes
    # through a signed view
    signed = _SIGNED_VIEW.get(q.dtype)
    if signed is None:
        q[rows] = new
    else:
        q.view(signed)[rows] = new.view(signed)
    return qf._replace(q=q)


def dequantize_arrays(q: torch.Tensor, x_min, x_max, bits: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eq. 2 on raw arrays: ``q * scale + x_min``, computed in the wider
    of ``dtype`` and the range's dtype and returned as ``dtype``."""
    x_min = torch.as_tensor(x_min, device=q.device)
    x_max = torch.as_tensor(x_max, device=q.device)
    scale = (x_max - x_min) / (2**bits - 1)
    wide = torch.promote_types(dtype, scale.dtype)
    return (q.to(dtype).to(wide) * scale + x_min).to(dtype)


def dequantize(qf: QuantizedFeatures,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eq. 2: ``q * scale + x_min`` as ``dtype`` (f32 by default)."""
    return dequantize_arrays(qf.q, qf.x_min, qf.x_max, qf.bits, dtype)


def quantization_error(x, bits: int = 8) -> torch.Tensor:
    """Max abs reconstruction error of Eq. 1 then Eq. 2; bounded by one
    quantization step."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return (dequantize(quantize(x, bits)) - x).abs().max()


def loading_bytes(num_nodes: int, feat: int, bits: Optional[int]) -> int:
    """Bytes moved when loading the feature matrix (the paper's Table 3);
    ``bits=None`` means raw float32."""
    if bits is None:
        return num_nodes * feat * 4
    return num_nodes * feat * storage_dtype(bits).itemsize


def gather_bytes(live_edges: int, feat: int, bits: Optional[int]) -> int:
    """Bytes the SpMM's B-row gather moves: one ``feat``-wide feature row
    per live ELL slot."""
    itemsize = 4 if bits is None else storage_dtype(bits).itemsize
    return live_edges * feat * itemsize


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
