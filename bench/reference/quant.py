"""The plain reference's scalar quantization (the paper's Eq. 1 and Eq. 2)
and the program's stated treatment of a quantized layer's operand.

    q  = floor((x - x_min) / (x_max - x_min) * (2^b - 1) + 0.5)   (Eq. 1)
    x^ = q * (x_max - x_min) / (2^b - 1) + x_min                  (Eq. 2)

with one global ``(x_min, x_max)`` over the matrix.  The input features
are quantized in float32, the precision they are stored in.

Every aggregation of a quantized run reads its operand through the stored
range of the input features: an operand inside that range (within half a
step) is re-encoded with it, or with its own range where the stored one
is off by more than ``DRIFT`` of its span; an operand outside it is
aggregated in float.  That is ``infer_logits``'s documented int8 path: the
input features through the quantized gather, the hidden layer re-encoded
"with the stored range (float on drift)".
"""
from __future__ import annotations

import torch

#: Share of the stored span by which an operand's range may move before it
#: is re-encoded with its own range.
DRIFT = 0.25
_TINY = torch.finfo(torch.float32).tiny


def encode(x: torch.Tensor, lo, hi, bits: int) -> torch.Tensor:
    """Eq. 1 in ``x``'s dtype: levels as floats in ``[0, 2^bits - 1]``."""
    levels = 2**bits - 1
    span = torch.clamp(hi - lo, min=_TINY)
    return torch.clamp(torch.floor((x - lo) / span * levels + 0.5), 0, levels)


def decode(q: torch.Tensor, lo, hi, bits: int, dtype) -> torch.Tensor:
    """Eq. 2 in ``dtype``."""
    lo, hi = torch.as_tensor(lo).to(dtype), torch.as_tensor(hi).to(dtype)
    return q.to(dtype) * ((hi - lo) / (2**bits - 1)) + lo


def quantize_features(x32: torch.Tensor, bits: int, dtype):
    """The input features after Eq. 1 and Eq. 2, in ``dtype``, and the
    stored range ``(x_min, x_max)`` (float32 scalars)."""
    lo, hi = x32.min(), x32.max()
    return decode(encode(x32, lo, hi, bits), lo, hi, bits, dtype), (lo, hi)


def through_range(h: torch.Tensor, stored, bits: int) -> torch.Tensor:
    """An aggregation's operand ``h`` as a quantized run serves it."""
    lo, hi = (torch.as_tensor(v, dtype=h.dtype) for v in stored)
    span = torch.clamp(hi - lo, min=_TINY)
    half_step = span / (2**bits - 1) / 2
    h_lo, h_hi = h.min(), h.max()
    if bool(h_lo < lo - half_step) or bool(h_hi > hi + half_step):
        return h
    drift = torch.maximum((h_lo - lo).abs(), (h_hi - hi).abs()) / span
    if bool(drift > DRIFT):
        lo, hi = h_lo, h_hi
    return decode(encode(h, lo, hi, bits), lo, hi, bits, h.dtype)
