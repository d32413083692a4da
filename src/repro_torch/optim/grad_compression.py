"""INT8 gradient compression with error feedback, for the cross-pod
all-reduce.

The paper's scalar quantization (Eq. 1-2) on gradients: each tensor is
quantized to int8 around its own max-abs scale (in the gradient's dtype,
rounded half to even), and the quantization residual is fed back into
the next step.  Gradients are a dict of tensors (parameter name ->
tensor).
"""
from __future__ import annotations

import torch


def _compress(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(torch.float32) * scale


def compress_grads(grads: dict, residual: dict | None = None):
    """Returns (q_grads int8, scales, new_residual float32), each a dict
    with ``grads``' keys; ``residual`` (the last call's) is added
    first."""
    if residual is not None:
        grads = {k: g + residual[k] for k, g in grads.items()}
    out = {k: _compress(g) for k, g in grads.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()},
            {k: o[2] for k, o in out.items()})


def decompress_grads(q_grads: dict, scales: dict) -> dict:
    return {k: q.to(torch.float32) * scales[k] for k, q in q_grads.items()}
