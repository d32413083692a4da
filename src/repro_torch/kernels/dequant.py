"""Feature dequantization (paper Eq. 2): ``q * scale + x_min``, uint8 or
uint16 ``[n, f]`` to float32, elementwise.

The kernel (``csrc/dequant.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/dequant.py:dequantize``.  It is bound by bytes and
rounds as the plain version does, so the two agree bit for bit on the
card.  :func:`dequantize_plain` is its plain PyTorch version, which the
wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmm import _eq2_constants

__all__ = ["dequantize", "dequantize_plain"]

_FUNCTIONS = {torch.uint8: "dequant_u8", torch.uint16: "dequant_u16"}
_P = ctypes.c_void_p
# (q, out, n, &scale, &x_min, stream)
_SIGNATURES = {fn: [_P, _P, ctypes.c_int64, _P, _P, _P]
               for fn in _FUNCTIONS.values()}
_BITS = {torch.uint8: 8, torch.uint16: 16}


def dequantize_plain(q, scale, x_min):
    """Plain PyTorch version of the kernel."""
    scale, x_min = _eq2_constants((scale, x_min), q.device)
    return q.to(torch.float32) * scale + x_min


def dequantize(q: torch.Tensor, scale, x_min, *, bits: int = 8
               ) -> torch.Tensor:
    """Eq. 2 over a quantized matrix.

    Args:
      q: uint8 (``bits=8``) or uint16 (``bits=16``) ``[n, f]``.
      scale / x_min: the affine constants, f32 scalar tensors (read by the
        kernel where they lie) or floats.
      bits: the source bit width, which must match ``q``'s dtype.

    Returns f32 ``[n, f]``.  CPU tensors run :func:`dequantize_plain`;
    CUDA tensors launch the kernel.
    """
    req = _build.require
    req(q.dim() == 2 and q.dtype in _FUNCTIONS,
        f"q must be uint8 or uint16 [n, f] (got {q.dtype}, {q.dim()}-d)")
    req(_BITS[q.dtype] == bits,
        f"bits={bits} does not match q's dtype {q.dtype}")
    req(q.is_contiguous(), "q must be contiguous")
    if _build.route(q) == "cpu":
        return dequantize_plain(q, scale, x_min)

    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    meta = _eq2_constants((scale, x_min), q.device)  # alive to the launch
    lib = _build.load("dequant", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, _FUNCTIONS[q.dtype])(
            _build.ptr(q), _build.ptr(out), q.numel(),
            *(_build.ptr(t) for t in meta), _build.stream_handle(q.device))
    _build.check(lib, code, "dequantize")
    dequantize.launches += 1
    return out


dequantize.launches = 0
