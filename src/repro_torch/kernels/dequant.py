"""Feature dequantization (paper Eq. 2): ``q * scale + x_min``, uint8 or
uint16 ``[n, f]`` to float32, elementwise, with one ``(scale, x_min)``
pair, or one pair for each of ``S`` equal segments of the rows (a stack
of shards, each quantized with its own range).

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

__all__ = ["dequantize", "dequantize_plain"]

_FUNCTIONS = {torch.uint8: "dequant_u8", torch.uint16: "dequant_u16"}
_P = ctypes.c_void_p
# (q, out, n, elements a segment, scale[S], x_min[S], stream)
_SIGNATURES = {fn: [_P, _P, ctypes.c_int64, ctypes.c_int64, _P, _P, _P]
               for fn in _FUNCTIONS.values()}
_BITS = {torch.uint8: 8, torch.uint16: 16}


def _constants(q, scale, x_min):
    """``(scale, x_min)`` as two contiguous f32 ``[S]`` tensors on ``q``'s
    device: ``S = 1`` for two scalars (a scalar tensor elsewhere is copied
    there, a scalar already there is used as it is, so no launch waits on
    a device-to-host read), else two ``[S]`` tables on ``q``'s device whose
    ``S`` divides ``q``'s rows."""
    req = _build.require
    for c in (scale, x_min):
        if isinstance(c, torch.Tensor) and c.numel() != 1:
            req(c.device == q.device,
                f"a scale / x_min table must lie on q's device {q.device} "
                f"(got {c.device})")
    consts = tuple(torch.as_tensor(c, dtype=torch.float32, device=q.device)
                   for c in (scale, x_min))
    if all(c.numel() == 1 for c in consts):
        return tuple(c.reshape(1) for c in consts)
    s = consts[0].numel()
    req(all(c.dim() == 1 and c.numel() == s for c in consts) and s > 0
        and q.shape[0] % s == 0,
        "scale and x_min must be two scalars or two [S] tables whose S "
        f"divides q's {q.shape[0]} rows (got shapes "
        f"{[tuple(c.shape) for c in consts]})")
    return tuple(c.contiguous() for c in consts)


def dequantize_plain(q, scale, x_min):
    """Plain PyTorch version of the kernel: segment ``s`` of ``q``'s rows
    through ``(scale[s], x_min[s])``."""
    scale, x_min = _constants(q, scale, x_min)
    s = scale.numel()
    segs = q.reshape(s, q.shape[0] // s, *q.shape[1:]).to(torch.float32)
    return (segs * scale[:, None, None] + x_min[:, None, None]).reshape(
        q.shape)


def dequantize(q: torch.Tensor, scale, x_min, *, bits: int = 8,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 2 over a quantized matrix.

    Args:
      q: uint8 (``bits=8``) or uint16 (``bits=16``) ``[n, f]``.
      scale / x_min: the affine constants: two f32 scalar tensors (read by
        the kernel where they lie) or floats; or two f32 ``[S]`` tables on
        ``q``'s device, ``S`` dividing ``n``: ``q``'s rows split into
        ``S`` equal segments, segment ``s`` through ``(scale[s],
        x_min[s])`` (a stack of shards in one launch).
      bits: the source bit width, which must match ``q``'s dtype.
      out: optional contiguous f32 ``[n, f]`` on ``q``'s device to write
        into (a slice of a larger stack), else a new tensor.

    Returns f32 ``[n, f]`` (``out`` when given).  CPU tensors run
    :func:`dequantize_plain`; CUDA tensors launch the kernel.
    """
    req = _build.require
    req(q.dim() == 2 and q.dtype in _FUNCTIONS,
        f"q must be uint8 or uint16 [n, f] (got {q.dtype}, {q.dim()}-d)")
    req(_BITS[q.dtype] == bits,
        f"bits={bits} does not match q's dtype {q.dtype}")
    req(q.is_contiguous(), "q must be contiguous")
    if out is not None:
        req(out.shape == q.shape and out.dtype == torch.float32
            and out.device == q.device and out.is_contiguous(),
            "out must be a contiguous f32 tensor shaped like q, on its "
            "device")
    if _build.route(q) == "cpu":
        plain = dequantize_plain(q, scale, x_min)
        return plain if out is None else out.copy_(plain)

    meta = _constants(q, scale, x_min)  # alive to the launch
    if out is None:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    lib = _build.load("dequant", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, _FUNCTIONS[q.dtype])(
            _build.ptr(q), _build.ptr(out), q.numel(),
            q.numel() // meta[0].numel(), *(_build.ptr(t) for t in meta),
            _build.stream_handle(q.device))
    _build.check(lib, code, "dequantize")
    dequantize.launches += 1
    return out


dequantize.launches = 0
