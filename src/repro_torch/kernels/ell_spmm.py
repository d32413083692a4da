"""ELL SpMM: ``C[r, :] = sum_{k < live_w[r]} val[r, k] * B[col[r, k], :]``,
on float32 B or on uint8/uint16 B with Eq. 2 applied in the gather.

The kernel (``csrc/ell_spmm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/ell_spmm.py:ell_spmm``.  It is bound by bytes; the
source says what its design does about that.  :func:`ell_spmm_plain` is
its plain PyTorch version, which the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ell_spmm_rowloop

_QUANT_DTYPES = {torch.uint8: "ell_spmm_u8", torch.uint16: "ell_spmm_u16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (val, col, live_w, b, out, rows, width, feat[, &scale, &x_min], stream)
_SIGNATURES = {"ell_spmm_f32": [_P] * 5 + [_I] * 3 + [_P],
               **{fn: [_P] * 5 + [_I] * 3 + [_P] * 3
                  for fn in _QUANT_DTYPES.values()}}


def _eq2_constants(quantized_meta, device):
    """``(scale, x_min)`` as f32 scalars on ``device``: a scalar already
    there is used as it is, so no launch waits on a device-to-host read."""
    consts = tuple(torch.as_tensor(c, dtype=torch.float32, device=device)
                   for c in quantized_meta)
    _build.require(all(c.numel() == 1 for c in consts),
                   "quantized_meta must be two scalars (scale, x_min)")
    return consts


def _dequant(b, quantized_meta):
    if quantized_meta is None:
        return b
    scale, x_min = _eq2_constants(quantized_meta, b.device)
    return b.to(torch.float32) * scale + x_min


def ell_spmm_plain(val, col, live_w, b, quantized_meta=None):
    """Plain PyTorch version of the kernel: the same sum, slot by slot."""
    live = torch.arange(val.shape[1], device=val.device)[None, :] \
        < live_w[:, None]
    return ell_spmm_rowloop(torch.where(live, val, 0), col,
                            _dequant(b, quantized_meta))


def ell_spmm(val: torch.Tensor, col: torch.Tensor, live_w: torch.Tensor,
             b: torch.Tensor, *, quantized_meta=None) -> torch.Tensor:
    """ELL SpMM over the live prefix of each row.

    Args:
      val / col: f32 / int32 ``[rows, W]``; ``col`` in ``[0, b.shape[0])``.
      live_w: int32 ``[rows]``, slots summed per row.
      b: ``[nodes, F]`` f32, or uint8/uint16 with ``quantized_meta``.
      quantized_meta: ``(scale, x_min)`` of Eq. 2 for a quantized ``b``:
        f32 scalar tensors (read by the kernel where they lie) or floats.

    Returns f32 ``[rows, F]``.  CPU tensors run :func:`ell_spmm_plain`;
    CUDA tensors launch the kernel.
    """
    req = _build.require
    req(val.dim() == 2 and val.dtype == torch.float32, "val must be f32[rows, W]")
    req(col.shape == val.shape and col.dtype == torch.int32,
        "col must be int32 and shaped like val")
    req(live_w.shape == (val.shape[0],) and live_w.dtype == torch.int32,
        "live_w must be int32[rows]")
    req(b.dim() == 2, "b must be [nodes, F]")
    if quantized_meta is None:
        req(b.dtype == torch.float32,
            f"b must be float32 (got {b.dtype}; bf16 B is not supported yet)")
    else:
        req(b.dtype in _QUANT_DTYPES,
            f"a quantized b must be uint8 or uint16 (got {b.dtype})")
    for name, t in (("val", val), ("col", col), ("live_w", live_w), ("b", b)):
        req(t.is_contiguous(), f"{name} must be contiguous")
    if _build.route(val, col, live_w, b) == "cpu":
        return ell_spmm_plain(val, col, live_w, b, quantized_meta)

    rows, width = val.shape
    feat = b.shape[1]
    out = torch.empty((rows, feat), dtype=torch.float32, device=val.device)
    if rows == 0 or feat == 0:
        return out.zero_()
    lib = _build.load("ell_spmm", _SIGNATURES)
    args = [_build.ptr(t) for t in (val, col, live_w, b, out)]
    args += [rows, width, feat]
    if quantized_meta is None:
        fn = lib.ell_spmm_f32
    else:
        fn = getattr(lib, _QUANT_DTYPES[b.dtype])
        meta = _eq2_constants(quantized_meta, val.device)
        args += [_build.ptr(t) for t in meta]
    with torch.cuda.device(val.device):
        code = fn(*args, _build.stream_handle(val.device))
    _build.check(lib, code, "ell_spmm")
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
