"""ELL SpMM: ``C[r, :] = sum_{k < live_w[r]} val[r, k] * B[col[r, k], :]``,
on float32 B or on uint8/uint16 B with Eq. 2 applied in the gather.

The kernel (``csrc/ell_spmm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/ell_spmm.py:ell_spmm``.  It is bound by bytes; the
source says what its design does about that.  :func:`ell_spmm_plain` is
its plain PyTorch version, which the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ell_spmm_rowloop

_QUANT_DTYPES = {torch.uint8: "ell_spmm_u8", torch.uint16: "ell_spmm_u16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (val, col, live_w, b, out, rows, width, feat, panel[, &scale, &x_min],
#  stream)
_SIGNATURES = {"ell_spmm_f32": [_P] * 5 + [_I] * 4 + [_P],
               **{fn: [_P] * 5 + [_I] * 4 + [_P] * 3
                  for fn in _QUANT_DTYPES.values()}}

#: The share of the card's L2 that one panel of B may fill.
_PANEL_L2_SHARE = 0.6
#: The narrowest panel in bytes a row (one 32-byte sector).
_PANEL_MIN_BYTES = 32
#: The features one pass of a warp covers in the row-order walk (32 lanes
#: of 4): up to this F each row's chain of (val, col) loads is walked once,
#: and panels would walk it once a panel.  F stands in for what decides
#: it, the live slots a row: panels lost on ``make_dataset``'s Reddit at
#: F = 128 and 7.1 live slots a row (the chain of loads bounds the
#: gather) and won on the benchmark's at F = 602 and 121 (bytes bound
#: it).  The host cannot count live slots without waiting on the card, and
#: no measured operand is bytes-bound at F <= 128 with B above L2.
_ONE_PASS_FEATURES = 128


def _panel_features(rows_b: int, feat: int, itemsize: int,
                    l2_bytes: int) -> int:
    """Features a panel of ``B`` (``[rows_b, feat]``, ``itemsize`` bytes an
    element) gathers on a card with ``l2_bytes`` of L2: ``feat`` (rows in
    row order over all of F) where one pass covers F
    (:data:`_ONE_PASS_FEATURES`), where ``B`` fits
    :data:`_PANEL_L2_SHARE` of L2, or where no panel of
    :data:`_PANEL_MIN_BYTES` or more does; else the widest power of two
    (whole lane groups) whose column ``rows_b * P * itemsize`` fits.

    Every element size takes panels: on Reddit's layer 1 (232,965 x 602,
    an H100) f32 P = 32 ran 13.4 against 22.4 ms in row order, uint8 P =
    128 11.9 against 13.6, uint16 P = 64 14.9 against 16.3, each launch's
    own time (``scripts/ell_panel_times.py``, PERF.md)."""
    budget = l2_bytes * _PANEL_L2_SHARE
    if feat <= _ONE_PASS_FEATURES or rows_b * feat * itemsize <= budget:
        return feat
    fit = int(budget // (rows_b * itemsize))
    p = 1 << (fit.bit_length() - 1) if fit else 0
    return p if p * itemsize >= _PANEL_MIN_BYTES else feat


@functools.lru_cache(maxsize=None)
def _l2_bytes(device_index: int) -> int:
    """The L2 cache of CUDA card ``device_index``, in bytes."""
    return torch.cuda.get_device_properties(device_index).L2_cache_size


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

    feat = b.shape[1]
    panel = _panel_features(b.shape[0], feat, b.element_size(),
                            _l2_bytes(val.device.index))
    if panel < feat and val.shape[0] > 0:
        obs.count("kernels.ell_spmm.panel_launches")
        obs.count("kernels.ell_spmm.panels", -(-feat // panel))
    return _launch(val, col, live_w, b, quantized_meta, panel)


def _launch(val, col, live_w, b, quantized_meta, panel: int):
    """One launch of the kernel on checked CUDA inputs: the panel-major
    walk over panels of ``panel`` features where ``panel`` < F, else rows
    in row order over all of F."""
    rows, width = val.shape
    feat = b.shape[1]
    out = torch.empty((rows, feat), dtype=torch.float32, device=val.device)
    if rows == 0 or feat == 0:
        return out.zero_()
    lib = _build.load("ell_spmm", _SIGNATURES)
    args = [_build.ptr(t) for t in (val, col, live_w, b, out)]
    args += [rows, width, feat, panel]
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
