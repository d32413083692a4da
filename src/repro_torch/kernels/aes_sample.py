"""AES sampling pre-pass: CSR -> ELL[rows, W] by Table 1 + Eq. 3 (element
j of sample i in slot ``i + j*cnt``, dead slots zero), with each row's
live width.

The kernel (``csrc/aes_sample.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/aes_sample.py:aes_sample``.  It is bound by bytes and
its output is bit-identical to its plain version,
``repro_torch.core.sampling.sample_csr_to_ell``, followed by
``repro_torch.core.graph.ell_live_widths`` for the live widths; the
wrapper runs those for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.graph import ell_live_widths
from repro_torch.core.sampling import sample_csr_to_ell as aes_sample_plain
from repro_torch.kernels import _build

__all__ = ["aes_sample", "aes_sample_plain"]


_P, _I = ctypes.c_void_p, ctypes.c_int
# (row_ptr, col_ind, val, out_val, out_col, out_live, rows, sh_width,
#  stream)
_SIGNATURES = {"aes_sample": [_P] * 6 + [_I] * 2 + [_P]}


def aes_sample(row_ptr: torch.Tensor, col_ind: torch.Tensor,
               val: torch.Tensor, sh_width: int):
    """Sample a CSR into a width-``sh_width`` ELL.

    Args:
      row_ptr: int32 ``[rows + 1]``; col_ind / val: int32 / f32 ``[nnz]``.
      sh_width: ELL width W (>= 1).

    Returns ``(val f32[rows, W], col int32[rows, W], live_w
    int32[rows])``, ``live_w`` being ``ell_live_widths(val, col)``.  CPU
    tensors run the plain sampler and decode the widths; CUDA tensors
    launch the kernel, which writes all three.
    """
    _build.require_csr(row_ptr, col_ind, val)
    sh_width = int(sh_width)
    _build.require(sh_width >= 1, f"sh_width must be >= 1 (got {sh_width})")
    if _build.route(row_ptr, col_ind, val) == "cpu":
        out_val, out_col = aes_sample_plain(row_ptr, col_ind, val, sh_width)
        return out_val, out_col, ell_live_widths(out_val, out_col)

    rows = row_ptr.shape[0] - 1
    out_val = torch.empty((rows, sh_width), dtype=torch.float32,
                          device=val.device)
    out_col = torch.empty((rows, sh_width), dtype=torch.int32,
                          device=val.device)
    out_live = torch.empty(rows, dtype=torch.int32, device=val.device)
    if rows == 0:
        return out_val, out_col, out_live
    lib = _build.load("aes_sample", _SIGNATURES)
    with torch.cuda.device(val.device):
        code = lib.aes_sample(
            *(_build.ptr(t) for t in (row_ptr, col_ind, val, out_val,
                                      out_col, out_live)),
            rows, sh_width, _build.stream_handle(val.device))
    _build.check(lib, code, "aes_sample")
    aes_sample.launches += 1
    return out_val, out_col, out_live


aes_sample.launches = 0
