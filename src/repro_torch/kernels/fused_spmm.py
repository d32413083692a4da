"""Fused AES-SpMM (paper Algorithm 1 in one kernel): sample each row into
shared memory and aggregate over the live slots, with no ELL operand in
device memory.

The kernel (``csrc/fused_spmm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/fused_spmm.py:fused_aes_spmm``.  It is bound by bytes.
:func:`fused_aes_spmm_plain` (sample, then SpMM) is its plain PyTorch
version, which the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import aes_spmm as fused_aes_spmm_plain

__all__ = ["MAX_SHARED_BYTES", "fused_aes_spmm", "fused_aes_spmm_plain"]

#: Shared memory one Hopper block may use (opt-in maximum); the kernel
#: stages 8 bytes (val + col) per slot.
MAX_SHARED_BYTES = 232448


_P, _I = ctypes.c_void_p, ctypes.c_int
# (row_ptr, col_ind, val, b, out, rows, feat, sh_width, stream)
_SIGNATURES = {"fused_aes_spmm": [_P] * 5 + [_I] * 3 + [_P]}


def fused_aes_spmm(row_ptr: torch.Tensor, col_ind: torch.Tensor,
                   val: torch.Tensor, b: torch.Tensor,
                   sh_width: int) -> torch.Tensor:
    """AES-sampled aggregation ``C = sample(A, W) @ B`` in one kernel.

    Args:
      row_ptr / col_ind / val: the CSR (int32 / int32 / f32).
      b: f32 ``[nodes, F]``.
      sh_width: sampling width W; ``8 * W`` bytes of shared memory.

    Returns f32 ``[rows, F]``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel.
    """
    req = _build.require
    _build.require_csr(row_ptr, col_ind, val)
    req(b.dim() == 2 and b.dtype == torch.float32 and b.is_contiguous(),
        "b must be contiguous f32[nodes, F]")
    sh_width = int(sh_width)
    req(sh_width >= 1, f"sh_width must be >= 1 (got {sh_width})")
    req(8 * sh_width <= MAX_SHARED_BYTES,
        f"sh_width={sh_width} needs {8 * sh_width} bytes of shared memory; "
        f"a block may use {MAX_SHARED_BYTES}")
    if _build.route(row_ptr, col_ind, val, b) == "cpu":
        return fused_aes_spmm_plain(row_ptr, col_ind, val, b, sh_width)

    rows, feat = row_ptr.shape[0] - 1, b.shape[1]
    out = torch.empty((rows, feat), dtype=torch.float32, device=b.device)
    if rows == 0 or feat == 0:
        return out.zero_()
    lib = _build.load("fused_spmm", _SIGNATURES)
    with torch.cuda.device(b.device):
        code = lib.fused_aes_spmm(
            *(_build.ptr(t) for t in (row_ptr, col_ind, val, b, out)),
            rows, feat, sh_width, _build.stream_handle(b.device))
    _build.check(lib, code, "fused_aes_spmm")
    fused_aes_spmm.launches += 1
    return out


fused_aes_spmm.launches = 0
