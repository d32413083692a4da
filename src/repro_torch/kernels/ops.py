"""Public wrappers over the kernels, on the graph containers.

The signatures and output shapes are those of the reference package's
``kernels/ops.py``.  The Hopper kernels mask ragged rows, features and CSR
tails themselves, so nothing is padded here.  CPU tensors take each
kernel's plain version, CUDA tensors the kernel.
"""
from __future__ import annotations

from repro_torch.core.graph import CSR, ELL, ell_live_widths
from repro_torch.kernels import aes_sample as _sample_mod
from repro_torch.kernels import ell_spmm as _ell_mod
from repro_torch.kernels import fused_spmm as _fused_mod

#: The launch-counted kernel wrappers, by kernel name.
KERNELS = {
    "ell_spmm": _ell_mod.ell_spmm,
    "aes_sample": _sample_mod.aes_sample,
    "fused_aes_spmm": _fused_mod.fused_aes_spmm,
}


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def ell_spmm(ell: ELL, b, live_w=None, *, quantized_meta=None):
    """ELL SpMM ``C[r] = sum_k ell.val[r, k] * B[ell.col[r, k]]``.

    Args:
      ell: sampled operand (dead slots zeroed, live slots a prefix).
      b: dense operand ``[num_nodes, feat]`` — f32, or uint8/uint16 when
        ``quantized_meta`` is given.
      live_w: optional int32[rows] live-prefix lengths; decoded from the
        zero sentinel when omitted.
      quantized_meta: ``(scale, x_min)`` enables the fused-dequant gather.

    Returns f32[rows, feat].
    """
    if live_w is None:
        live_w = ell_live_widths(ell.val, ell.col)
    return _ell_mod.ell_spmm(ell.val.contiguous(), ell.col.contiguous(),
                             live_w.contiguous(), b.contiguous(),
                             quantized_meta=quantized_meta)


def aes_sample(csr: CSR, sh_width: int) -> ELL:
    """AES sampling pre-pass: CSR -> ELL(width=sh_width), dead slots
    zeroed."""
    val, col = _sample_mod.aes_sample(csr.row_ptr, csr.col_ind, csr.val,
                                      sh_width)
    return ELL(val, col, csr.num_cols)


def fused_aes_spmm(csr: CSR, b, sh_width: int):
    """Single-kernel AES-SpMM (paper Alg. 1): sample + multiply fused, no
    ELL materialized.  Returns f32[num_rows, feat]."""
    return _fused_mod.fused_aes_spmm(csr.row_ptr, csr.col_ind, csr.val,
                                     b.contiguous(), sh_width)
