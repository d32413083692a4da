"""Plain PyTorch versions of the SpMM kernels: the ground truth the
kernels are held against, and the eager ``backend="torch"`` path.

``csr_spmm`` is the exact ``"full"`` aggregation (the cuSPARSE role); the
reference package computes it with a segment sum outside any kernel, so
``index_add_`` is its port.
"""
from __future__ import annotations

import torch


def csr_spmm(row_ptr, col_ind, val, b):
    """Exact CSR SpMM: ``C[r, :] = sum_{k in row r} val[k] * B[col_ind[k], :]``."""
    rows = row_ptr.shape[0] - 1
    row_ids = torch.repeat_interleave(
        torch.arange(rows, device=b.device),
        (row_ptr[1:] - row_ptr[:-1]).long(), output_size=col_ind.shape[0])
    contrib = val[:, None] * b[col_ind.long()]
    out = torch.zeros((rows, b.shape[1]), dtype=contrib.dtype,
                      device=b.device)
    return out.index_add_(0, row_ids, contrib)


def ell_spmm(ell_val, ell_col, b):
    """Gather-multiply-reduce over the whole ELL (dead slots carry val=0)."""
    return torch.einsum("rw,rwf->rf", ell_val, b[ell_col.long()])


def ell_spmm_rowloop(ell_val, ell_col, b):
    """Memory-lean version: accumulate one slot column at a time, in slot
    order (the order the kernels sum in)."""
    acc = torch.zeros((ell_val.shape[0], b.shape[1]), dtype=b.dtype,
                      device=b.device)
    col = ell_col.long()
    for k in range(ell_val.shape[1]):
        acc = acc + ell_val[:, k, None] * b[col[:, k]]
    return acc


def fused_layer(ell_val, ell_col, b, w, bias, *, relu: bool = True):
    """The fused layer as separate ops: ``act(ell_spmm(ell, B) @ W +
    bias)`` with ``act`` ReLU or identity (the eager ``backend="torch"``
    path of ``PlanExecutor.run_fused_layer``)."""
    h = ell_spmm_rowloop(ell_val, ell_col, b) @ w + bias
    return torch.relu(h) if relu else h


def quant_fused_layer(ell_val, ell_col, qf, w, bias, *, relu: bool = True):
    """Dequantize-then-layer version of the quantized fused layer:
    materialize Eq. 2, then :func:`fused_layer`.

    Args:
      qf: a ``repro_torch.core.quantization.QuantizedFeatures``.
    """
    x = dequantize(qf.q, qf.x_min, qf.x_max, qf.bits)
    return fused_layer(ell_val, ell_col, x, w, bias, relu=relu)


def dequantize(q, x_min, x_max, bits: int = 8):
    """Paper Eq. 2: ``q * (x_max - x_min) / (2^bits - 1) + x_min``."""
    scale = (x_max - x_min) / (2**bits - 1)
    return q.to(torch.float32) * scale + x_min


def aes_spmm(row_ptr, col_ind, val, b, sh_width: int, bits=None,
             x_min=None, x_max=None):
    """End to end: AES sampling -> (optional dequant) -> ELL SpMM."""
    from repro_torch.core.sampling import sample_csr_to_ell

    ell_val, ell_col = sample_csr_to_ell(row_ptr, col_ind, val, sh_width)
    if bits is not None:
        b = dequantize(b, x_min, x_max, bits)
    return ell_spmm_rowloop(ell_val, ell_col, b)


def block_ell_spmm(bell, b):
    """Blocked SpMM as separate ops: each block segment through
    :func:`ell_spmm_rowloop`, outputs stitched, padded rows dropped.

    Args:
      bell: a ``repro_torch.core.graph.BlockELL``.
      b: dense operand f32[num_cols_of_graph, feat].

    Returns f32[bell.num_rows, feat].
    """
    outs = [ell_spmm_rowloop(*bell.block_segment(i), b)
            for i in range(bell.num_blocks)]
    return torch.cat(outs, dim=0)[:bell.num_rows]


def quant_block_ell_spmm(bell, qf):
    """Dequantize-then-SpMM version of the quantized blocked kernel:
    materialize Eq. 2, then :func:`block_ell_spmm`.

    Args:
      bell: a ``repro_torch.core.graph.BlockELL``.
      qf: a ``repro_torch.core.quantization.QuantizedFeatures``.
    """
    x = dequantize(qf.q, qf.x_min, qf.x_max, qf.bits)
    return block_ell_spmm(bell, x)
