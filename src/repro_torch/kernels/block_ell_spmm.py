"""Blocked ELL SpMM over a mixed-width BlockELL, one launch per width
bucket: ``C[r, :] = sum_{k < min(live_w[r], width_b)} seg_b[r, k] *
B[col_b[r, k], :]`` with ``b`` the row's block, on float32 B or on
uint8/uint16 B with Eq. 2 applied in the gather.

The kernel (``csrc/block_ell_spmm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/ell_spmm.py:block_ell_spmm``.  It is bound by bytes;
the source says what its design does about that.
:func:`block_ell_spmm_plain` is its plain PyTorch version, which the
wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmm import _dequant, _eq2_constants
from repro_torch.kernels.ell_spmm import _QUANT_DTYPES as _ELL_QUANT
from repro_torch.kernels.ref import ell_spmm_rowloop

_QUANT_DTYPES = {dt: fn.replace("ell_spmm", "block_ell_spmm")
                 for dt, fn in _ELL_QUANT.items()}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (blocks, n_blocks, live_w, val, col, b, out, block_rows, num_rows,
#  feat[, &scale, &x_min], stream)
_HEAD = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I]
_SIGNATURES = {"block_ell_spmm_f32": _HEAD + [_P],
               **{fn: _HEAD + [_P] * 3 for fn in _QUANT_DTYPES.values()}}


def _segments(widths, block_rows):
    """Slot offset of each block inside the flat arrays."""
    offs = np.zeros(len(widths), np.int64)
    np.cumsum(np.asarray(widths[:-1], np.int64) * block_rows, out=offs[1:])
    return offs


# Identity-keyed memo of the launch metadata on the card: per flat ``val``
# tensor, per (widths, block_rows, bucket block ids), one int64 ``[blocks,
# 3]`` tensor holding (block id, slot offset, width) of every block of
# every bucket, in launch order.  It is fixed for a BlockELL and a
# partition, so only the first call on them copies it from the host (and
# waits for the card); entries evict when ``val`` is garbage collected.
_TABLES: dict = {}


def _device_table(val, widths, block_rows, ids_per_bucket):
    entry = _TABLES.get(id(val))
    if entry is None:
        entry = _TABLES[id(val)] = {}
        weakref.finalize(val, _TABLES.pop, id(val), None)
    key = (widths, block_rows, ids_per_bucket)
    table = entry.get(key)
    if table is None:
        ids = np.asarray([i for blocks in ids_per_bucket for i in blocks],
                         np.int64)
        host = np.stack([ids, _segments(widths, block_rows)[ids],
                         np.asarray(widths, np.int64)[ids]], 1)
        table = entry[key] = torch.from_numpy(host).to(val.device)
    return table


def block_ell_spmm_plain(val, col, live_w, b, widths, block_rows: int,
                         num_rows: int, buckets, quantized_meta=None):
    """Plain PyTorch version of the kernel: each block of ``buckets``
    summed slot by slot over its live prefix, written to its rows of a
    zeroed ``[num_rows, F]`` output."""
    x = _dequant(b, quantized_meta)
    out = torch.zeros((num_rows, b.shape[1]), dtype=torch.float32,
                      device=val.device)
    offs = _segments(widths, block_rows)
    for _, ids in buckets:
        for blk in ids:
            w, off = int(widths[blk]), int(offs[blk])
            r0 = blk * block_rows
            r1 = min(r0 + block_rows, num_rows)
            if r1 <= r0:
                continue
            seg = slice(off, off + (r1 - r0) * w)
            v, c = val[seg].view(r1 - r0, w), col[seg].view(r1 - r0, w)
            live = torch.arange(w, device=val.device)[None, :] \
                < live_w[r0:r1, None]
            out[r0:r1] = ell_spmm_rowloop(torch.where(live, v, 0), c, x)
    return out


def block_ell_spmm(val: torch.Tensor, col: torch.Tensor, live_w: torch.Tensor,
                   b: torch.Tensor, *, widths, block_rows: int, num_rows: int,
                   buckets, quantized_meta=None) -> torch.Tensor:
    """Blocked SpMM over the blocks of ``buckets``, one launch per bucket.

    Args:
      val / col: f32 / int32 flat block segments, at least
        ``block_rows * sum(widths)`` long; ``col`` in ``[0, b.shape[0])``.
      live_w: int32 ``[len(widths) * block_rows]``, slots summed per row.
      b: ``[nodes, F]`` f32, or uint8/uint16 with ``quantized_meta``.
      widths: per-block ELL widths (>= 1).
      block_rows / num_rows: rows per block and logical rows.
      buckets: ``((bucket_width, block_ids), ...)``; a partial partition
        leaves the rows of the blocks it omits zero.
      quantized_meta: ``(scale, x_min)`` of Eq. 2 for a quantized ``b``.

    Returns f32 ``[num_rows, F]``.  CPU tensors run
    :func:`block_ell_spmm_plain`; CUDA tensors launch the kernel.
    """
    req = _build.require
    widths = tuple(int(w) for w in widths)
    nb = len(widths)
    req(nb >= 1 and min(widths) >= 1, "widths must be >= 1, one per block")
    req(block_rows >= 1 and 0 <= num_rows <= nb * block_rows < 2 ** 31,
        "num_rows must fit the blocks, and the blocks' rows an int32")
    req(val.dim() == 1 and val.dtype == torch.float32,
        "val must be f32[slots]")
    req(col.shape == val.shape and col.dtype == torch.int32,
        "col must be int32 and shaped like val")
    req(val.shape[0] >= block_rows * sum(widths),
        "val/col are shorter than the blocks' segments")
    req(live_w.shape == (nb * block_rows,) and live_w.dtype == torch.int32,
        "live_w must be int32[num_blocks * block_rows]")
    req(b.dim() == 2, "b must be [nodes, F]")
    if quantized_meta is None:
        req(b.dtype == torch.float32, f"b must be float32 (got {b.dtype})")
    else:
        req(b.dtype in _QUANT_DTYPES,
            f"a quantized b must be uint8 or uint16 (got {b.dtype})")
    ids_per_bucket = tuple(tuple(int(i) for i in blocks)
                           for _, blocks in buckets)
    ids = [i for blocks in ids_per_bucket for i in blocks]
    req(all(0 <= i < nb for i in ids) and len(set(ids)) == len(ids),
        "bucket block ids must be distinct blocks of the operand")
    for name, t in (("val", val), ("col", col), ("live_w", live_w), ("b", b)):
        req(t.is_contiguous(), f"{name} must be contiguous")
    if _build.route(val, col, live_w, b) == "cpu":
        return block_ell_spmm_plain(val, col, live_w, b, widths, block_rows,
                                    num_rows, buckets, quantized_meta)

    feat = b.shape[1]
    # a partial partition leaves its other rows zero; a full one writes all
    out = (torch.empty if len(ids) == nb else torch.zeros)(
        (num_rows, feat), dtype=torch.float32, device=val.device)
    if num_rows == 0 or feat == 0 or not ids:
        return out.zero_()
    table = _device_table(val, widths, block_rows,
                          ids_per_bucket).data_ptr()
    lib = _build.load("block_ell_spmm", _SIGNATURES)
    if quantized_meta is None:
        fn, eq2 = lib.block_ell_spmm_f32, []
    else:
        fn = getattr(lib, _QUANT_DTYPES[b.dtype])
        eq2 = [_build.ptr(t) for t in _eq2_constants(quantized_meta,
                                                      val.device)]
    start = 0
    with torch.cuda.device(val.device):
        stream = _build.stream_handle(val.device)
        for blocks in ids_per_bucket:
            n = len(blocks)
            if n == 0:
                continue
            code = fn(ctypes.c_void_p(table + 24 * start), n,
                      *[_build.ptr(t) for t in (live_w, val, col, b, out)],
                      block_rows, num_rows, feat, *eq2, stream)
            _build.check(lib, code, "block_ell_spmm")
            block_ell_spmm.launches += 1
            start += n
    return out


block_ell_spmm.launches = 0
