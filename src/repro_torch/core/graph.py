"""Graph containers: CSR (paper §2.2, Fig. 1), the fixed-width ELL layout
AES sampling produces, and the GNN normalizations the models need.

Dtypes follow the reference package: int32 ``row_ptr``/``col_ind``/``col``
and float32 values.  The builders run on the host in numpy (the same code
as the reference, so their output is bit-identical) and put the result on
the device of their input; :func:`csr_from_edges` takes host arrays and a
``device=`` (default ``"cuda"``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class CSR(NamedTuple):
    """Compressed sparse row matrix.

    Invariants:
      * ``row_ptr`` is int32[num_rows + 1], non-decreasing, ``row_ptr[0] == 0``
        and ``row_ptr[-1] == nnz``;
      * ``col_ind`` is int32[nnz] with entries in ``[0, num_cols)``, the
        entries of one row stored contiguously;
      * ``val`` is f32[nnz], aligned with ``col_ind``.
    """

    row_ptr: torch.Tensor  # int32[rows + 1]
    col_ind: torch.Tensor  # int32[nnz]
    val: torch.Tensor      # f32[nnz]
    num_cols: int

    @property
    def num_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.col_ind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def row_nnz(self) -> torch.Tensor:
        """Non-zeros per row: int32[num_rows]."""
        return (self.row_ptr[1:] - self.row_ptr[:-1]).to(torch.int32)

    def to(self, device) -> "CSR":
        return CSR(self.row_ptr.to(device), self.col_ind.to(device),
                   self.val.to(device), self.num_cols)


class ELL(NamedTuple):
    """Fixed-width sampled layout: row r's live entries sit in
    ``val[r, :], col[r, :]`` with dead slots zero-valued.

    Invariants:
      * live slots form a contiguous prefix of each row;
      * the padding sentinel is ``val == 0`` *and* ``col == 0`` — a dead
        slot gathers row 0 of B but multiplies it by 0;
      * ``width`` is the width W the sampler was run with.
    """

    val: torch.Tensor  # f32[rows, W]
    col: torch.Tensor  # int32[rows, W]
    num_cols: int

    @property
    def num_rows(self) -> int:
        return self.val.shape[0]

    @property
    def width(self) -> int:
        return self.val.shape[1]

    def to(self, device) -> "ELL":
        return ELL(self.val.to(device), self.col.to(device), self.num_cols)


def ell_live_widths(val: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Per-row live-prefix lengths of an ELL segment, decoded from the
    padding sentinel (dead slot == ``val == 0 and col == 0``; live slots
    are a contiguous prefix).

    Returns int32[rows]: ``1 +`` the last live slot index (0 for all-dead
    rows).
    """
    rows, width = val.shape
    if width == 0:
        return torch.zeros(rows, dtype=torch.int32, device=val.device)
    mask = (val != 0) | (col != 0)
    pos = torch.arange(1, width + 1, dtype=torch.int32, device=val.device)
    return torch.where(mask, pos, 0).amax(dim=1).to(torch.int32)


def _csr_on(row_ptr: np.ndarray, col_ind: np.ndarray, val: np.ndarray,
            num_cols: int, device) -> CSR:
    return CSR(torch.from_numpy(np.ascontiguousarray(row_ptr)).to(device),
               torch.from_numpy(np.ascontiguousarray(col_ind)).to(device),
               torch.from_numpy(np.ascontiguousarray(val)).to(device),
               num_cols)


def csr_from_edges(src, dst, num_nodes: int, val=None, *,
                   device=None) -> CSR:
    """Build CSR of the adjacency A[dst, src] (messages flow src -> dst,
    aggregation is a row-gather over in-neighbors).  Host-side build; the
    result lands on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    v = np.ones(len(src), np.float32) if val is None \
        else np.asarray(val, np.float32)[order]
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return _csr_on(row_ptr, src.astype(np.int32), v, num_nodes, device)


def add_self_loops(csr: CSR) -> CSR:
    """A + I (GCN convention) — host-side rebuild."""
    rp, ci, v = _np(csr.row_ptr), _np(csr.col_ind), _np(csr.val)
    n = csr.num_rows
    dst = np.repeat(np.arange(n), rp[1:] - rp[:-1])
    src = np.concatenate([ci, np.arange(n)])
    dst = np.concatenate([dst, np.arange(n)])
    val = np.concatenate([v, np.ones(n, np.float32)])
    return csr_from_edges(src, dst, n, val, device=csr.device)


def gcn_normalize(csr: CSR, add_loops: bool = True) -> CSR:
    """Symmetric normalization D^-1/2 (A + I) D^-1/2 (Kipf & Welling)."""
    if add_loops:
        csr = add_self_loops(csr)
    rp, ci = _np(csr.row_ptr), _np(csr.col_ind)
    deg_in = (rp[1:] - rp[:-1]).astype(np.float64)          # row degree
    deg_out = np.bincount(ci, minlength=csr.num_rows).astype(np.float64)
    d_in = 1.0 / np.sqrt(np.maximum(deg_in, 1.0))
    d_out = 1.0 / np.sqrt(np.maximum(deg_out, 1.0))
    rows = np.repeat(np.arange(csr.num_rows), rp[1:] - rp[:-1])
    val = (_np(csr.val) * d_in[rows] * d_out[ci]).astype(np.float32)
    return CSR(csr.row_ptr, csr.col_ind,
               torch.from_numpy(val).to(csr.device), csr.num_cols)


def mean_normalize(csr: CSR) -> CSR:
    """Row-mean normalization D^-1 A (GraphSAGE mean aggregator)."""
    rp = _np(csr.row_ptr)
    deg = (rp[1:] - rp[:-1]).astype(np.float64)
    rows = np.repeat(np.arange(csr.num_rows), rp[1:] - rp[:-1])
    val = (_np(csr.val) / np.maximum(deg, 1.0)[rows]).astype(np.float32)
    return CSR(csr.row_ptr, csr.col_ind,
               torch.from_numpy(val).to(csr.device), csr.num_cols)


def csr_to_dense(csr: CSR) -> torch.Tensor:
    """Densify: f32[num_rows, num_cols] with duplicate edges accumulated —
    the exact reference the sampled kernels are tested against."""
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=csr.device), csr.row_nnz().long())
    dense = torch.zeros((csr.num_rows, csr.num_cols), dtype=csr.val.dtype,
                        device=csr.device)
    return dense.index_put_((rows, csr.col_ind.long()), csr.val,
                            accumulate=True)


def pad_csr_to_ell(csr: CSR, width: int | None = None) -> ELL:
    """No-sampling ELL: every row padded to max row_nnz (GE-SpMM-role
    baseline keeps all edges; only the layout changes).

    ``width`` overrides the ELL width (narrower values truncate rows,
    first-W).  The width floor of 1 keeps the ELL two-dimensional on an
    all-empty graph.
    """
    nnz = _np(csr.row_nnz())
    w = max(int(nnz.max(initial=0)), 1) if width is None else width
    from .sampling import sample_csr_to_ell_sfs  # first-W == all when w >= max nnz

    val, col = sample_csr_to_ell_sfs(csr.row_ptr, csr.col_ind, csr.val, w)
    return ELL(val, col, csr.num_cols)
