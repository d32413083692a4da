"""Cheap graph fingerprint + sparsity statistics for the auto-tuner.

Everything the cost model needs is derived from the CSR *structure* in one
O(nnz) host pass (on the card: one device-to-host copy of ``row_ptr``): a
log2 row-nnz histogram (enough to evaluate ``sum_r min(row_nnz_r, W)`` for
any candidate W), skew summaries, and a content fingerprint that keys the
plan cache.

The fingerprint hashes the exact CSR arrays (structure *and* values) as a
combination of fixed-granularity per-row-block digests
(``repro_torch.core.graph.csr_block_digests``), the bytes the reference
package hashes, so the same CSR gets the same hex key in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

import torch

from repro_torch.core.graph import (CSR, _np, combine_block_digests,
                                    csr_block_digests)

# log2 buckets: bucket b counts rows with row_nnz in [2^b, 2^(b+1)).
# 2^31 caps any realistic degree; empty rows get their own implicit bucket
# via ``empty_rows``.
_NUM_BUCKETS = 32


def fingerprint(csr: CSR) -> str:
    """Content hash of a CSR matrix — the plan-cache key.

    blake2b folded over :data:`~repro_torch.core.graph.DIGEST_BLOCK_ROWS`-row
    block digests (structure *and* values).  O(nnz) but pure memory
    traffic; negligible next to one SpMM over the same data — and
    incrementally maintainable: patching the touched blocks' digests and
    re-combining reproduces this value exactly.
    """
    return combine_block_digests(
        csr_block_digests(csr), csr.num_rows, csr.num_cols)


@dataclass(frozen=True)
class GraphFeatures:
    """Sparsity statistics summarizing a CSR for the cost model."""

    num_rows: int
    num_cols: int
    nnz: int
    feat_dim: int                   # dense-operand width the SpMM will see
    empty_rows: int
    max_row_nnz: int
    avg_row_nnz: float
    row_cv: float                   # std/mean of row_nnz — degree skew
    tail_edge_frac: float           # fraction of edges in the top-1% rows
    hist: tuple[int, ...] = field(repr=False)   # log2 row-nnz histogram
    fingerprint: str = ""

    @property
    def density(self) -> float:
        denom = self.num_rows * max(self.num_cols, 1)
        return self.nnz / denom if denom else 0.0

    # -- histogram queries the cost model evaluates per candidate W --------

    def _bucket_mids(self) -> np.ndarray:
        lo = 2.0 ** np.arange(_NUM_BUCKETS)
        return np.minimum(lo * 1.5, self.max_row_nnz or 1.0)

    def sum_min_nnz(self, width: int) -> float:
        """Approximate ``sum_r min(row_nnz_r, width)`` from the histogram —
        the number of live ELL slots a width-``width`` sampler produces."""
        if width >= self.max_row_nnz:
            return float(self.nnz)  # no row truncates: exact
        mids = self._bucket_mids()
        counts = np.asarray(self.hist, np.float64)
        return float((counts * np.minimum(mids, width)).sum())

    def covered_edge_frac(self, width: int) -> float:
        """Fraction of edges landing inside a width-``width`` row window."""
        if self.nnz == 0:
            return 1.0
        return min(self.sum_min_nnz(width) / self.nnz, 1.0)


def _stats_from_row_nnz(row_nnz: np.ndarray, num_cols: int, feat_dim: int,
                        fp: str = "") -> GraphFeatures:
    """Histogram + skew summaries for one degree sequence (shared by the
    whole-graph and per-block extractors)."""
    row_nnz = np.asarray(row_nnz, np.int64)
    nnz = int(row_nnz.sum())
    num_rows = len(row_nnz)

    nonzero = row_nnz[row_nnz > 0]
    hist = np.zeros(_NUM_BUCKETS, np.int64)
    if len(nonzero):
        buckets = np.minimum(np.log2(nonzero).astype(np.int64), _NUM_BUCKETS - 1)
        np.add.at(hist, buckets, 1)

    mean = float(row_nnz.mean()) if num_rows else 0.0
    cv = float(row_nnz.std() / mean) if mean > 0 else 0.0

    tail_frac = 0.0
    if nnz > 0:
        k = max(num_rows // 100, 1)
        top = np.partition(row_nnz, num_rows - k)[num_rows - k:]
        tail_frac = float(top.sum() / nnz)

    return GraphFeatures(
        num_rows=num_rows,
        num_cols=num_cols,
        nnz=nnz,
        feat_dim=feat_dim,
        empty_rows=int((row_nnz == 0).sum()),
        max_row_nnz=int(row_nnz.max()) if num_rows else 0,
        avg_row_nnz=mean,
        row_cv=cv,
        tail_edge_frac=tail_frac,
        hist=tuple(int(c) for c in hist),
        fingerprint=fp,
    )


def extract_features(csr: CSR, feat_dim: int = 64,
                     with_fingerprint: bool = True) -> GraphFeatures:
    """One host pass over the CSR: histogram + skew + (optional) fingerprint.

    Args:
      csr: the graph to summarize.
      feat_dim: width of the dense operand the SpMM will multiply (the cost
        model's FLOP/byte counts scale linearly in it).
      with_fingerprint: also hash the arrays (skippable when the caller
        already has the plan-cache key).

    Returns a :class:`GraphFeatures`.
    """
    row_ptr = _np(csr.row_ptr)
    row_nnz = (row_ptr[1:] - row_ptr[:-1]).astype(np.int64)
    return _stats_from_row_nnz(
        row_nnz, csr.num_cols, feat_dim,
        fp=fingerprint(csr) if with_fingerprint else "")


def extract_block_features(csr: CSR, block_rows: int, feat_dim: int = 64,
                           blocks=None) -> list[GraphFeatures]:
    """Blocked variant of :func:`extract_features`: one ``GraphFeatures``
    per fixed-size row block, still one O(nnz) host pass overall.

    Args:
      csr: the graph to summarize.
      block_rows: rows per block; the last block may be short (its
        statistics cover only the real rows).
      feat_dim: dense-operand width, as in :func:`extract_features`.
      blocks: optional iterable of block ids to summarize (default: all
        blocks).  The delta path uses this to re-rank only touched blocks.

    Returns feature records aligned with ``blocks`` (by default
    ``ceil(num_rows / block_rows)`` of them, at least one, empty-graph
    safe).  Fingerprints are left blank — blocked plans are keyed by the
    whole-graph fingerprint, not per block.
    """
    num_rows = csr.num_rows
    row_ptr = None
    if blocks is None:
        blocks = range(max(-(-num_rows // block_rows), 1))
        row_ptr = _np(csr.row_ptr).astype(np.int64)
    out = []
    for b in blocks:
        r0 = min(int(b) * block_rows, num_rows)
        r1 = min(r0 + block_rows, num_rows)
        # the delta path (``blocks`` given) copies only its blocks' slices
        rp = row_ptr[r0:r1 + 1] if row_ptr is not None \
            else _np(csr.row_ptr[r0:r1 + 1]).astype(np.int64)
        out.append(_stats_from_row_nnz(rp[1:] - rp[:-1], csr.num_cols,
                                       feat_dim))
    return out


def features_from_row_nnz(row_nnz: Sequence[int], num_cols: int,
                          feat_dim: int = 64) -> GraphFeatures:
    """Build features from a degree sequence alone (tests / what-if sizing)."""
    row_nnz = np.asarray(row_nnz, np.int64)
    ptr = np.zeros(len(row_nnz) + 1, np.int64)
    np.cumsum(row_nnz, out=ptr[1:])
    fake = CSR(torch.from_numpy(ptr.astype(np.int32)),
               torch.zeros(int(row_nnz.sum()), dtype=torch.int32),
               torch.zeros(int(row_nnz.sum()), dtype=torch.float32), num_cols)
    return extract_features(fake, feat_dim=feat_dim, with_fingerprint=False)
