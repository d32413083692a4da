"""Graph containers: CSR (paper §2.2, Fig. 1), the fixed-width ELL layout
AES sampling produces, the mixed-width BlockELL layout the per-row-block
tuner stitches, and the GNN normalizations the models need.  Also the
row reorder of the degree-sorted layout and the per-row-block content
digests the plan cache is keyed by.

Dtypes follow the reference package: int32 ``row_ptr``/``col_ind``/``col``
and float32 values.  The builders run on the host in numpy (the same code
as the reference, so their output is bit-identical) and put the result on
the device of their input; :func:`csr_from_edges` takes host arrays and a
``device=`` (default ``"cuda"``).
"""
from __future__ import annotations

import hashlib
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

#: Row granularity of the content-digest blocks the plan-cache fingerprint
#: is assembled from (``csr_block_digests``).  Fixed, independent of any
#: plan's ``block_rows``, so the fingerprint of a CSR is a pure function of
#: its content (and equal to the reference package's for the same arrays).
DIGEST_BLOCK_ROWS = 4096


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
      * ``width`` is the width W the sampler was run with;
      * ``live_w``, where a producer gives it (``ops.aes_sample``, a tuned
        plan), is ``ell_live_widths(val, col)``; ``None`` otherwise.
    """

    val: torch.Tensor  # f32[rows, W]
    col: torch.Tensor  # int32[rows, W]
    num_cols: int
    live_w: Optional[torch.Tensor] = None  # int32[rows]

    @property
    def num_rows(self) -> int:
        return self.val.shape[0]

    @property
    def width(self) -> int:
        return self.val.shape[1]

    def live_widths(self) -> torch.Tensor:
        """``live_w``, or decoded from the padding sentinel
        (:func:`ell_live_widths`) where the ELL does not carry it."""
        if self.live_w is not None:
            return self.live_w
        return ell_live_widths(self.val, self.col)

    def to(self, device) -> "ELL":
        return ELL(self.val.to(device), self.col.to(device), self.num_cols,
                   None if self.live_w is None else self.live_w.to(device))


class BlockELL(NamedTuple):
    """Mixed-width ELL: one (strategy, width) per fixed-size row block.

    The rows are partitioned into ``num_blocks = ceil(num_rows /
    block_rows)`` blocks of ``block_rows`` rows (the last block padded with
    empty rows).  Block ``b`` is an ELL segment of shape
    ``[block_rows, widths[b]]`` stored flattened row-major inside the
    shared 1-D ``val``/``col``; its slots start at ``slot_offsets()[b] =
    block_rows * sum(widths[:b])``.

    Invariants (those of the reference package, so plans keep one layout):
      * ``widths`` / ``strategies`` are Python tuples of length
        ``num_blocks``; widths are >= 1;
      * dead slots carry ``val == 0`` and ``col == 0``; live slots form a
        contiguous prefix of each row, of length ``live_w[row]``;
      * ``live_w`` is int32[num_blocks * block_rows] (padded rows 0);
        ``num_rows`` is the logical row count;
      * ``val``/``col`` carry ``max_width`` zeroed elements past
        ``total_slots`` (the stitcher appends them; the Hopper kernel masks
        and never reads them).
    """

    val: torch.Tensor       # f32[total_slots + max_width]
    col: torch.Tensor       # int32[total_slots + max_width]
    live_w: torch.Tensor    # int32[num_blocks * block_rows]
    widths: tuple
    strategies: tuple
    block_rows: int
    num_rows: int
    num_cols: int

    @property
    def num_blocks(self) -> int:
        return len(self.widths)

    @property
    def padded_rows(self) -> int:
        return self.num_blocks * self.block_rows

    @property
    def total_slots(self) -> int:
        return self.block_rows * sum(self.widths)

    @property
    def max_width(self) -> int:
        return max(self.widths) if self.widths else 1

    def slot_offsets(self) -> tuple:
        """Slot offset of each block segment inside ``val``/``col``."""
        offs, acc = [], 0
        for w in self.widths:
            offs.append(acc)
            acc += self.block_rows * w
        return tuple(offs)

    def block_segment(self, b: int) -> tuple:
        """Block ``b`` as 2-D ELL arrays ``(val[block_rows, widths[b]],
        col[block_rows, widths[b]])`` — views of the flat storage."""
        off = self.slot_offsets()[b]
        w = self.widths[b]
        n = self.block_rows * w
        return (self.val[off:off + n].view(self.block_rows, w),
                self.col[off:off + n].view(self.block_rows, w))

    def live_edges(self) -> int:
        """Total live slots over logical rows (one host read)."""
        return int(self.live_w[:self.num_rows].sum())


def partition_width_buckets(widths, max_buckets: int = 3) -> tuple:
    """Partition BlockELL blocks into <= ``max_buckets`` width buckets.

    Groups the distinct widths into at most ``max_buckets`` contiguous (in
    sorted-width order) groups minimizing ``sum_b (bucket_width -
    widths[b])`` over blocks — the reference package's exact DP, so the
    same widths give the same tuple.  The Hopper kernel launches once per
    bucket; the tuner times buckets one at a time.

    Returns ``((bucket_width, block_ids), ...)`` ascending by width, the
    ``block_ids`` of all buckets a permutation of ``range(len(widths))``.
    """
    widths = tuple(int(w) for w in widths)
    if not widths:
        return ()
    max_buckets = max(int(max_buckets), 1)
    uniq = sorted(set(widths))
    counts = [sum(1 for w in widths if w == u) for u in uniq]
    m = len(uniq)
    k = min(max_buckets, m)

    # cost[i][j]: over-read of one bucket covering uniq[i..j] (width uniq[j])
    cost = [[0] * m for _ in range(m)]
    for i in range(m):
        for j in range(i, m):
            cost[i][j] = sum(counts[t] * (uniq[j] - uniq[t])
                             for t in range(i, j + 1))
    # best[i][g]: min cost splitting uniq[i:] into exactly g buckets
    inf = float("inf")
    best = [[inf] * (k + 1) for _ in range(m + 1)]
    cut = [[m] * (k + 1) for _ in range(m + 1)]
    best[m][0] = 0.0
    for i in range(m - 1, -1, -1):
        for g in range(1, k + 1):
            for j in range(i, m):
                c = cost[i][j] + best[j + 1][g - 1]
                if c < best[i][g]:
                    best[i][g], cut[i][g] = c, j
    g = min(range(1, k + 1), key=lambda gg: (best[0][gg], gg))
    bounds, i = [], 0
    while i < m:
        j = cut[i][g]
        bounds.append(uniq[j])
        i, g = j + 1, g - 1
    return buckets_within(widths, bounds)


def buckets_within(widths, bounds) -> tuple:
    """The blocks of ``widths`` grouped by ascending width ``bounds``: one
    ``(bucket_width, block_ids)`` per bound whose interval ``(previous
    bound, bound]`` holds a block, ``bucket_width`` the widest of them."""
    buckets = []
    lo = -1
    for hi in bounds:
        ids = tuple(b for b, w in enumerate(widths) if lo < w <= hi)
        if ids:
            buckets.append((max(widths[b] for b in ids), ids))
        lo = hi
    return tuple(buckets)


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


def permute_csr_rows(csr: CSR, perm) -> CSR:
    """Reorder a CSR's rows by ``perm`` (row ``r`` of the result is row
    ``perm[r]`` of the input); columns are untouched.  Rebuilt on the
    CSR's device (only ``perm`` crosses to it); per-row edge order is
    kept, so row ``r`` of the result is byte-identical to row ``perm[r]``.
    """
    dev = csr.device
    perm = torch.as_tensor(np.asarray(perm, np.int64), device=dev)
    rp = csr.row_ptr.long()
    counts = (rp[1:] - rp[:-1])[perm]
    new_rp = torch.zeros(csr.num_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=new_rp[1:])
    idx = (torch.repeat_interleave(rp[:-1][perm] - new_rp[:-1], counts,
                                   output_size=csr.nnz)
           + torch.arange(csr.nnz, dtype=torch.int64, device=dev))
    return CSR(new_rp.to(torch.int32), csr.col_ind[idx], csr.val[idx],
               csr.num_cols)


def degree_sort_permutation(csr: CSR):
    """Stable nnz-descending row permutation (the degree-sorted layout):
    hub rows pack into a few wide blocks, the sparse tail into narrow ones.

    Returns ``(perm, inv_perm, permuted_csr)`` with numpy int64 ``perm``
    (natural row id at permuted position ``p``) and ``inv_perm`` (permuted
    position of natural row ``r``: ``out[inv_perm]`` restores natural
    order), and ``permuted_csr == permute_csr_rows(csr, perm)``.
    """
    rp = _np(csr.row_ptr).astype(np.int64)
    nnz = rp[1:] - rp[:-1]
    perm = np.argsort(-nnz, kind="stable").astype(np.int64)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv_perm, permute_csr_rows(csr, perm)


def num_digest_blocks(num_rows: int,
                      digest_rows: int = DIGEST_BLOCK_ROWS) -> int:
    """Digest-block count for a row count (>= 1, even for 0 rows)."""
    return max(-(-int(num_rows) // int(digest_rows)), 1)


# Identity-keyed digest memo.  An entry is keyed by the ids of a CSR's
# three tensors and keeps weak references to them and their version
# counters: it is served only for those very tensors, unedited since (an
# in-place edit bumps ``_version`` and misses), and it is evicted when any
# of the three is garbage collected (weakref.finalize on each), before its
# id can be reused.  Inference tensors keep no version counter, so their
# digests are not memoized.  The cap is a backstop.  Only digests computed
# from the data are stored.
_DIGEST_MEMO: dict = {}
_DIGEST_MEMO_CAP = 512


def _digest_memo(csr: CSR) -> dict:
    tensors = (csr.row_ptr, csr.col_ind, csr.val)
    if any(t.is_inference() for t in tensors):
        return {}
    key = tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    entry = _DIGEST_MEMO.get(key)
    if entry is not None and all(r() is t for r, t in zip(entry[0],
                                                          tensors)):
        if entry[1] == versions:
            return entry[2]
    else:
        if len(_DIGEST_MEMO) >= _DIGEST_MEMO_CAP:
            _DIGEST_MEMO.clear()
        for t in tensors:
            weakref.finalize(t, _DIGEST_MEMO.pop, key, None)
    digests: dict = {}
    _DIGEST_MEMO[key] = (tuple(weakref.ref(t) for t in tensors), versions,
                         digests)
    return digests


def csr_block_digests(csr: CSR, digest_rows: int = DIGEST_BLOCK_ROWS,
                      blocks=None) -> list:
    """Content digests of fixed-granularity row blocks of a CSR.

    Digest block ``b`` covers rows ``[b * digest_rows, (b+1) *
    digest_rows)`` and hashes the block's locally normalized row pointers
    (int64 bytes) and its ``col_ind``/``val`` slices — the reference
    package's bytes, so the same CSR gives the same digests in both.  The
    hash runs on the host: on the card each block's ``row_ptr``,
    ``col_ind`` and ``val`` slices are copied to it, only for the blocks
    asked for and not yet memoized (by identity and version).

    Returns a list of 32-hex-char digests aligned with ``blocks`` (default:
    all ``num_digest_blocks`` blocks).
    """
    n = csr.num_rows
    if blocks is None:
        blocks = range(num_digest_blocks(n, digest_rows))
    blocks = [int(b) for b in blocks]
    memo = _digest_memo(csr)
    for b in blocks:
        if (digest_rows, b) in memo:
            continue
        r0 = min(b * digest_rows, n)
        r1 = min(r0 + digest_rows, n)
        rp = _np(csr.row_ptr[r0:r1 + 1]).astype(np.int64)
        lo, hi = int(rp[0]), int(rp[-1])
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(rp - rp[0]).tobytes())
        h.update(np.ascontiguousarray(_np(csr.col_ind[lo:hi])).tobytes())
        h.update(np.ascontiguousarray(_np(csr.val[lo:hi])).tobytes())
        memo[(digest_rows, b)] = h.hexdigest()
    return [memo[(digest_rows, b)] for b in blocks]


def combine_block_digests(digests, num_rows: int, num_cols: int,
                          digest_rows: int = DIGEST_BLOCK_ROWS) -> str:
    """Fold per-block digests into one CSR content fingerprint (the
    plan-cache key, ``repro_torch.tuning.features.fingerprint``)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([num_rows, num_cols, digest_rows],
                        np.int64).tobytes())
    for d in digests:
        h.update(bytes.fromhex(d))
    return h.hexdigest()


def _parse_deltas(entries, what: str):
    """Normalize a delta list to host (rows, cols, vals) int64/int64/f32
    arrays, as the reference package does.

    Accepts a sequence of ``(row, col)`` or ``(row, col, val)`` tuples (or
    an equivalent 2-D array).  Missing vals default to 1.0.
    """
    entries = np.asarray(list(entries), np.float64)
    if entries.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    if entries.ndim != 2 or entries.shape[1] not in (2, 3):
        raise ValueError(f"{what} must be (row, col[, val]) tuples, "
                         f"got shape {entries.shape}")
    rows = entries[:, 0].astype(np.int64)
    cols = entries[:, 1].astype(np.int64)
    if not (np.all(rows == entries[:, 0]) and np.all(cols == entries[:, 1])):
        raise ValueError(f"{what} rows/cols must be integers")
    vals = (entries[:, 2].astype(np.float32) if entries.shape[1] == 3
            else np.ones(len(rows), np.float32))
    return rows, cols, vals


def _member(sorted_keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``query[i] in sorted_keys`` for every ``i``, by binary search."""
    if sorted_keys.numel() == 0:
        return torch.zeros(query.shape, dtype=torch.bool,
                           device=query.device)
    pos = torch.searchsorted(sorted_keys, query)
    hit = pos < sorted_keys.numel()
    return hit & (sorted_keys[pos.clamp(max=sorted_keys.numel() - 1)]
                  == query)


def apply_csr_deltas(csr: CSR, additions=(), deletions=()):
    """Apply edge insertions and deletions to a CSR, tracking touched rows.

    Deletions are applied first, then additions.  The node set is fixed:
    deltas must reference existing row/col ids.  Every delta must change
    the graph, so a patched plan's provenance is exact.

    Args:
      csr: source matrix.
      additions: ``(row, col)`` or ``(row, col, val)`` tuples; ``val``
        defaults to 1.0.  Adding a pair still present after deletions, a
        pair listed twice, or an out-of-range id raises ``ValueError``.
      deletions: ``(row, col)`` tuples.  A deletion removes *every* stored
        instance of the pair; deleting an absent or repeated pair raises
        ``ValueError``.

    The merge runs on the CSR's device: only the delta lists, the scalars
    the ``ValueError`` checks read and the new edge count cross to the
    host.  Values are moved, never computed, so the result is the
    reference package's, bit for bit.

    Returns ``(new_csr, touched_rows)``, the CSR on ``csr``'s device and
    ``touched_rows`` a sorted unique int64 numpy array (an empty delta
    returns ``csr`` itself).  Untouched rows keep byte-identical
    ``col_ind``/``val`` slices (their :func:`csr_block_digests` stay
    valid); touched rows are re-sorted by column.
    """
    add_r, add_c, add_v = _parse_deltas(additions, "additions")
    del_r, del_c, _ = _parse_deltas(deletions, "deletions")
    if add_r.size == 0 and del_r.size == 0:
        return csr, np.zeros(0, np.int64)

    n, m = csr.num_rows, csr.num_cols
    for what, r, c in (("additions", add_r, add_c),
                       ("deletions", del_r, del_c)):
        if r.size and (r.min() < 0 or r.max() >= n):
            raise ValueError(f"{what} row out of range [0, {n})")
        if c.size and (c.min() < 0 or c.max() >= m):
            raise ValueError(f"{what} col out of range [0, {m})")
    del_keys = del_r * m + del_c
    if np.unique(del_keys).size != del_keys.size:
        raise ValueError("duplicate (row, col) pair in deletions")

    dev = csr.device
    i64 = dict(dtype=torch.int64, device=dev)
    rp = csr.row_ptr.long()
    ci, v = csr.col_ind, csr.val
    old_cnt = rp[1:] - rp[:-1]
    edge_rows = torch.repeat_interleave(torch.arange(n, **i64), old_cnt,
                                        output_size=csr.nnz)
    touched = np.unique(np.concatenate([del_r, add_r]))
    touched_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    touched_mask[torch.as_tensor(touched, device=dev)] = True
    edge_touched = touched_mask[edge_rows]

    # Every membership check involves touched rows only, so the key
    # arithmetic stays O(touched edges).
    tidx = torch.nonzero(edge_touched).flatten()
    t_rows = edge_rows[tidx]
    tkeys = t_rows * m + ci[tidx].long()
    # Rows are column-sorted in every CSR the builders make, so tkeys is
    # ascending and the merge below skips both sorts.
    presorted = tkeys.numel() < 2 or not bool((tkeys[1:] < tkeys[:-1]).any())
    stkeys = tkeys if presorted else torch.sort(tkeys).values

    dk = torch.as_tensor(del_keys, device=dev)
    missing = ~_member(stkeys, dk)
    if bool(missing.any()):
        i = int(np.flatnonzero(_np(missing))[0])
        raise ValueError(f"deletion ({del_r[i]}, {del_c[i]}) not present")
    keep_t = ~_member(torch.sort(dk).values, tkeys)
    add_keys = add_r * m + add_c
    if np.unique(add_keys).size != add_keys.size:
        raise ValueError("duplicate (row, col) pair in additions")
    surv_keys = tkeys[keep_t]                # order-preserving mask
    if not presorted:
        surv_keys = torch.sort(surv_keys).values
    clash = _member(surv_keys, torch.as_tensor(add_keys, device=dev))
    if bool(clash.any()):
        i = int(np.flatnonzero(_np(clash))[0])
        raise ValueError(f"addition ({add_r[i]}, {add_c[i]}) already present")

    # surviving edges of touched rows + additions, sorted by (row, col)
    sel = tidx[keep_t]
    sb_r, sb_c, sb_v = t_rows[keep_t], ci[sel].long(), v[sel]
    aorder = np.lexsort((add_c, add_r))
    sa_r = torch.as_tensor(add_r[aorder], device=dev)
    sa_c = torch.as_tensor(add_c[aorder], device=dev)
    sa_v = torch.as_tensor(add_v[aorder], device=dev)
    if presorted:
        # two-way merge of the (already sorted) survivors with the sorted
        # additions: no key is in both (the clash check above)
        ak = sa_r * m + sa_c
        nb, na = surv_keys.numel(), ak.numel()
        pr = torch.empty(nb + na, **i64)
        pc = torch.empty(nb + na, **i64)
        pv = torch.empty(nb + na, dtype=v.dtype, device=dev)
        bpos = torch.arange(nb, **i64) + torch.searchsorted(ak, surv_keys)
        apos = torch.searchsorted(surv_keys, ak) + torch.arange(na, **i64)
        pr[bpos], pc[bpos], pv[bpos] = sb_r, sb_c, sb_v
        pr[apos], pc[apos], pv[apos] = sa_r, sa_c, sa_v
    else:
        # a stable sort on row * m + col is lexsort((col, row))
        pr = torch.cat([sb_r, sa_r])
        pc = torch.cat([sb_c, sa_c])
        pv = torch.cat([sb_v, sa_v])
        order = torch.sort(pr * m + pc, stable=True).indices
        pr, pc, pv = pr[order], pc[order], pv[order]

    new_cnt = (old_cnt - torch.bincount(t_rows[~keep_t], minlength=n)
               + torch.bincount(sa_r, minlength=n))
    new_rp = torch.zeros(n + 1, **i64)
    torch.cumsum(new_cnt, 0, out=new_rp[1:])
    nnz_new = int(new_rp[-1])
    new_ci = torch.empty(nnz_new, dtype=ci.dtype, device=dev)
    new_v = torch.empty(nnz_new, dtype=v.dtype, device=dev)

    # untouched edges land at their original within-row offsets
    un = torch.nonzero(~edge_touched).flatten()
    shift = new_rp[:-1] - rp[:-1]
    dest = un + shift[edge_rows[un]]
    new_ci[dest] = ci[un]
    new_v[dest] = v[un]

    # touched rows: contiguous sorted groups at their new row starts
    pstart = torch.zeros(n + 1, **i64)
    torch.cumsum(torch.bincount(pr, minlength=n), 0, out=pstart[1:])
    dest = new_rp[pr] + (torch.arange(pr.numel(), **i64) - pstart[pr])
    new_ci[dest] = pc.to(ci.dtype)
    new_v[dest] = pv

    return CSR(new_rp.to(torch.int32), new_ci, new_v, m), touched
