"""1-D row partition of a CSR adjacency into per-device serving shards.

The sharded engine (``repro_torch.serving.engine``) row-partitions the
graph: shard ``s`` owns a contiguous row range and computes exactly those
output rows of ``C = A @ B``.  Row partitioning keeps every edge's
*accumulation* shard-local (each output row is produced by one shard), at
the price of a *halo*: columns of shard ``s``'s rows that reference nodes
owned by other shards need those nodes' feature rows gathered in before
the SpMM.

Each :class:`CSRShard` therefore carries

  * a remapped local CSR whose column space is ``[local rows | halo
    nodes]`` — local columns first (shifted to shard-relative ids), then
    the shard's sorted unique halo node ids — on the device of the source
    CSR;
  * ``gather_index`` — the global feature rows, local then halo, that
    build the shard's dense operand ``B_s = B[gather_index]`` (an
    ``index_select`` on the operand's device).  Per-row edge order is
    preserved by the remap, so each output row accumulates in exactly the
    order the unsharded kernel would use.

The index arithmetic runs on the host in numpy, as in the reference
package, so ``halo_ids``/``gather_index`` and the shard CSRs equal the
reference's bit for bit.  The split is balanced by *rows* (the first
``num_rows % num_shards`` shards take one extra row).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.graph import CSR, _np


def row_bounds(num_rows: int, num_shards: int) -> np.ndarray:
    """Balanced contiguous row boundaries: int64[num_shards + 1].

    ``bounds[s]:bounds[s+1]`` is shard ``s``'s row range; the first
    ``num_rows % num_shards`` shards own one extra row.
    """
    num_rows, num_shards = int(num_rows), int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > num_rows:
        raise ValueError(
            f"cannot split {num_rows} rows into {num_shards} shards "
            "(empty shards would serve no rows)")
    base, rem = divmod(num_rows, num_shards)
    sizes = np.full(num_shards, base, np.int64)
    sizes[:rem] += 1
    bounds = np.zeros(num_shards + 1, np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds


@dataclass(frozen=True)
class CSRShard:
    """One shard of a row-partitioned adjacency.

    ``csr`` is the shard's rows with columns remapped into the compact
    ``[0, num_local + num_halo)`` space; ``gather_index`` maps that space
    back to global node ids (``gather_index[:num_local]`` is
    ``arange(row_start, row_stop)``, the rest are the sorted halo ids).
    """

    csr: CSR
    shard_idx: int
    num_shards: int
    row_start: int
    row_stop: int
    halo_ids: np.ndarray      # sorted unique global ids owned elsewhere
    gather_index: np.ndarray  # int64[num_local + num_halo] global rows
    # gather_index per device, so a gather copies no index from the host
    # (a pageable host-to-device copy waits for the card)
    _index_on: dict = field(default_factory=dict, init=False, repr=False,
                            compare=False)

    @property
    def num_rows(self) -> int:
        """Output rows this shard produces (== local nodes)."""
        return self.row_stop - self.row_start

    @property
    def num_local(self) -> int:
        return self.row_stop - self.row_start

    @property
    def num_halo(self) -> int:
        return len(self.halo_ids)

    def index_on(self, device) -> torch.Tensor:
        """``gather_index`` as an int64 tensor on ``device`` (memoized)."""
        device = torch.device(device)
        idx = self._index_on.get(device)
        if idx is None:
            idx = self._index_on[device] = torch.from_numpy(
                self.gather_index).to(device)
        return idx

    def gather(self, features) -> torch.Tensor:
        """The shard's dense operand: ``B[gather_index]`` (local rows
        first, then halo rows) — shape ``[num_local + num_halo, feat]``,
        on ``features``' device."""
        features = torch.as_tensor(features)
        return features.index_select(0, self.index_on(features.device))


def _shard_csr(row_ptr: np.ndarray, cols: np.ndarray, val: torch.Tensor,
               num_cols: int, device) -> CSR:
    """A shard CSR on ``device`` from host int64 ``row_ptr``/``cols`` and
    the (already device-resident) values."""
    return CSR(torch.from_numpy(row_ptr.astype(np.int32)).to(device),
               torch.from_numpy(cols.astype(np.int32)).to(device),
               val, num_cols=int(num_cols))


def partition_csr(csr: CSR, num_shards: int) -> list[CSRShard]:
    """Split a CSR into ``num_shards`` row shards with local/halo columns.

    Args:
      csr: the adjacency (square in the GNN case; only rows are split, the
        column space is the full node set before remapping).
      num_shards: shard count; must not exceed ``csr.num_rows``.

    Returns one :class:`CSRShard` per shard, ascending by row range, each
    CSR on ``csr``'s device.  Concatenating the shards' SpMM outputs in
    order reconstructs the unsharded output exactly.
    """
    rp = _np(csr.row_ptr).astype(np.int64)
    ci = _np(csr.col_ind).astype(np.int64)
    bounds = row_bounds(csr.num_rows, num_shards)

    shards = []
    for s in range(int(num_shards)):
        r0, r1 = int(bounds[s]), int(bounds[s + 1])
        lo, hi = int(rp[r0]), int(rp[r1])
        cols = ci[lo:hi]
        local = (cols >= r0) & (cols < r1)
        halo_ids = np.unique(cols[~local])
        n_local = r1 - r0
        # np.where evaluates both branches: searchsorted of a *local* col
        # returns garbage but is masked out.
        remapped = np.where(local, cols - r0,
                            n_local + np.searchsorted(halo_ids, cols))
        shard_csr = _shard_csr(rp[r0:r1 + 1] - lo, remapped,
                               csr.val[lo:hi],
                               n_local + len(halo_ids), csr.device)
        gather = np.concatenate([np.arange(r0, r1, dtype=np.int64),
                                 halo_ids])
        shards.append(CSRShard(
            csr=shard_csr, shard_idx=s, num_shards=int(num_shards),
            row_start=r0, row_stop=r1, halo_ids=halo_ids,
            gather_index=gather))
    return shards


def halo_stats(shards: list[CSRShard]) -> dict:
    """Partition-quality summary: how much feature traffic the halo adds."""
    local = sum(s.num_local for s in shards)
    halo = sum(s.num_halo for s in shards)
    return {
        "num_shards": len(shards),
        "rows_per_shard": [s.num_rows for s in shards],
        "halo_per_shard": [s.num_halo for s in shards],
        "halo_rows_total": halo,
        "halo_expansion": (local + halo) / max(local, 1),
    }


def concat_shard_outputs(outputs, device=None) -> torch.Tensor:
    """Stitch per-shard SpMM outputs (ascending shard order) back into the
    global row order — a plain concat, since shards own contiguous ranges.

    Outputs on other devices are copied device to device to ``device``
    (default: the first output's) — no host round trip on the serving hot
    path.
    """
    outputs = [torch.as_tensor(o) for o in outputs]
    if device is None:
        device = outputs[0].device
    return torch.cat([o.to(device) for o in outputs], dim=0)
