"""Adaptive edge-sampling strategy (AES) — the paper's core contribution.

Implements, bit-exactly and vectorized over all rows:

  * the strategy table (paper Table 1) mapping ``R = row_nnz / W`` to the
    sampling granularity ``N`` (consecutive elements per sample) and the
    number of samples ``sample_cnt``, as integer tests ``row_nnz <= t * W``
    (no float ``R``);
  * the hash function (paper Eq. 3)
    ``start_ind = (current_ind * 1429) mod (row_nnz - N + 1)``;
  * the strided slot layout of Algorithm 1 lines 10-12: element ``j`` of
    sample ``i`` lands in slot ``i + j * sample_cnt``.

Duplicate edges arising from overlapping hash windows are kept, as the
paper's GPU kernel keeps them.  Also provides the two ES-SpMM baselines:
AFS (accuracy-first, N=1 uniform stride) and SFS (speed-first, first-W).

These are the plain PyTorch versions; ``repro_torch.kernels.aes_sample``
is the hand-written kernel for the AES pass.  All arithmetic is int32, as
in the reference package with 64-bit mode off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs

PRIME_NUM = 1429  # paper §3.3: "prime_num is set to 1429"

# Strategy table thresholds on R = row_nnz / W (paper Table 1), as integer
# comparisons row_nnz <= k * W.
_R_THRESHOLDS = (1, 2, 36, 54)
# (N divisor of W, sample_cnt) for each band above R=1.
_BANDS = ((4, 4), (8, 8), (16, 16), (32, 32))


class SampleStrategy(NamedTuple):
    """Per-row strategy: int32 tensors, one entry per row."""

    W: torch.Tensor           # effective width  = min(row_nnz, sh_width)
    N: torch.Tensor           # consecutive elements per sample (>= 1)
    sample_cnt: torch.Tensor  # number of samples (<= W)


def get_sample_strategy(row_nnz: torch.Tensor,
                        sh_width: int) -> SampleStrategy:
    """Vectorized ``getSampleStrategy`` (Alg. 1 line 6 + Table 1), with
    the paper's clamps ``N >= 1`` and ``sample_cnt <= W``."""
    row_nnz = row_nnz.to(torch.int32)
    W = torch.clamp(row_nnz, max=sh_width)
    # The last band is the default; walk the thresholds from the top so
    # the lowest matching band wins (row_nnz <= W is the take-all band).
    N = W // _BANDS[-1][0]
    cnt = torch.full_like(W, _BANDS[-1][1])
    for t, (d, c) in reversed(list(zip(_R_THRESHOLDS[1:], _BANDS[:-1]))):
        hit = row_nnz <= t * W
        N = torch.where(hit, W // d, N)
        cnt = torch.where(hit, c, cnt)
    take_all = row_nnz <= _R_THRESHOLDS[0] * W
    N = torch.where(take_all, row_nnz, N)
    cnt = torch.where(take_all, 1, cnt)

    N = torch.clamp(N, min=1)
    cnt = torch.minimum(cnt, torch.clamp(W, min=1))
    return SampleStrategy(W=W, N=N, sample_cnt=cnt)


def hash_start_ind(sample_idx: torch.Tensor, row_nnz: torch.Tensor,
                   N: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 3: ``(current_ind * prime) mod (row_nnz - N + 1)``, the
    modulus clamped to >= 1 so empty rows are safe."""
    span = torch.clamp(row_nnz - N + 1, min=1)
    return (sample_idx * PRIME_NUM) % span


def slot_offsets(sh_width: int, strat: SampleStrategy,
                 row_nnz: torch.Tensor):
    """For every slot ``s`` in [0, sh_width), the CSR offset (relative to
    the row start) it samples, plus a validity mask.

    Slot ``s`` holds element ``j = s // sample_cnt`` of sample
    ``i = s % sample_cnt``; a slot is live iff ``s < N * sample_cnt``,
    the offset is inside the row and the row is not empty.

    Returns ``offsets, valid`` of shape ``[rows, sh_width]``.
    """
    s = torch.arange(sh_width, dtype=torch.int32,
                     device=row_nnz.device)[None, :]
    cnt = strat.sample_cnt[:, None]
    N = strat.N[:, None]
    nnz = row_nnz.to(torch.int32)[:, None]

    i = s % cnt
    j = s // cnt
    off = hash_start_ind(i, nnz, N) + j
    valid = (s < N * cnt) & (off < nnz) & (nnz > 0)
    return off, valid


def _gather_slots(row_ptr, col_ind, val, off, valid):
    """Gather CSR entries at ``row_start + off`` for valid slots, zeros
    elsewhere (the dead-slot sentinel)."""
    gidx = row_ptr[:-1, None].to(torch.int32) + off
    gidx = torch.clamp(gidx, 0, col_ind.shape[0] - 1).long()
    ell_col = torch.where(valid, col_ind[gidx], 0).to(torch.int32)
    ell_val = torch.where(valid, val[gidx], 0).to(val.dtype)
    return ell_val, ell_col


def _all_dead(row_ptr, val, sh_width):
    rows = row_ptr.shape[0] - 1
    return (torch.zeros((rows, sh_width), dtype=val.dtype,
                        device=val.device),
            torch.zeros((rows, sh_width), dtype=torch.int32,
                        device=val.device))


def sample_csr_to_ell(row_ptr: torch.Tensor, col_ind: torch.Tensor,
                      val: torch.Tensor, sh_width: int):
    """AES sampling pre-pass: CSR -> ELL(width=sh_width).

    Returns ``(ell_val[rows, sh_width], ell_col[rows, sh_width])`` with
    dead slots zeroed.
    """
    if col_ind.shape[0] == 0:  # empty graph: all slots dead
        return _all_dead(row_ptr, val, sh_width)
    row_nnz = (row_ptr[1:] - row_ptr[:-1]).to(torch.int32)
    strat = get_sample_strategy(row_nnz, sh_width)
    off, valid = slot_offsets(sh_width, strat, row_nnz)
    return _gather_slots(row_ptr, col_ind, val, off, valid)


def sample_csr_to_ell_afs(row_ptr, col_ind, val, sh_width: int):
    """ES-SpMM accuracy-first strategy: W elements at uniform stride.

    Slot s of a row with row_nnz > W samples offset
    ``floor(s * row_nnz / W)``.
    """
    if col_ind.shape[0] == 0:
        return _all_dead(row_ptr, val, sh_width)
    row_nnz = (row_ptr[1:] - row_ptr[:-1]).to(torch.int32)
    s = torch.arange(sh_width, dtype=torch.int32,
                     device=row_ptr.device)[None, :]
    nnz = row_nnz[:, None]
    off = torch.where(nnz > sh_width, (s * nnz) // sh_width, s)
    valid = (s < torch.clamp(nnz, max=sh_width)) & (nnz > 0)
    return _gather_slots(row_ptr, col_ind, val, off, valid)


def sample_csr_to_ell_sfs(row_ptr, col_ind, val, sh_width: int):
    """ES-SpMM speed-first strategy: the first W elements of each row."""
    if col_ind.shape[0] == 0:
        return _all_dead(row_ptr, val, sh_width)
    row_nnz = (row_ptr[1:] - row_ptr[:-1]).to(torch.int32)
    s = torch.arange(sh_width, dtype=torch.int32,
                     device=row_ptr.device)[None, :]
    nnz = row_nnz[:, None]
    valid = (s < torch.clamp(nnz, max=sh_width)) & (nnz > 0)
    return _gather_slots(row_ptr, col_ind, val, s, valid)


STRATEGIES = {
    "aes": sample_csr_to_ell,
    "afs": sample_csr_to_ell_afs,
    "sfs": sample_csr_to_ell_sfs,
}


# ----------------------------------------------------------------------------
# Blocked sampling: one (strategy, width) per fixed-size row block.
# ----------------------------------------------------------------------------

def sample_block_segment(csr, row_nnz_host, b: int, strat: str, width: int,
                         block_rows: int):
    """Sample one row block of a CSR into a padded ELL segment.

    Each sampler sees the global ``col_ind``/``val`` through the block's
    slice of ``row_ptr``, so only the block's own rows matter.

    Args:
      csr: the source matrix.
      row_nnz_host: numpy per-row nnz (hoisted by the caller).
      b: block index.
      strat: key of :data:`STRATEGIES` or ``"full"`` (pads to the block's
        own max row nnz; ``width`` is then ignored).
      width: requested ELL width (floored to 1).
      block_rows: rows per block; a short last block is zero-padded.

    Returns ``(val, col, live_w, width, strategy)`` with ``val``/``col`` of
    shape ``[block_rows, width]`` and ``live_w`` int32[block_rows].
    """
    from repro_torch.core.graph import ell_live_widths

    num_rows = csr.num_rows
    r0 = b * block_rows
    r1 = min(r0 + block_rows, num_rows)
    blk_nnz = row_nnz_host[r0:r1]
    if strat == "full":
        width = int(blk_nnz.max()) if len(blk_nnz) else 0
        fn = sample_csr_to_ell_sfs           # first-W == all when W >= max nnz
    else:
        fn = STRATEGIES[strat]
    width = max(int(width), 1)
    if csr.nnz == 0 or r1 <= r0:
        v, c = _all_dead(csr.row_ptr[r0:r1 + 1], csr.val, width)
    else:
        v, c = fn(csr.row_ptr[r0:r1 + 1], csr.col_ind, csr.val, width)
    pad = block_rows - (r1 - r0)
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    return v, c, ell_live_widths(v, c), width, strat


def sample_csr_to_block_ell(csr, configs, block_rows: int):
    """Stitch a mixed-width :class:`~repro_torch.core.graph.BlockELL`.

    Args:
      csr: the source matrix.
      configs: one ``(strategy, width)`` per row block
        (``ceil(num_rows / block_rows)`` entries, at least one);
        ``"full"`` pads the block to its own max row nnz.
      block_rows: rows per block; the last block is padded with empty rows.

    Returns a ``BlockELL`` whose block ``b`` is ``STRATEGIES[s]`` run on
    the rows of the block at width ``configs[b][1]``, with the reference
    package's trailing ``max_width`` zero pad, so plans keep its layout.
    """
    from repro_torch.core.graph import BlockELL, _np

    num_rows = csr.num_rows
    num_blocks = max(-(-num_rows // block_rows), 1)
    if len(configs) != num_blocks:
        raise ValueError(
            f"expected {num_blocks} block configs for {num_rows} rows at "
            f"block_rows={block_rows}, got {len(configs)}")

    rp = _np(csr.row_ptr)
    row_nnz_host = rp[1:] - rp[:-1]
    vals, cols, lives, widths, strategies = [], [], [], [], []
    for b, (strat, width) in enumerate(configs):
        v, c, live, w, s = sample_block_segment(
            csr, row_nnz_host, b, strat, width, block_rows)
        lives.append(live)
        vals.append(v.reshape(-1))
        cols.append(c.reshape(-1))
        widths.append(w)
        strategies.append(s)

    max_w = max(widths)
    vals.append(torch.zeros(max_w, dtype=csr.val.dtype, device=csr.device))
    cols.append(torch.zeros(max_w, dtype=torch.int32, device=csr.device))
    bell = BlockELL(
        val=torch.cat(vals), col=torch.cat(cols), live_w=torch.cat(lives),
        widths=tuple(widths), strategies=tuple(strategies),
        block_rows=block_rows, num_rows=num_rows, num_cols=csr.num_cols)
    if obs.enabled():
        # edges the stitched operand kept vs. discarded, and the slots the
        # per-block widths allocated (tightness against nnz)
        kept = bell.live_edges()
        obs.count("sampler.block_calls")
        obs.count("sampler.edges_kept", kept)
        obs.count("sampler.edges_dropped", max(int(csr.nnz) - kept, 0))
        obs.count("sampler.block_slots", int(bell.col.numel()) - max_w)
    return bell


def sampling_rate(row_ptr, sh_width: int) -> float:
    """Fraction of edges covered by AES sampling (unique offsets), used for
    the Fig. 5 CDF reproduction.  Host-side helper."""
    row_ptr = torch.as_tensor(row_ptr).cpu()
    row_nnz = (row_ptr[1:] - row_ptr[:-1]).to(torch.int32)
    total = int(row_nnz.sum())
    if total == 0:
        return 1.0
    strat = get_sample_strategy(row_nnz, sh_width)
    off, valid = slot_offsets(sh_width, strat, row_nnz)
    off, valid = off.numpy(), valid.numpy()
    covered = 0
    for r in range(row_nnz.shape[0]):
        covered += len(np.unique(off[r][valid[r]]))
    return covered / total
