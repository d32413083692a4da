"""The plain reference's frozen copy of AES sampling (the paper's Table 1,
Eq. 3 and the strided slot layout of Algorithm 1), in plain PyTorch.

For a row of ``nnz`` entries and sampling width ``width``, with
``w = min(nnz, width)`` and ``R = nnz / w``:

| band | R          | N (elements a sample) | sample_cnt |
|------|------------|-----------------------|------------|
| 0    | R <= 1     | nnz                   | 1          |
| 1    | R <= 2     | w // 4                | 4          |
| 2    | R <= 36    | w // 8                | 8          |
| 3    | R <= 54    | w // 16               | 16         |
| 4    | R > 54     | w // 32               | 32         |

with ``N >= 1`` and ``sample_cnt <= max(w, 1)``.  Sample ``i`` starts at
``(i * 1429) mod (nnz - N + 1)`` (Eq. 3, the modulus at least 1), and its
element ``j`` lands in slot ``i + j * sample_cnt``; a slot is live when it
is below ``N * sample_cnt`` and its offset lies inside a non-empty row.
Repeated entries from overlapping samples are kept.
"""
from __future__ import annotations

import torch

PRIME = 1429
#: R thresholds of bands 1-4 (``nnz <= t * w``), and (divisor of w,
#: sample_cnt) for bands 1-4.
THRESHOLDS = (1, 2, 36, 54)
DIVISORS = (4, 8, 16, 32)


def strategy(nnz: torch.Tensor, width: int):
    """``(N, sample_cnt)`` of every row, int64, from its entry count."""
    nnz = nnz.long()
    w = nnz.clamp(max=width)
    band = sum((nnz > t * w).long() for t in THRESHOLDS)
    div = torch.tensor((1,) + DIVISORS, device=nnz.device)[band]
    n_per = torch.where(band == 0, nnz, w // div).clamp(min=1)
    cnt = torch.minimum(div, w.clamp(min=1))
    return n_per, cnt


def live_slots(nnz: torch.Tensor, width: int) -> torch.Tensor:
    """Live slots of every row: ``N * sample_cnt`` for a non-empty row
    (every such slot's offset lies inside the row), else 0."""
    n_per, cnt = strategy(nnz, width)
    return torch.where(nnz > 0, n_per * cnt, torch.zeros_like(n_per))


def sample_rows(row_ptr, col, val, nnz, n_per, cnt, r0: int, r1: int,
                width: int):
    """Rows ``[r0, r1)`` sampled to ``width`` slots: ``(val, col)`` of
    shape ``[r1 - r0, width]``, dead slots zero, and the live mask."""
    s = torch.arange(width, device=col.device)[None, :]
    k, c, z = nnz[r0:r1, None], cnt[r0:r1, None], n_per[r0:r1, None]
    span = (k - z + 1).clamp(min=1)
    off = (s % c) * PRIME % span + s // c
    live = (s < z * c) & (off < k) & (k > 0)
    idx = (row_ptr[r0:r1, None].long() + off).clamp(0, max(col.numel() - 1,
                                                           0))
    if col.numel() == 0:
        zero = torch.zeros(r1 - r0, width, device=col.device)
        return zero.to(val.dtype), zero.long(), live
    return (torch.where(live, val[idx], 0), torch.where(live, col[idx].long(),
                                                        0), live)
