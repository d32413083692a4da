"""The ELL SpMM's panel rule on the CPU (``kernels/ell_spmm.py:
_panel_features``): which operands the kernel gathers panel by panel out
of L2 and how wide a panel is, from ``B``'s shape and the card's L2 alone.
The kernel itself runs on the card (``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import pytest
import torch

from repro_torch import obs
from repro_torch.kernels import ell_spmm as ell_mod

#: ``L2_cache_size`` as torch reports it: an H100 (50 MiB), an A100 (40 MiB).
H100_L2, A100_L2 = 50 * 2**20, 40 * 2**20
REDDIT, PRODUCTS = 232_965, 2_449_029


def budget(l2: int) -> float:
    return ell_mod._PANEL_L2_SHARE * l2


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_reddit_layer1_takes_the_widest_panel_that_fits(itemsize):
    """Reddit's layer-1 operand, 232,965 x 602 (f32: 561 MB, 11x the L2;
    uint16, uint8): an even panel (8-byte lanes on the 8-byte aligned f32
    rows), a power of two (whole lane groups), of 32 bytes or more a row,
    under the budget, and the widest such: twice as wide would not fit."""
    p = ell_mod._panel_features(REDDIT, 602, itemsize, H100_L2)
    assert p < 602 and p % 2 == 0 and p & (p - 1) == 0
    assert p * itemsize >= ell_mod._PANEL_MIN_BYTES
    assert REDDIT * p * itemsize <= budget(H100_L2)
    assert REDDIT * 2 * p * itemsize > budget(H100_L2)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("feat", [100, 64])
def test_products_keeps_row_order(feat, itemsize):
    """ogbn-products' operands over 2,449,029 rows: even a 32-byte panel
    of them is larger than the budget, so the walk stays in row order."""
    assert ell_mod._panel_features(PRODUCTS, feat, itemsize, H100_L2) \
        == feat


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("rows,feat", [
    # the card tests' and chip_smoke.py's ELL operands
    (8, 128), (37, 33), (64, 256), (130, 64), (16, 128), (300, 100),
    (70, 60), (517, 128), (260, 130), (50, 2048), (90, 1), (45, 3),
    (300, 128), (500, 40), (24, 9), (64, 60), (300, 2048), (300, 602),
    # make_dataset's graphs at full size, features and the hidden width
    (2708, 96), (19717, 128), (169_343, 128), (REDDIT, 128), (REDDIT, 64),
    (132_534, 128), (PRODUCTS, 100), (PRODUCTS, 64)])
def test_the_repos_other_operands_keep_row_order(rows, feat, itemsize):
    """Every operand the tests and the dataset generator give the kernel,
    in f32, uint16 and uint8: row order, P = F."""
    assert ell_mod._panel_features(rows, feat, itemsize, H100_L2) == feat


def test_a_smaller_l2_takes_a_narrower_panel():
    """On an A100's 40 MiB the Reddit panel is narrower than on an
    H100's 50 MiB, and still fits that card's budget."""
    p50 = ell_mod._panel_features(REDDIT, 602, 4, H100_L2)
    p40 = ell_mod._panel_features(REDDIT, 602, 4, A100_L2)
    assert p40 < p50 and REDDIT * p40 * 4 <= budget(A100_L2)


def test_row_order_where_no_32_byte_panel_fits():
    """A 32-byte panel larger than the budget, or an L2 too small for any
    panel width: P = F."""
    rows = int(budget(H100_L2) // 32) + 1
    assert ell_mod._panel_features(rows, 602, 4, H100_L2) == 602
    assert ell_mod._panel_features(REDDIT, 602, 4, 2**20) == 602


def test_cpu_tensors_count_no_panels():
    """CPU tensors take the plain version and count no panel launch, even
    at the panel rule's shapes."""
    reg = obs.default_registry()
    names = ("kernels.ell_spmm.panel_launches", "kernels.ell_spmm.panels")
    prev = obs.set_enabled(True)
    try:
        before = [reg.counter_value(n) for n in names]
        rows, feat = 4, 602
        out = ell_mod.ell_spmm(torch.ones((rows, 2)),
                               torch.zeros((rows, 2), dtype=torch.int32),
                               torch.full((rows,), 2, dtype=torch.int32),
                               torch.ones((1, feat)))
        assert torch.equal(out, torch.full((rows, feat), 2.0))
        assert [reg.counter_value(n) for n in names] == before
    finally:
        obs.set_enabled(prev)
