"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package (the machine with the card has no
JAX), so on that machine run it without the suite's conftest::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: the sampler and the dequantization are bit-exact; float SpMM
agrees to 1e-5 (nvcc contracts a*b+c into FMA, the plain version rounds
twice; the blocked kernel rounds twice too, so it is exact, and is held to
the same 1e-5); the quantized gather to 1e-4, as in the reference package's
tests; the fused layer to 1e-4, the tolerance of
tests/test_conformance.py:_path_fused_layer (its transform sums in
another order than cuBLAS).  Cases loop inside
tests, so the file stays smaller than the JAX package's test files (see
tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.graph import CSR, csr_from_edges, ell_live_widths
from repro_torch.core.graph import partition_width_buckets
from repro_torch.core.quantization import quantize
from repro_torch.core.sampling import sample_csr_to_block_ell
from repro_torch.kernels import _build, ops
from repro_torch.kernels import aes_sample as aes_mod
from repro_torch.kernels import block_ell_spmm as block_mod
from repro_torch.kernels import dequant as dequant_mod
from repro_torch.kernels import ell_spmm as ell_mod
from repro_torch.kernels import fused_layer as layer_mod
from repro_torch.kernels import fused_spmm as fused_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the H100 with "
                    "`python -m pytest --noconftest tests/test_torch_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(seed: int, n: int, avg_deg: float, skew: float, device,
           hub: int = 0) -> CSR:
    """Power-law-ish random graph; ``hub`` adds one row of that many edges."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(skew, n) + 0.2 if skew else np.ones(n)
    deg = (raw / raw.mean() * avg_deg).astype(np.int64)
    dst = np.repeat(np.arange(n), deg)
    if hub:
        dst = np.concatenate([dst, np.full(hub, n // 2)])
    src = rng.integers(0, n, dst.shape[0])
    val = rng.normal(size=dst.shape[0]).astype(np.float32)
    return csr_from_edges(src, dst, n, val, device=device)


def _check_all(g: CSR, x: torch.Tensor, W: int):
    ops.reset_launch_counts()
    ell = ops.aes_sample(g, W)
    val, col = aes_mod.aes_sample_plain(g.row_ptr, g.col_ind, g.val, W)
    assert torch.equal(ell.val, val) and torch.equal(ell.col, col)
    live = ell_live_widths(ell.val, ell.col)
    torch.testing.assert_close(
        ops.ell_spmm(ell, x, live),
        ell_mod.ell_spmm_plain(ell.val, ell.col, live, x),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        ops.fused_aes_spmm(g, x, W),
        fused_mod.fused_aes_spmm_plain(g.row_ptr, g.col_ind, g.val, x, W),
        rtol=1e-5, atol=1e-5)
    for bits in (8, 16):
        qf = quantize(x, bits)
        meta = (qf.scale, qf.x_min)
        torch.testing.assert_close(
            ops.ell_spmm(ell, qf.q, live, quantized_meta=meta),
            ell_mod.ell_spmm_plain(ell.val, ell.col, live, qf.q, meta),
            rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"aes_sample": 1, "ell_spmm": 3,
                                   "fused_aes_spmm": 1, "fused_layer": 0,
                                   "dequantize": 0, "block_ell_spmm": 0}


def test_kernels_match_plain(cuda):
    for n, feat, W in ((8, 128, 8), (37, 33, 16), (64, 256, 4),
                       (130, 64, 32), (16, 128, 1), (300, 100, 128),
                       (70, 60, 16)):
        g = _graph(n + W, n, 9.0, 0.7, cuda)
        x = torch.randn((n, feat), generator=torch.Generator().manual_seed(n)
                        ).to(cuda)
        _check_all(g, x, W)


def test_hub_row_far_above_w(cuda):
    g = _graph(1, 500, 4.0, 0.0, cuda, hub=20000)
    x = torch.randn((500, 40), generator=torch.Generator().manual_seed(2)
                    ).to(cuda)
    for W in (1, 16, 128):
        _check_all(g, x, W)


def test_empty_graph_and_empty_rows(cuda):
    empty = csr_from_edges(np.zeros(0), np.zeros(0), 24, device=cuda)
    x = torch.randn((24, 9), generator=torch.Generator().manual_seed(3)
                    ).to(cuda)
    _check_all(empty, x, 4)
    assert not ops.ell_spmm(ops.aes_sample(empty, 4), x).any()
    rows = np.repeat(np.arange(20), 3)
    partial = csr_from_edges(np.arange(60) % 40, rows, 40, device=cuda)
    _check_all(partial, torch.randn((40, 9), device=cuda), 16)


def test_wide_w_uses_opt_in_shared_memory(cuda):
    """W = 8192 stages 64 KiB, above the 48 KiB default a block gets."""
    g = _graph(4, 64, 2.0, 0.0, cuda, hub=30000)
    x = torch.randn((64, 32), generator=torch.Generator().manual_seed(4)
                    ).to(cuda)
    _check_all(g, x, 8192)


def test_every_kernel_builds_for_sm90a(cuda):
    seconds = _build.build()
    assert set(seconds) == set(_build.KERNELS)
    for name in _build.KERNELS:
        assert _build.library_path(name).exists()


def test_fused_layer_matches_plain(cuda):
    """f32/u8/u16 B, both activations, ragged F and H up to H=41, and
    F = H = 2048, whose 64 KiB aggregation tile needs opt-in shared
    memory."""
    for n, feat, hidden, W in ((37, 33, 41, 16), (70, 60, 5, 128),
                               (130, 64, 1, 4), (24, 2048, 2048, 8)):
        g = _graph(n + W, n, 9.0, 0.7, cuda)
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.normal(size=(n, feat)).astype(np.float32)
                             ).to(cuda)
        w = torch.from_numpy((rng.normal(size=(feat, hidden))
                              / np.sqrt(feat)).astype(np.float32)).to(cuda)
        bias = torch.from_numpy(rng.normal(size=hidden).astype(np.float32)
                                ).to(cuda)
        ell = ops.aes_sample(g, W)
        live = ell_live_widths(ell.val, ell.col)
        ops.reset_launch_counts()
        for relu in (True, False):
            for bits in (None, 8, 16):
                b, meta = x, None
                if bits is not None:
                    qf = quantize(x, bits)
                    b, meta = qf.q, (qf.scale, qf.x_min)
                torch.testing.assert_close(
                    ops.fused_layer_spmm(ell, b, w, bias, live, relu=relu,
                                         quantized_meta=meta),
                    layer_mod.fused_layer_plain(ell.val, ell.col, live, b, w,
                                                bias, relu=relu,
                                                quantized_meta=meta),
                    rtol=1e-4, atol=1e-4,
                    msg=lambda m: f"F={feat} H={hidden} relu={relu} "
                                  f"bits={bits}: {m}")
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_layer"] == 6


def test_dequantize_bit_exact(cuda):
    """tests/test_kernels.py's shapes, plus a misaligned view (the scalar
    path) and a length that leaves a vector tail."""
    ops.reset_launch_counts()
    calls = 0
    for shape in ((8, 128), (256, 128), (100, 33), (1, 1), (1001, 37)):
        for bits in (8, 16):
            x = torch.from_numpy(np.random.default_rng(3).normal(
                size=shape).astype(np.float32) * 5).to(cuda)
            qf = quantize(x, bits)
            for q in (qf.q, qf.q.reshape(-1)[1:].reshape(1, -1)):
                got = ops.dequantize(q, qf.scale, qf.x_min, bits=bits)
                assert torch.equal(got, dequant_mod.dequantize_plain(
                    q, qf.scale, qf.x_min)), (shape, bits)
                calls += q.numel() > 0
    torch.cuda.synchronize()
    assert ops.launch_counts()["dequantize"] == calls == 18


def test_block_ell_spmm_matches_plain(cuda):
    """f32/u8/u16 B over mixed strategies at block_rows in {1, 16, 256},
    one to three width buckets and a partial partition (its other rows
    zero), on graphs with a ragged last block and with a "full" block
    wider than 1024 slots; to 1e-5 (f32) and 1e-4 (quantized)."""
    strategies = (("aes", 8), ("full", 0), ("sfs", 4), ("afs", 32))
    for n, feat, block_rows, hub in ((37, 33, 1, 0), (300, 100, 16, 3000),
                                     (700, 128, 256, 0), (130, 64, 16, 0)):
        g = _graph(n + block_rows, n, 9.0, 0.7, cuda, hub=hub)
        nb = -(-n // block_rows)
        configs = [strategies[b % len(strategies)] for b in range(nb)]
        bell = sample_csr_to_block_ell(g, configs, block_rows)
        assert not hub or max(bell.widths) > 1024
        x = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, feat)).astype(np.float32)).to(cuda)
        operands = [(x, None, 1e-5)]
        for bits in (8, 16):
            qf = quantize(x, bits)
            operands.append((qf.q, (qf.scale, qf.x_min), 1e-4))
        parts = [partition_width_buckets(bell.widths, k) for k in (1, 2, 3)]
        parts.append(((max(bell.widths), tuple(range(0, nb, 2))),))
        ops.reset_launch_counts()
        for buckets in parts:
            for b, meta, tol in operands:
                got = ops.block_ell_spmm(bell, b, quantized_meta=meta,
                                         buckets=buckets)
                want = block_mod.block_ell_spmm_plain(
                    bell.val, bell.col, bell.live_w, b, bell.widths,
                    block_rows, n, buckets, meta)
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m: f"n={n} rows={block_rows} {buckets}: {m}")
        torch.cuda.synchronize()
        assert ops.launch_counts()["block_ell_spmm"] == \
            len(operands) * sum(len(p) for p in parts)
