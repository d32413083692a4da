"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package (the machine with the card has no
JAX), so on that machine run it without the suite's conftest::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: the sampler and the dequantization are bit-exact; float SpMM
agrees to 1e-5 (the fused kernel contracts a*b+c into FMA, the plain
version rounds twice; the ELL and blocked SpMMs round twice as it does,
and the blocked one is held bit-identical in f32); the quantized gathers
to 1e-4, as in the reference package's tests; the fused layer to 1e-4,
the tolerance of tests/test_conformance.py:_path_fused_layer (its transform runs on the
tensor cores in 3xTF32, float32-level error summed in another order than
cuBLAS).  Cases loop inside
tests, so the file stays smaller than the JAX package's test files (see
tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.graph import CSR, csr_from_edges, ell_live_widths
from repro_torch.core.graph import partition_width_buckets
from repro_torch.core.quantization import quantize
from repro_torch.core.sampling import sample_csr_to_block_ell
from repro_torch.gnn import make_dataset, make_presampled_agg, train_model
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


def zero_tail_csr(device) -> CSR:
    """40 rows the live widths must get right, built as CSR arrays (rows
    need not be sorted): every 4th row empty; rows whose sampled prefix
    ends in an edge to column 0 of value 0.0 or -0.0 (the sentinel's
    value, so the decode ends the live prefix before it): row 5 (1.5 then
    0.0: live 1 at W >= 2), row 6 (2.0, 1.0, then -0.0: live 2 at W >= 3),
    row 7 (only such edges: live 0); and two 600-edge hubs, rows 9 and
    11, whose even and odd edges are such edges: row 9's one sampled slot
    at W = 1 is one (live 0), as are its samples 0 and 2 at W = 3 (3
    samples, not a power of two; live 2), as is row 11's last sampled slot
    at W = 16, 127, 128 and 256."""
    rng = np.random.default_rng(41)
    cols, vals = [], []
    for r in range(40):
        d = int(rng.integers(1, 10)) if r % 4 else 0
        cols.append(rng.integers(1, 40, d))
        vals.append(rng.normal(size=d))
    cols[5], vals[5] = np.array([4, 0]), np.array([1.5, 0.0])
    cols[6], vals[6] = np.array([7, 3, 0]), np.array([2.0, 1.0, -0.0])
    cols[7], vals[7] = np.zeros(3, np.int64), np.array([0.0, -0.0, 0.0])
    for r, first in ((9, 0), (11, 1)):
        cols[r], vals[r] = rng.integers(1, 40, 600), rng.normal(size=600)
        cols[r][first::2], vals[r][first::2], vals[r][first::4] = 0, 0.0, -0.0
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    return CSR(torch.from_numpy(row_ptr.astype(np.int32)).to(device),
               torch.from_numpy(np.concatenate(cols).astype(np.int32)
                                ).to(device),
               torch.from_numpy(np.concatenate(vals).astype(np.float32)
                                ).to(device), 40)


def _operands(x: torch.Tensor):
    """(B, quantized_meta, tolerance): f32 x, and x quantized to uint8 and
    uint16."""
    out = [(x, None, 1e-5)]
    for bits in (8, 16):
        qf = quantize(x, bits)
        out.append((qf.q, (qf.scale, qf.x_min), 1e-4))
    return out


def _panel_counts() -> tuple:
    """``kernels.ell_spmm.panel_launches`` and ``kernels.ell_spmm.panels``
    so far."""
    reg = obs.default_registry()
    return (reg.counter_value("kernels.ell_spmm.panel_launches"),
            reg.counter_value("kernels.ell_spmm.panels"))


def _check_all(g: CSR, x: torch.Tensor, W: int):
    ops.reset_launch_counts()
    panels = _panel_counts()
    ell = ops.aes_sample(g, W)
    val, col = aes_mod.aes_sample_plain(g.row_ptr, g.col_ind, g.val, W)
    assert torch.equal(ell.val, val) and torch.equal(ell.col, col)
    live = ell_live_widths(ell.val, ell.col)
    assert torch.equal(ell.live_w, live)
    torch.testing.assert_close(
        ops.fused_aes_spmm(g, x, W),
        fused_mod.fused_aes_spmm_plain(g.row_ptr, g.col_ind, g.val, x, W),
        rtol=1e-5, atol=1e-5)
    for b, meta, tol in _operands(x):
        torch.testing.assert_close(
            ops.ell_spmm(ell, b, live, quantized_meta=meta),
            ell_mod.ell_spmm_plain(ell.val, ell.col, live, b, meta),
            rtol=tol, atol=tol,
            msg=lambda m: f"F={x.shape[1]} W={W} {b.dtype}: {m}")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"aes_sample": 1, "ell_spmm": 3,
                                   "fused_aes_spmm": 1, "fused_layer": 0,
                                   "dequantize": 0, "block_ell_spmm": 0}
    assert _panel_counts() == panels  # operands far below L2: row order


def test_kernels_match_plain(cuda):
    """Ragged F (1, 3, 33, 60, 100, 130: the masked scalar path where
    F % 4 != 0), F = 64 and 128 (one vector load a lane, 16- and 32-lane
    rows) and F > 128 (several feature passes, 2048 among them); W from 1
    to 128, row counts that fill no whole block of warps, and power-law
    rows, many of them empty.  Then a B whose base is 4 (f32), 2 (u16) or 1 (u8) bytes
    past an aligned one: the vector loads give way to the scalar path."""
    for n, feat, W in ((8, 128, 8), (37, 33, 16), (64, 256, 4),
                       (130, 64, 32), (16, 128, 1), (300, 100, 128),
                       (70, 60, 16), (517, 128, 128), (260, 130, 1),
                       (50, 2048, 16), (90, 1, 16), (45, 3, 128)):
        g = _graph(n + W, n, 9.0, 0.7, cuda)
        x = torch.randn((n, feat), generator=torch.Generator().manual_seed(n)
                        ).to(cuda)
        _check_all(g, x, W)
    g = _graph(9, 300, 9.0, 0.7, cuda)
    ell = ops.aes_sample(g, 128)
    live = ell_live_widths(ell.val, ell.col)
    x = torch.randn((300, 128), generator=torch.Generator().manual_seed(9)
                    ).to(cuda)
    for src, meta, tol in _operands(x):
        b = torch.empty(src.numel() + 1, dtype=src.dtype,
                        device=cuda)[1:].view(src.shape).copy_(src)
        assert b.data_ptr() % (4 * b.element_size()) != 0
        torch.testing.assert_close(
            ops.ell_spmm(ell, b, live, quantized_meta=meta),
            ell_mod.ell_spmm_plain(ell.val, ell.col, live, b, meta),
            rtol=tol, atol=tol, msg=lambda m: f"unaligned {b.dtype}: {m}")


def test_aes_sample_writes_live_widths(cuda):
    """The sampler's (val, col) bit for bit its plain version's and its
    live widths ``ell_live_widths`` of them, at W in {1, 3, 16, 127, 128,
    256}: the one-slot lanes (W % 4 != 0) and the 16-byte ones, over one
    and two 128-slot passes; the zero-tail rows of ``zero_tail_csr``, a
    hub row far above W, and power-law rows, many of them empty."""
    graphs = (zero_tail_csr(cuda), _graph(12, 500, 4.0, 0.8, cuda, hub=20000),
              _graph(13, 300, 9.0, 0.7, cuda))
    ops.reset_launch_counts()
    for gi, g in enumerate(graphs):
        for W in (1, 3, 16, 127, 128, 256):
            ell = ops.aes_sample(g, W)
            val, col = aes_mod.aes_sample_plain(g.row_ptr, g.col_ind, g.val,
                                                W)
            assert torch.equal(ell.val.view(torch.int32),
                               val.view(torch.int32)), (gi, W)
            assert torch.equal(ell.col, col), (gi, W)
            assert torch.equal(ell.live_w, ell_live_widths(val, col)), (gi, W)
            if gi == 0 and W >= 3:
                assert ell.live_w[5:8].tolist() == [1, 2, 0], W
    torch.cuda.synchronize()
    assert ops.launch_counts()["aes_sample"] == 18


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


def test_ell_spmm_panels_match_plain_bit_for_bit(cuda):
    """The panel-major walk, each panel width forced, bit for bit the
    plain version: f32 at F = 602 (8-byte lanes, the ragged last panel),
    604 (16-byte lanes), 33 and 130; uint8 at 602 (the masked scalar path)
    and 608 (16-byte lanes); uint16 at 604 (8-byte lanes); panels of 2 to
    48 features (one to 32 lanes a row, several rows a warp); B 4 (f32),
    2 (u16) or 1 (u8) bytes past an aligned base; rows with no live
    slot."""
    g = _graph(21, 300, 9.0, 0.7, cuda)
    for W in (16, 128):
        ell = ops.aes_sample(g, W)
        live = ell.live_w
        assert (live == 0).any()
        for feat, kinds in ((602, ("f32", "u8")), (604, ("f32", "u16")),
                            (33, ("f32",)), (130, ("f32",)),
                            (608, ("u8",))):
            x = torch.randn((300, feat), generator=torch.Generator()
                            .manual_seed(feat)).to(cuda)
            for b, meta, _ in _operands(x):
                kind = {torch.float32: "f32", torch.uint8: "u8",
                        torch.uint16: "u16"}[b.dtype]
                if kind not in kinds:
                    continue
                want = ell_mod.ell_spmm_plain(ell.val, ell.col, live, b,
                                              meta)
                for src in (b, _shifted(b, 1)):
                    for p in (2, 8, 32, 48):
                        got = ell_mod._launch(ell.val, ell.col, live, src,
                                              meta, p)
                        assert torch.equal(got, want), (W, feat, kind, p,
                                                        src.data_ptr() % 16)


def test_ell_spmm_panels_engage_above_l2(cuda):
    """An operand larger than the card's L2 at Reddit's layer-1 shape,
    [232,965, 602] f32 (561 MB), over a sparse random graph (W = 16, many
    rows with no live slot): the rule picks a panel narrower than F, even,
    of 32 bytes or more, under the L2 share, with a ragged last panel;
    ``ops.ell_spmm`` is bit for bit the plain version, aligned and 4 bytes
    off alignment, and counts one panel launch and its panels each time.
    uint8 and uint16 B of the same features: bit for bit, panels counted
    where the rule gives them panels."""
    prev = obs.set_enabled(True)
    try:
        n, feat = 232_965, 602
        l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
        p = ell_mod._panel_features(n, feat, 4, l2)
        assert p < feat and p % 2 == 0 and p * 4 >= 32 and feat % p
        assert n * p * 4 <= ell_mod._PANEL_L2_SHARE * l2
        g = _graph(22, n, 4.0, 0.7, cuda)
        ell = ops.aes_sample(g, 16)
        live = ell.live_w
        empty = live == 0
        assert empty.any()
        x = torch.randn((n, feat), generator=torch.Generator(
            device=cuda).manual_seed(22), device=cuda)
        for b, meta, _ in _operands(x):
            want = ell_mod.ell_spmm_plain(ell.val, ell.col, live, b, meta)
            assert not want[empty].any()
            bp = ell_mod._panel_features(n, feat, b.element_size(), l2)
            for src in (b, _shifted(b, 1)):
                before = _panel_counts()
                got = ops.ell_spmm(ell, src, live, quantized_meta=meta)
                assert torch.equal(got, want), (b.dtype,
                                                src.data_ptr() % 16)
                engaged = bp < feat
                assert _panel_counts() == (
                    before[0] + engaged,
                    before[1] + engaged * -(-feat // bp)), b.dtype
            del want, got
    finally:
        obs.set_enabled(prev)


def test_wide_w_uses_opt_in_shared_memory(cuda):
    """W far above the fused kernel's 128-slot staging chunk: 8192 slots
    (64 KiB of sh_val/sh_col, which the paper's one-block-per-row kernel
    staged at once in opt-in shared memory) and the widest W the wrapper
    takes, 29056 (8 W = 232448 bytes), both over a 30000-edge hub row:
    the warp loops over 64 and 227 chunks."""
    g = _graph(4, 64, 2.0, 0.0, cuda, hub=30000)
    for W, feat in ((8192, 32), (8192, 128), (29056, 60)):
        x = torch.randn((64, feat), generator=torch.Generator().manual_seed(
            4)).to(cuda)
        _check_all(g, x, W)


def test_every_kernel_builds_for_sm90a(cuda):
    seconds = _build.build()
    assert set(seconds) == set(_build.KERNELS)
    for name in _build.KERNELS:
        assert _build.library_path(name).exists()


def test_fused_layer_matches_plain(cuda):
    """f32/u8/u16 B, both activations; F in {33, 60} (ragged: masked or
    partly used lanes), 64 and 128 (vector loads), 2048 (16 gather chunks
    into one accumulator) and H in {1, 5, 41} (zero-padded n-tiles), 64 and
    2048 (32 passes of 64 columns over W streamed through shared memory);
    row counts that fill no whole 16-row warp tile or 256-row group; W in
    {1, 4, 8, 16, 128, 2048}, a hub row far above W, and graphs with empty
    rows (power-law degrees, and 20 of 40 rows with no edge)."""
    rows = np.repeat(np.arange(20), 3)
    empty_rows = csr_from_edges(np.arange(60) % 40, rows, 40,
                                np.random.default_rng(5).normal(
                                    size=60).astype(np.float32), device=cuda)
    for n, feat, hidden, W, hub in (
            (37, 33, 41, 16, 0), (70, 60, 5, 128, 0), (130, 64, 1, 4, 0),
            (24, 2048, 2048, 8, 0), (517, 128, 64, 1, 0),
            (300, 128, 41, 128, 3000), (90, 2048, 1, 16, 0),
            (200, 128, 5, 2048, 20000), (40, 60, 41, 16, -1),
            (300, 33, 1, 128, 3000)):
        g = empty_rows if hub < 0 else _graph(n + W, n, 9.0, 0.7, cuda,
                                              hub=hub)
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
    # B whose base is 4 (f32) or 1 (u8) bytes past an aligned one, at
    # F = 128: the vector loads give way to the masked scalar path
    g = _graph(7, 300, 9.0, 0.7, cuda)
    ell = ops.aes_sample(g, 128)
    live = ell_live_widths(ell.val, ell.col)
    x = torch.randn((300, 128), generator=torch.Generator().manual_seed(7)
                    ).to(cuda)
    w, bias = x[:128, :41].contiguous() / 10, x[0, :41].contiguous()
    for bits in (None, 8):
        qf = quantize(x, 8)
        src, meta = (x, None) if bits is None else (qf.q,
                                                    (qf.scale, qf.x_min))
        b = torch.empty(src.numel() + 1, dtype=src.dtype,
                        device=cuda)[1:].view(src.shape).copy_(src)
        assert b.data_ptr() % 16 != 0 and b.is_contiguous()
        torch.testing.assert_close(
            ops.fused_layer_spmm(ell, b, w, bias, live,
                                 quantized_meta=meta),
            layer_mod.fused_layer_plain(ell.val, ell.col, live, b, w, bias,
                                        quantized_meta=meta),
            rtol=1e-4, atol=1e-4)


def test_dequantize_bit_exact(cuda):
    """tests/test_kernels.py's shapes, plus a misaligned view (the scalar
    path) and a length that leaves a vector tail; then per-segment
    constants: S in {1, 3, 4} segments whose lengths are not multiples of
    16 elements (each segment's own head and tail), an unaligned view, an
    empty matrix, into a slice of a larger output, u8 and u16."""
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
    rng = np.random.default_rng(5)
    for rows, feat, segs in ((12, 128, 1), (12, 128, 3), (12, 128, 4),
                             (36, 7, 3), (4004, 33, 4), (3003, 128, 3),
                             (0, 16, 4)):
        for bits, dtype in ((8, torch.uint8), (16, torch.uint16)):
            q = torch.empty((0, feat), dtype=dtype, device=cuda)
            if rows:
                q = quantize(torch.from_numpy(rng.normal(size=(
                    rows, feat)).astype(np.float32)).to(cuda), bits).q
            scale = torch.from_numpy(rng.uniform(0.01, 1.0, segs).astype(
                np.float32)).to(cuda)
            x_min = torch.from_numpy(rng.normal(size=segs).astype(
                np.float32)).to(cuda)
            want = dequant_mod.dequantize_plain(q, scale, x_min)
            # q and views of it 1 element (no element aligns q and out
            # together: the scalar path) and 4 elements (a longer head)
            # off its vector grid; the 1-element view also into an out=
            # slice 1 element off, so q and out align together again
            big = torch.full((rows * feat + 3,), float("nan"), device=cuda)
            for src, out in ((q, None), (_shifted(q, 1), None),
                             (_shifted(q, 4), None),
                             (_shifted(q, 1), big[1:-2].view(q.shape))):
                got = ops.dequantize(src, scale, x_min, bits=bits, out=out)
                assert torch.equal(got, want), (rows, feat, segs, bits)
                calls += q.numel() > 0
            assert big[0].isnan() and big[-2:].isnan().all()
            # bit-equal to one call a segment
            n = rows // segs
            assert torch.equal(want, torch.cat([
                ops.dequantize(q[s * n:(s + 1) * n], scale[s], x_min[s],
                               bits=bits) for s in range(segs)]))
            calls += segs * (n * feat > 0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["dequantize"] == calls == 102


def _shifted(q, k):
    """A contiguous copy of ``q`` that starts ``k`` elements into its
    allocation."""
    return torch.empty(q.numel() + k, dtype=q.dtype, device=q.device)[
        k:].view(q.shape).copy_(q)


def test_block_ell_spmm_matches_plain(cuda):
    """f32/u8/u16 B over mixed strategies at block_rows in {1, 16, 256},
    one to three width buckets and a partial partition (its other rows
    zero), on graphs with a ragged last block and with a "full" block
    wider than 1024 slots; F in {1, 3, 33, 64, 100, 128, 130, 2048}.  f32
    is bit-identical to the plain version (the kernel rounds twice, as it
    does); quantized B to 1e-4."""
    strategies = (("aes", 8), ("full", 0), ("sfs", 4), ("afs", 32))
    for n, feat, block_rows, hub in ((37, 33, 1, 0), (300, 100, 16, 3000),
                                     (700, 128, 256, 0), (130, 64, 16, 0),
                                     (90, 1, 16, 0), (58, 3, 1, 1500),
                                     (300, 130, 16, 1500),
                                     (50, 2048, 16, 0)):
        g = _graph(n + block_rows, n, 9.0, 0.7, cuda, hub=hub)
        nb = -(-n // block_rows)
        configs = [strategies[b % len(strategies)] for b in range(nb)]
        bell = sample_csr_to_block_ell(g, configs, block_rows)
        assert not hub or max(bell.widths) > 1024
        x = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, feat)).astype(np.float32)).to(cuda)
        operands = [(b, meta, 0.0 if meta is None else tol)
                    for b, meta, tol in _operands(x)]
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
                    msg=lambda m: f"n={n} F={feat} rows={block_rows} "
                                  f"{b.dtype} {buckets}: {m}")
        torch.cuda.synchronize()
        assert ops.launch_counts()["block_ell_spmm"] == \
            len(operands) * sum(len(p) for p in parts)



def test_training_and_presampled_agg_on_the_card(cuda):
    """Five epochs of ``train_model`` on the card against the same on the
    CPU, both models: every parameter within 1e-4 (the exact aggregation
    and its backward sum in atomic order on the card).  Then the trained
    GCN through ``make_presampled_agg``: ``"cuda"`` (one ``aes_sample``
    launch, then one ``ell_spmm`` a call) against ``"torch"``, logits to
    1e-5."""
    ds = make_dataset("reddit", scale=0.001, seed=3, max_avg_degree=16.0,
                      device="cpu")
    trained = {}
    for model in ("gcn", "graphsage"):
        got, _ = train_model(ds, model, hidden=16, epochs=5, device=cuda)
        want, _ = train_model(ds, model, hidden=16, epochs=5, device="cpu")
        for (k, p), q in zip(got.named_parameters(), want.parameters()):
            assert p.is_cuda and not p.requires_grad
            torch.testing.assert_close(p.cpu(), q, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{model} {k}: {m}")
        trained[model] = got
    gcn = trained["gcn"]
    adj, x = ds.gcn_adj.to(cuda), ds.features.to(cuda)
    for W in (16, 128):
        ops.reset_launch_counts()
        cagg = make_presampled_agg(adj, W, "aes", "cuda", device=cuda)
        tagg = make_presampled_agg(adj, W, "aes", "torch", device=cuda)
        with torch.inference_mode():
            torch.testing.assert_close(gcn(adj, x, cagg), gcn(adj, x, tagg),
                                       rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"W={W}: {m}")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert (counts["aes_sample"], counts["ell_spmm"]) == (1, 2), counts


def test_incremental_patch_on_the_card_equals_the_cpu(cuda):
    """``apply_csr_deltas`` and ``apply_edge_updates`` on ``cuda`` tensors
    against the same calls on CPU tensors, bit for bit (the merged CSR,
    its touched rows, the patched plan's fingerprint, tables and operand
    bytes, natural and degree-sorted, f32 and int8); the patched plan's
    ``cuda`` output against its ``torch`` twin (f32 0.0 apart: the blocked
    kernel rounds as its plain version does; int8 to 1e-4)."""
    import dataclasses

    from repro_torch.core import apply_csr_deltas
    from repro_torch.tuning import (MachineModel, PlanCache,
                                    apply_edge_updates, tune_blocked)

    rng = np.random.default_rng(21)
    g = _graph(5, 3000, 12.0, 0.8, "cpu", hub=1500)
    x = torch.from_numpy(rng.normal(size=(3000, 16)).astype(np.float32))
    rows = np.repeat(np.arange(3000), np.diff(g.row_ptr.numpy()))
    pick = rng.choice(g.nnz, 60, replace=False)
    keys = np.unique(rows[pick] * 3000 + g.col_ind.numpy()[pick])
    dels = [(int(k // 3000), int(k % 3000)) for k in keys]
    present = set((rows * 3000 + g.col_ind.numpy()).tolist())
    adds = []
    while len(adds) < 60:
        k = int(rng.integers(0, 3000)) * 3000 + int(rng.integers(0, 3000))
        if k not in present:
            present.add(k)
            adds.append((k // 3000, k % 3000, float(rng.normal())))
    want, wt = apply_csr_deltas(g, adds, dels)
    got, gt = apply_csr_deltas(g.to(cuda), adds, dels)
    assert got.device.type == "cuda" and gt.tolist() == wt.tolist()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    tk = dict(block_rows=256, measure_plan=False, measure_buckets=False,
              machine=MachineModel())
    requant = [r for r in range(40, 3000, 97)
               if r not in (int(x.max(1).values.argmax()),
                            int(x.min(1).values.argmin()))]
    x2 = x.clone()
    x2[requant] *= 0.5
    for kw in ({}, {"quant": 8}, {"layout": "degree_sorted"}):
        plans = []
        for dev in ("cpu", cuda):
            gd, xd = g.to(dev), x.to(dev)
            plan = tune_blocked(gd, xd, cache=PlanCache(), backend="torch",
                                **tk, **kw)
            plans.append(apply_edge_updates(
                plan, gd, adds, dels, features=x2.to(dev),
                requant_rows=requant if "quant" in kw else (),
                machine=tk["machine"])[0])
        h, c = plans
        assert (c.fingerprint, c.block_digests, c.bell.widths,
                c.bell.strategies, c.buckets, c.version) == \
            (h.fingerprint, h.block_digests, h.bell.widths,
             h.bell.strategies, h.buckets, h.version), kw
        for field in ("val", "col", "live_w"):
            assert torch.equal(getattr(c.bell, field).cpu(),
                               getattr(h.bell, field)), (kw, field)
        if "quant" in kw:
            assert torch.equal(c.quantized.q.cpu(), h.quantized.q)
        ops.reset_launch_counts()
        out = dataclasses.replace(c, backend="cuda").run(x2.to(cuda))
        torch.cuda.synchronize()
        assert ops.launch_counts()["block_ell_spmm"] >= 1
        twin = c.run(x2.to(cuda))
        tol = 1e-4 if "quant" in kw else 0.0     # the u8 gather's tolerance
        torch.testing.assert_close(out, twin, rtol=tol, atol=tol,
                                   msg=lambda m: f"{kw}: {m}")


def test_sharded_serving_on_the_card_equals_the_cpu(cuda):
    """A 4-shard ``GNNServer`` on ``cuda`` (f32 and u8 plans) against the
    same server on the CPU: the same plans, ``aggregate`` on the resident
    and on a dense operand to 1e-5 (u8 to 1e-4) through ``block_ell_spmm``;
    then a ``ServingRuntime`` burst on the card whose results equal the
    synchronous ``flush()``'s bit for bit."""
    from repro_torch.serving import GNNServer, ServingRuntime
    from repro_torch.tuning import MachineModel, PlanCache

    rng = np.random.default_rng(23)
    g = _graph(7, 4000, 10.0, 0.8, "cpu", hub=1200)
    x = torch.from_numpy(rng.normal(size=(4000, 32)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(4000, 8)).astype(np.float32))
    tk = dict(block_rows=256, measure_plan=False, measure_buckets=False,
              machine=MachineModel())
    for quant in (None, 8):
        servers = [GNNServer(g, x, num_shards=4, quant=quant,
                             cache=PlanCache(), tune_kwargs=tk,
                             devices=[dev]) for dev in ("cpu", cuda)]
        host, card = servers
        assert card.plan_summary() == host.plan_summary()
        assert all(p.backend == "cuda" for p in card.plans)
        tol = 1e-4 if quant else 1e-5
        for op in (None, h):
            ops.reset_launch_counts()
            got = card.aggregate(None if op is None else op.to(cuda))
            torch.cuda.synchronize()
            assert ops.launch_counts()["block_ell_spmm"] >= 4
            want = host.aggregate(op)
            torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol,
                                       msg=lambda m: f"quant={quant}: {m}")
    t0, t1 = card.submit(), card.submit(h.to(cuda))
    sync = card.flush()
    with ServingRuntime(card, max_batch=4, max_delay_ms=5.0) as rt:
        reqs = [rt.submit(None if i % 2 == 0 else h.to(cuda))
                for i in range(10)]
        for i, r in enumerate(reqs):
            assert torch.equal(r.result(60), sync[t0 if i % 2 == 0 else t1])
        assert rt.snapshot()["counters"]["completed"] == 10


def test_spmd_serving_on_the_card_equals_the_cpu(cuda):
    """A 4-shard ``GNNServer(mode="spmd")`` on ``cuda`` (f32 and u8 plans)
    against the same server on the CPU (1e-5, u8 1e-4), and bit for bit
    against loop mode on the card over the same plans; a pass launches
    ``block_ell_spmm`` once a global bucket (at most 3) and, on u8 plans,
    ``dequantize`` once, over the whole stack."""
    from repro_torch.serving import GNNServer
    from repro_torch.tuning import MachineModel, PlanCache

    rng = np.random.default_rng(29)
    g = _graph(8, 4000, 10.0, 0.8, "cpu", hub=1200)
    x = torch.from_numpy(rng.normal(size=(4000, 32)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(4000, 8)).astype(np.float32))
    tk = dict(block_rows=256, measure_plan=False, measure_buckets=False,
              machine=MachineModel())
    for quant in (None, 8):
        kw = dict(num_shards=4, quant=quant, tune_kwargs=tk)
        host = GNNServer(g, x, mode="spmd", cache=PlanCache(),
                         devices=["cpu"], **kw)
        cache = PlanCache()
        card = GNNServer(g, x, mode="spmd", cache=cache, devices=[cuda],
                         **kw)
        loop = GNNServer(g, x, cache=cache, devices=[cuda], **kw)
        assert card.plan_summary() == host.plan_summary()
        tol = 1e-4 if quant else 1e-5
        for op in (None, h):
            ops.reset_launch_counts()
            got = card.aggregate(None if op is None else op.to(cuda))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert 1 <= counts["block_ell_spmm"] <= 3
            assert counts["dequantize"] == (1 if quant and op is None
                                            else 0)
            torch.testing.assert_close(got.cpu(), host.aggregate(op),
                                       rtol=tol, atol=tol,
                                       msg=lambda m: f"quant={quant}: {m}")
            assert torch.equal(
                got, loop.aggregate(None if op is None else op.to(cuda)))


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards: one spmd slot a card")
def test_spmd_slots_across_two_cards_equal_one_card(cuda):
    """A 4-shard ``GNNServer(mode="spmd")`` over ``cuda:0`` and ``cuda:1``
    (two shards a card, f32 and u8 plans) bit for bit against the one-card
    stack on the same plans, its output on ``cuda:0``; a ``ServingRuntime``
    burst, whose batcher streams span both cards, equal to ``flush()``."""
    from repro_torch.serving import GNNServer, ServingRuntime
    from repro_torch.tuning import MachineModel, PlanCache

    rng = np.random.default_rng(31)
    g = _graph(9, 4000, 10.0, 0.8, "cpu", hub=1200)
    x = torch.from_numpy(rng.normal(size=(4000, 32)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(4000, 8))
                         .astype(np.float32)).to("cuda:0")
    tk = dict(block_rows=256, measure_plan=False, measure_buckets=False,
              machine=MachineModel())
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for quant in (None, 8):
        kw = dict(num_shards=4, mode="spmd", quant=quant, cache=PlanCache(),
                  tune_kwargs=tk)
        one = GNNServer(g, x, devices=cards[:1], **kw)
        two = GNNServer(g, x, devices=cards, **kw)
        assert two._devices == [cards[0]] * 2 + [cards[1]] * 2
        for op in (None, h):
            got = two.aggregate(op)
            assert got.device == cards[0]
            assert torch.equal(got, one.aggregate(op)), quant
    t0, t1 = two.submit(), two.submit(h)
    sync = two.flush()
    with ServingRuntime(two, max_batch=4, max_delay_ms=5.0) as rt:
        reqs = [rt.submit(None if i % 2 == 0 else h) for i in range(10)]
        for i, r in enumerate(reqs):
            assert torch.equal(r.result(60), sync[t0 if i % 2 == 0 else t1])


def test_lm_serve_on_the_card_equals_the_cpu(cuda):
    """Smoke configs in float32 on one set of weights, on ``cuda`` and on
    the CPU: dense (full attention, and AES-KV at W = 8 over the int8
    cache), Mixtral (SWA ring, MoE) and DeepSeek-V2 (MLA) served to equal
    greedy tokens; each decode step's logits, from the CPU's cache, to
    2e-3 (bfloat16 softmax weights and attention output, the reference's
    decode tolerance)."""
    import copy

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import prefill, serve
    from repro_torch.models import decode_step, init_params

    for arch, opts in (("qwen2-7b", {}),
                       ("qwen2-7b", {"aes_kv_width": 8, "kv_quant_bits": 8}),
                       ("mixtral-8x22b", {}), ("deepseek-v2-236b", {})):
        cfg = smoke_config(get_config(arch)).with_options(
            param_dtype="float32", **opts)
        host = init_params(cfg, 0, device="cpu")
        card = copy.deepcopy(host).to(cuda)
        p = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 8)
                                              ).astype(np.int32)
        want, _ = serve(cfg, host, p, 8, device="cpu")
        got, _ = serve(cfg, card, p, 8, device=cuda)
        np.testing.assert_array_equal(got, want, err_msg=f"{arch} {opts}")
        _, cache = prefill(cfg, host, torch.from_numpy(p), 16)
        for i in range(4):
            tok = torch.from_numpy(want[:, i:i + 1].copy())
            on_card = {k: v.to(cuda) for k, v in cache.items()}
            g, _ = decode_step(card, cfg, on_card, tokens=tok.to(cuda),
                               cache_len=8 + i)
            w, cache = decode_step(host, cfg, cache, tokens=tok,
                                   cache_len=8 + i)
            torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-3)


def test_lm_pattern_serve_on_the_card_equals_the_cpu(cuda):
    """The pattern families' smoke configs in float32 on one set of
    weights: xLSTM (also with an sLSTM block) and Zamba2 (also with a
    tail, and with AES-KV at W = 8 on its shared attention) served to
    equal greedy tokens on ``cuda`` and on the CPU; each decode step's
    logits, from the CPU's cache, to 2e-3 (the bfloat16 conv and K/V
    caches, the reference's decode tolerance)."""
    import copy

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import prefill, serve
    from repro_torch.models import decode_step, init_params

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device, copy=True)

    for arch, opts in (
            ("xlstm-350m", {}),
            ("xlstm-350m", {"block_pattern": ("mlstm", "mlstm", "mlstm",
                                              "slstm")}),
            ("zamba2-7b", {}), ("zamba2-7b", {"num_layers": 8}),
            ("zamba2-7b", {"aes_kv_width": 8})):
        cfg = smoke_config(get_config(arch)).with_options(
            param_dtype="float32", **opts)
        host = init_params(cfg, 0, device="cpu")
        card = copy.deepcopy(host).to(cuda)
        p = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 8)
                                              ).astype(np.int32)
        want, _ = serve(cfg, host, p, 8, device="cpu")
        got, _ = serve(cfg, card, p, 8, device=cuda)
        np.testing.assert_array_equal(got, want, err_msg=f"{arch} {opts}")
        _, cache = prefill(cfg, host, torch.from_numpy(p), 16)
        for i in range(4):
            tok = torch.from_numpy(want[:, i:i + 1].copy())
            g, _ = decode_step(card, cfg, to(cache, cuda),
                               tokens=tok.to(cuda), cache_len=8 + i)
            w, cache = decode_step(host, cfg, cache, tokens=tok,
                                   cache_len=8 + i)
            torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-3)


def test_lm_train_on_the_card_matches_the_cpu(cuda):
    """3 training steps (``launch.train.make_train_step``: AdamW, weight
    decay 0.1, remat on) of float32 smoke configs on ``cuda`` and on the
    CPU from one set of weights and batches: the first loss to 1e-5
    relative, the later ones to 1e-3 (AdamW's first steps move each
    weight by about lr times the sign of its gradient, so a gradient
    that rounds to the other sign moves a weight by 2 lr); parameters
    updated in their dtypes."""
    import copy

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, cosine_with_warmup

    for arch in ("tinyllama-1.1b", "mixtral-8x22b", "xlstm-350m",
                 "zamba2-7b"):
        cfg = smoke_config(get_config(arch)).with_options(
            param_dtype="float32")
        pipe = make_pipeline(cfg, seq_len=32, global_batch=4)
        sched = cosine_with_warmup(3e-4, 1, 3)
        losses = {}
        host = init_params(cfg, 0, device="cpu")
        for device in ("cpu", cuda):
            model = copy.deepcopy(host).to(device)
            params = {k: p.detach() for k, p in model.named_parameters()}
            state = (params, adamw_init(params))
            step = make_train_step(cfg, model, sched)
            losses[str(device)] = []
            for i in range(3):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in pipe.batch_at(i).items()}
                state, metrics = step(state, batch)
                losses[str(device)].append(float(metrics["loss"]))
            assert all(p.device.type == torch.device(device).type
                       for p in state[0].values())
        want, got = losses["cpu"], losses[str(cuda)]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=arch)
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=arch)


def test_one_rank_nccl_mesh_step_equals_the_plain_step(cuda):
    """2 training steps of smoke configs (dense, MoE, xLSTM, Zamba2) on a
    1x1 mesh of a one-rank nccl group, the state DTensors placed by the
    rules (``launch.train.sharded_step``), against the plain step from
    the same state and batches: losses and parameters ``torch.equal``
    (deterministic algorithms on: the embedding's gradient otherwise
    sums in atomic order)."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import (make_train_step, sharded_step,
                                          state_shardings)
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, constant

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(device=cuda)
        for arch in ("tinyllama-1.1b", "mixtral-8x22b", "xlstm-350m",
                     "zamba2-7b"):
            cfg = smoke_config(get_config(arch))
            model = init_params(cfg, 0, device=cuda)
            params = {k: p.detach() for k, p in model.named_parameters()}
            pipe = make_pipeline(cfg, seq_len=32, global_batch=4)
            batches = [{k: torch.as_tensor(v, device=cuda)
                        for k, v in pipe.batch_at(i).items()}
                       for i in range(2)]
            state = (params, adamw_init(params))
            specs = state_shardings(mesh, state)
            placed = place(state, specs, mesh)
            step = make_train_step(cfg, model, constant(1e-3))
            dstep = sharded_step(step, mesh, specs)
            for batch in batches:
                state, metrics = step(state, batch)
                placed, dmetrics = dstep(placed, batch)
                assert torch.equal(metrics["loss"], dmetrics["loss"]), arch
            for k, p in state[0].items():
                assert torch.equal(p, placed[0][k].full_tensor()), (arch, k)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
