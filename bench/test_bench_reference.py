"""The plain reference's frozen copies held against the port at small
sizes (a test may import the port; the reference itself may not): the
Table 1 bands, the Eq. 3 hash and the slot layout, Eq. 1 and Eq. 2, the
hidden layer's range guard, TF32 rounding, and whole logits."""
from __future__ import annotations

import pytest
import torch

from bench import reference, run
from bench.conftest import small
from bench.reference import aes, quant
from repro_torch.core import quantization as port_quant
from repro_torch.core import sampling as port_sampling

CPU = torch.device("cpu")
#: Row lengths around every band edge of W = 128 (54 * 128 = 6912).
LENGTHS = (0, 1, 5, 127, 128, 129, 200, 256, 257, 1000, 4608, 4609, 6912,
           6913, 9000)


def _csr(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    row_ptr = torch.zeros(len(lengths) + 1, dtype=torch.int32)
    row_ptr[1:] = torch.cumsum(torch.tensor(lengths), 0)
    nnz = int(row_ptr[-1])
    col = torch.randint(1, 50000, (nnz,), generator=g, dtype=torch.int32)
    val = torch.rand(nnz, generator=g) + 0.5
    return row_ptr, col, val


@pytest.mark.parametrize("width", [1, 3, 16, 127, 128, 256])
def test_frozen_sampling_equals_the_port(width):
    row_ptr, col, val = _csr(LENGTHS)
    nnz = (row_ptr[1:] - row_ptr[:-1]).long()
    n_per, cnt = aes.strategy(nnz, width)
    strat = port_sampling.get_sample_strategy(nnz.int(), width)
    assert torch.equal(n_per, strat.N.long())
    assert torch.equal(cnt, strat.sample_cnt.long())
    v, c, live = aes.sample_rows(row_ptr, col, val, nnz, n_per, cnt, 0,
                                 len(LENGTHS), width)
    pv, pc = port_sampling.sample_csr_to_ell(row_ptr, col, val, width)
    assert torch.equal(v, pv) and torch.equal(c, pc.long())
    _, valid = port_sampling.slot_offsets(width, strat, nnz.int())
    assert torch.equal(live, valid)
    assert torch.equal(aes.live_slots(nnz, width), live.sum(1))


def test_every_band_is_reached_at_w128():
    nnz = torch.tensor(LENGTHS)
    n_per, cnt = aes.strategy(nnz, 128)
    assert sorted(set(cnt.tolist())) == [1, 4, 8, 16, 32]
    assert n_per[-1] == 4 and cnt[-1] == 32   # R > 54: N = W / 32


def test_eq1_eq2_equal_the_port_bit_for_bit():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(500, 37, generator=g) * 3
    qf = port_quant.quantize(x, 8)
    lo, hi = x.min(), x.max()
    q = quant.encode(x, lo, hi, 8)
    assert torch.equal(q.to(torch.uint8), qf.q)
    xr, stored = quant.quantize_features(x, 8, torch.float32)
    assert torch.equal(xr, port_quant.dequantize(qf))
    assert stored == (lo, hi)


@pytest.mark.parametrize("case", ["in_range", "drifted", "outside"])
def test_range_guard_follows_the_port(case):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(400, 16, generator=g) * 2
    qf = port_quant.quantize(x, 8)
    h = {"in_range": x * 0.9,
         "drifted": torch.relu(x),        # min 0 against a negative x_min
         "outside": x * 1.5}[case]
    got = quant.through_range(h, (qf.x_min, qf.x_max), 8)
    want = port_quant.requantize_within_range(qf, h)
    if want is None:
        assert got is h
    else:
        assert torch.equal(got, port_quant.dequantize(want))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(10000, generator=g) * 100
    t = reference.tf32(x)
    assert torch.all(t.view(torch.int32) & 0x1FFF == 0)
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0**-11
    assert torch.equal(reference.tf32(t), t)


@pytest.mark.parametrize("name", ["gcn-reddit", "graphsage-ogbn-products"])
def test_reference_logits_match_the_port_on_the_cpu(name):
    """The port's eager path and the float64 reference agree to float32
    rounding; the TF32 control does not."""
    from repro_torch.gnn.infer import infer_logits

    mix = run.load_json(run.BENCH / "traffic" / "aes-f32.json")
    p = run.prepare(small(name), mix, 9, CPU)
    out = infer_logits(p.ds, p.cfg["model"], p.module, sh_width=128,
                       strategy="aes", backend="torch", device=CPU)
    ref = run.reference_logits(p, 0)
    assert ref.dtype == torch.float64
    assert run.rel_err(out, ref) < 1e-5
    assert run.rel_err(run.reference_logits(p, 0, precision="tf32"),
                       ref) > 1e-5


def test_rel_err_of_a_wrong_shape_or_nan_is_inf():
    ref = torch.ones(4, 3, dtype=torch.float64)
    assert run.rel_err(torch.ones(3, 3), ref) == float("inf")
    bad = torch.ones(4, 3)
    bad[1, 1] = float("nan")
    assert run.rel_err(bad, ref) == float("inf")
    assert run.rel_err(torch.ones(4, 3), ref) == 0.0
