"""Parity of the port's feature quantization (Eq. 1/2, the range guard)
with the JAX package's: ``q`` must be bit-identical for 8 and 16 bits.

Cases loop inside each test: every ``test_torch_*`` file stays smaller
than the JAX package's test files, so ``pytest -n 6 --dist loadfile``
schedules those as it did before the port (see tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import graph as tg
from repro_torch.core import quantization as tq

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)


def _features(seed, shape=(200, 33), scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def test_quantize_bit_identical():
    for bits in (8, 16):
        for seed in range(4):
            case = f"bits={bits} seed={seed}"
            x = _features(seed, shape=(150 + 40 * seed, 17 + 31 * seed))
            want = jq.quantize(x, bits)
            got = tq.quantize(torch.from_numpy(x), bits)
            assert got.q.dtype == {8: torch.uint8, 16: torch.uint16}[bits]
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q),
                                          err_msg=case)
            assert float(got.x_min) == float(want.x_min), case
            assert float(got.x_max) == float(want.x_max), case
            assert float(got.scale) == float(want.scale), case
            # XLA contracts Eq. 2 into one FMA; eager torch rounds the
            # product and the sum apart: each is within 1 ulp of exact
            ulp = float(np.spacing(np.abs(x).max()))
            np.testing.assert_allclose(tq.dequantize(got).numpy(),
                                       np.asarray(jq.dequantize(want)),
                                       rtol=0, atol=4 * ulp, err_msg=case)


def test_quantize_constant_matrix_matches():
    x = np.full((5, 7), 2.5, np.float32)
    want = jq.quantize(x, 8)
    got = tq.quantize(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


def test_requantize_within_range_matches():
    x = _features(7)
    want_qf = jq.quantize(x, 8)
    got_qf = tq.quantize(torch.from_numpy(x), 8)
    assert tq.DRIFT_THRESHOLD == jq.DRIFT_THRESHOLD
    overhang = x.copy()
    overhang[0, 0] = x.max() + float(want_qf.scale) * 0.4
    cases = {"roundtrip": np.asarray(jq.dequantize(want_qf)),
             "in_range": x * 0.9, "shrunk": x * 0.2, "overhang": x * 1.5,
             "half_step": overhang}
    for case, y in cases.items():
        want = jq.requantize_within_range(want_qf, y)
        ty = torch.tensor(y)
        got = tq.requantize_within_range(got_qf, ty)
        assert tq.range_drift(got_qf, ty) == pytest.approx(
            jq.range_drift(want_qf, y), rel=1e-6), case
        if want is None:
            assert got is None, case
            continue
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q),
                                      err_msg=case)
        assert float(got.x_min) == float(want.x_min), case
        assert float(got.x_max) == float(want.x_max), case
    # the round trip of the stored matrix re-encodes to itself
    again = tq.requantize_within_range(got_qf, tq.dequantize(got_qf))
    assert torch.equal(again.q, got_qf.q)


def test_builders_default_to_the_card():
    if torch.cuda.is_available():
        assert tg.csr_from_edges([0], [0], 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tg.csr_from_edges([0], [0], 1)
