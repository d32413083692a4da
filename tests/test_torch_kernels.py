"""The port's kernel modules against the JAX package's oracles.

On the CPU every wrapper runs its kernel's plain version, so these hold
``repro_torch.kernels.{ref,ops}`` against ``repro.kernels.ref`` on the
sweeps of tests/test_kernels.py (ragged shapes, W=1, the empty graph, the
quantized gather).  Tolerances are the reference's own: 1e-5 for float
SpMM, 1e-4 for the quantized gather, bit-exact for the sampler.

The kernels themselves are held against their plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py.  Cases loop inside each
test, so the file stays smaller than the JAX package's test files and
``pytest -n 6 --dist loadfile`` schedules those as before (see
tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import torch
import jax.numpy as jnp

from repro.core.graph import ELL as JELL
from repro.core.quantization import dequantize as jdequantize
from repro.core.quantization import quantize as jquantize
from repro.core.sampling import sample_csr_to_ell as jsample
from repro.kernels import ref as jref
from repro_torch.core.graph import CSR, ELL
from repro_torch.core.quantization import quantize
from repro_torch.kernels import ops, ref

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)


def to_port(g) -> CSR:
    return CSR(*(torch.from_numpy(np.array(a)) for a in
                 (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _jell(g, W):
    val, col = jsample(g.row_ptr, g.col_ind, g.val, W)
    return JELL(val, col, g.num_cols)


def _pell(jell) -> ELL:
    return ELL(torch.from_numpy(np.array(jell.val)),
               torch.from_numpy(np.array(jell.col)), jell.num_cols)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


SHAPES = [(8, 128, 8), (37, 33, 16), (64, 256, 4), (130, 64, 32),
          (16, 128, 1)]


def test_ref_and_ops_ell_spmm_match_jax():
    for n, feat, W in SHAPES:
        rng = np.random.default_rng(1000 + n)
        g = random_csr(rng, n, 5.0, skew=1.0)
        b = rng.normal(size=(n, feat)).astype(np.float32)
        jell = _jell(g, W)
        want = jref.ell_spmm_rowloop(jell.val, jell.col, jnp.asarray(b))
        ell = _pell(jell)
        tb = torch.from_numpy(b)
        _close(ref.ell_spmm_rowloop(ell.val, ell.col, tb), want)
        _close(ref.ell_spmm(ell.val, ell.col, tb),
               jref.ell_spmm(jell.val, jell.col, jnp.asarray(b)))
        _close(ops.ell_spmm(ell, tb), want)


def test_ref_csr_spmm_matches_jax():
    for name, n, deg, skew in (("uniform", 50, 4.0, 0.0),
                               ("skewed", 90, 6.0, 0.7),
                               ("dense", 30, 20.0, 1.0),
                               ("empty", 8, 0.0, 0.0)):
        rng = np.random.default_rng(len(name))
        g = random_csr(rng, n, deg, skew=skew)
        b = rng.normal(size=(n, 19)).astype(np.float32)
        p = to_port(g)
        _close(ref.csr_spmm(p.row_ptr, p.col_ind, p.val,
                            torch.from_numpy(b)),
               jref.csr_spmm(g.row_ptr, g.col_ind, g.val, jnp.asarray(b)))


def test_ops_aes_sample_bit_identical():
    for W in (4, 16, 64):
        g = random_csr(np.random.default_rng(W), 40, 12.0, skew=0.8)
        want_val, want_col = jsample(g.row_ptr, g.col_ind, g.val, W)
        got = ops.aes_sample(to_port(g), W)
        np.testing.assert_array_equal(got.col.numpy(), np.asarray(want_col))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want_val))


def test_fused_aes_spmm_matches_jax_oracle():
    for n, feat, W in ((8, 128, 8), (37, 60, 16), (72, 32, 32), (50, 33, 1),
                       (60, 100, 128)):
        rng = np.random.default_rng(n * 7 + W)
        g = random_csr(rng, n, 9.0, skew=0.8)
        b = rng.normal(size=(n, feat)).astype(np.float32)
        want = jref.aes_spmm(g.row_ptr, g.col_ind, g.val, jnp.asarray(b),
                             sh_width=W)
        p = to_port(g)
        tb = torch.from_numpy(b)
        _close(ops.fused_aes_spmm(p, tb, W), want)
        _close(ref.aes_spmm(p.row_ptr, p.col_ind, p.val, tb, W), want)


def test_ref_dequantize_matches_jax():
    for shape in ((8, 128), (256, 128), (100, 33), (1, 1)):
        for bits in (8, 16):
            x = np.random.default_rng(3).normal(size=shape).astype(
                np.float32) * 5
            jqf = jquantize(x, bits)
            qf = quantize(torch.from_numpy(x), bits)
            np.testing.assert_array_equal(qf.q.numpy(), np.asarray(jqf.q))
            _close(ref.dequantize(qf.q, qf.x_min, qf.x_max, bits),
                   jref.dequantize(jqf.q, jqf.x_min, jqf.x_max, bits),
                   tol=1e-6)


def test_quantized_gather_matches_jax():
    for W in (1, 16, 64):
        for bits in (8, 16):
            rng = np.random.default_rng(W + bits)
            g = random_csr(rng, 48, 6.0)
            x = rng.normal(size=(48, 96)).astype(np.float32)
            jqf = jquantize(x, bits)
            jell = _jell(g, W)
            want = jref.ell_spmm_rowloop(jell.val, jell.col,
                                         jdequantize(jqf))
            qf = quantize(torch.from_numpy(x), bits)
            got = ops.ell_spmm(_pell(jell), qf.q,
                               quantized_meta=(qf.scale, qf.x_min))
            _close(got, want, tol=1e-4)
            # the aes_spmm oracle's dequant-then-SpMM form agrees too
            p = to_port(g)
            _close(ref.aes_spmm(p.row_ptr, p.col_ind, p.val, qf.q, W,
                                bits=bits, x_min=qf.x_min, x_max=qf.x_max),
                   jref.aes_spmm(g.row_ptr, g.col_ind, g.val, jqf.q,
                                 sh_width=W, bits=bits, x_min=jqf.x_min,
                                 x_max=jqf.x_max),
                   tol=1e-4)


def test_random_shapes_match_jax():
    """The property sweep of tests/test_kernels.py at fixed seeds:
    n in [1, 48], feat in [1, 80], W = 2^[0, 6]."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n, feat, W = int(rng.integers(1, 49)), int(rng.integers(1, 81)), \
            2 ** int(rng.integers(0, 7))
        g = random_csr(rng, n, 6.0, skew=0.9)
        b = rng.normal(size=(n, feat)).astype(np.float32)
        jell = _jell(g, W)
        want = jref.ell_spmm_rowloop(jell.val, jell.col, jnp.asarray(b))
        tb = torch.from_numpy(b)
        _close(ops.ell_spmm(_pell(jell), tb), want, tol=1e-4)
        _close(ops.fused_aes_spmm(to_port(g), tb, W), want, tol=1e-4)
