"""The port's fused GCN layer and standalone Eq. 2 dequantization against
the JAX package's: the same numpy inputs go through both, and the plain
layer, ``ops.fused_layer_spmm`` (its CPU route), ``PlanExecutor.
run_fused_layer`` and ``evaluate(fuse_layers=True)`` must agree with the
reference to 1e-4 (accuracy: equal, or one test node apart); ``ops.
dequantize`` to 1e-6.  The reference runs its jnp oracles and its
``backend="jax"`` paths, since the installed jax cannot trace its Pallas
kernels.

Cases loop inside tests, so the file stays smaller than the JAX package's
test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import obs as jobs
from repro.core import graph as jg
from repro.core.aes_spmm import sample as jsample
from repro.core.quantization import quantize as jquantize
from repro.exec import default_executor as jdefault_executor
from repro.gnn import evaluate as jevaluate
from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.gnn.infer import _fused_gcn_logits as j_fused_gcn_logits
from repro.kernels import ref as jref
from repro_torch import obs
from repro_torch.core import graph as tg
from repro_torch.core.aes_spmm import sample
from repro_torch.core.quantization import QuantizedFeatures, quantize
from repro_torch.exec import PlanExecutor
from repro_torch.gnn import (evaluate, infer_logits, init_gcn, init_sage,
                             make_dataset, params_from_numpy)
from repro_torch.kernels import dequant as dequant_mod
from repro_torch.kernels import fused_layer as layer_mod
from repro_torch.kernels import ops, ref
from repro_torch.tuning import PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
FEAT, HIDDEN = 9, 5       # tests/test_conformance.py:_path_fused_layer's
DATA = dict(name="reddit", scale=0.001, seed=3, max_avg_degree=16.0)


def _graphs():
    """The four adversarial graphs of tests/test_conformance.py, rebuilt
    from their seeds, and a skewed random graph."""
    rng = np.random.default_rng(11)
    dst = np.repeat(np.arange(20), 3)
    empty_rows = jg.csr_from_edges(
        rng.integers(0, 40, dst.shape[0]), dst, 40,
        rng.normal(size=dst.shape[0]).astype(np.float32))
    rng = np.random.default_rng(13)
    dst = np.concatenate([np.full(160, 7), np.repeat(np.arange(50), 2)])
    dense_row = jg.csr_from_edges(
        rng.integers(0, 50, dst.shape[0]), dst, 50,
        rng.normal(size=dst.shape[0]).astype(np.float32))
    return {
        "empty": jg.csr_from_edges(np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), 24),
        "empty_rows": empty_rows,
        "dense_row": dense_row,
        "ragged70": random_csr(np.random.default_rng(17), 70, 6.0, skew=0.8),
        "random96": random_csr(np.random.default_rng(2), 96, 7.0, skew=0.7),
    }


def _cases():
    """(name, JAX csr, port csr, x, w, bias) with the conformance seeds."""
    for name, g in _graphs().items():
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        x = rng.normal(size=(g.num_rows, FEAT)).astype(np.float32)
        rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
        w = rng.normal(size=(FEAT, HIDDEN)).astype(np.float32)
        bias = rng.normal(size=(HIDDEN,)).astype(np.float32)
        p = tg.CSR(*(torch.from_numpy(np.array(a))
                     for a in (g.row_ptr, g.col_ind, g.val)), g.num_cols)
        yield name, g, p, x, w, bias


def _widths(g):
    return 4, max(int(np.asarray(g.row_nnz()).max(initial=0)), 1) + 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, label, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=label)


def _jqf_to_port(jqf) -> QuantizedFeatures:
    return QuantizedFeatures(_t(jqf.q), _t(jqf.x_min), _t(jqf.x_max),
                             jqf.bits)


def test_ref_fused_layer_matches_jax():
    """ref.fused_layer / quant_fused_layer, both activations, a truncating
    and a covering width, float and int8."""
    for name, g, p, x, w, bias in _cases():
        for width in _widths(g):
            jell = jsample(g, width, "aes")
            ell = sample(p, width, "aes")
            for relu in (True, False):
                _close(ref.fused_layer(ell.val, ell.col, _t(x), _t(w),
                                       _t(bias), relu=relu),
                       jref.fused_layer(jell.val, jell.col, jnp.asarray(x),
                                        jnp.asarray(w), jnp.asarray(bias),
                                        relu=relu),
                       f"{name} W={width} relu={relu}")
                jqf = jquantize(x, 8)
                qf = quantize(_t(x), 8)
                np.testing.assert_array_equal(qf.q.numpy(),
                                              np.asarray(jqf.q))
                _close(ref.quant_fused_layer(ell.val, ell.col, qf, _t(w),
                                             _t(bias), relu=relu),
                       jref.quant_fused_layer(jell.val, jell.col, jqf,
                                              jnp.asarray(w),
                                              jnp.asarray(bias), relu=relu),
                       f"{name} W={width} relu={relu} int8")


def test_ops_fused_layer_spmm_cpu_matches_jax():
    """The wrapper's CPU route (the kernel's plain version), float and
    uint8/uint16 with Eq. 2 in the gather, with and without an explicit
    live_w."""
    for name, g, p, x, w, bias in _cases():
        for width in _widths(g):
            jell = jsample(g, width, "aes")
            ell = sample(p, width, "aes")
            live = tg.ell_live_widths(ell.val, ell.col)
            for relu in (True, False):
                want = jref.fused_layer(jell.val, jell.col, jnp.asarray(x),
                                        jnp.asarray(w), jnp.asarray(bias),
                                        relu=relu)
                for lw in (None, live):
                    _close(ops.fused_layer_spmm(ell, _t(x), _t(w), _t(bias),
                                                lw, relu=relu), want,
                           f"{name} W={width} relu={relu}")
                for bits in (8, 16):
                    jqf = jquantize(x, bits)
                    qf = _jqf_to_port(jqf)
                    _close(ops.fused_layer_spmm(
                        ell, qf.q, _t(w), _t(bias), relu=relu,
                        quantized_meta=(qf.scale, qf.x_min)),
                        jref.quant_fused_layer(jell.val, jell.col, jqf,
                                               jnp.asarray(w),
                                               jnp.asarray(bias), relu=relu),
                        f"{name} W={width} relu={relu} u{bits}")
    assert ops.launch_counts()["fused_layer"] == 0


def _counted(module, fn):
    """``fn()`` with ``module``'s obs on; returns (result, counters,
    span names)."""
    prev = module.set_enabled(True)
    module.reset()
    try:
        out = fn()
        counters = dict(module.default_registry().counters())
        spans = [s.name for s in module.default_tracer().spans()]
    finally:
        module.reset()
        module.set_enabled(prev)
    return out, counters, spans


def test_executor_run_fused_layer_matches_jax():
    """run_fused_layer on the torch backend against the reference's jax
    backend: float, int8 with the range guard on an in-range and on a
    drifted operand, and the inv_perm epilogue; the same obs counters
    (backend name aside) and spans."""
    jex, ex = jdefault_executor(), PlanExecutor()
    for name, g, p, x, w, bias in _cases():
        jell, ell = jsample(g, 4, "aes"), sample(p, 4, "aes")
        jqf = jquantize(x, 8)
        qf = _jqf_to_port(jqf)
        perm = np.random.default_rng(5).permutation(g.num_rows)
        drifted = x * 4.0
        for label, feats, quant, inv in (
                ("float", x, False, None), ("int8", x, True, None),
                ("int8 drifted", drifted, True, None),
                ("float inv_perm", x, False, perm)):
            want, jcount, jspans = _counted(jobs, lambda: jex.run_fused_layer(
                jell, jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias),
                backend="jax", quantized=jqf if quant else None,
                requant_guard=quant,
                inv_perm=None if inv is None else jnp.asarray(inv)))
            got, count, spans = _counted(obs, lambda: ex.run_fused_layer(
                ell, _t(feats), _t(w), _t(bias), backend="torch",
                quantized=qf if quant else None, requant_guard=quant,
                inv_perm=None if inv is None else _t(inv)))
            _close(got, want, f"{name} {label}")
            jcount = {k.replace(".jax.", ".torch."): v
                      for k, v in jcount.items()}
            assert count == jcount, f"{name} {label}"
            assert spans == jspans == ["exec.run_fused_layer"], name


@pytest.fixture(scope="module")
def trained():
    """JAX dataset + JAX-trained GCN params, and the port's twins."""
    jds = jmake_dataset(**DATA)
    tds = make_dataset(**DATA, device=CPU)
    params, _ = jtrain_model(jds, "gcn", hidden=16, epochs=30, seed=0)
    return jds, tds, params, params_from_numpy("gcn", params, device=CPU)


def test_evaluate_fused_matches_jax(trained):
    """aes/afs/sfs, W in {8, 16, 64}, quant None/8: the fused logits to
    1e-4 and the accuracy equal or one test node apart, on the torch
    backend and on the cuda backend's CPU route (the plain versions)."""
    jds, tds, jparams, tparams = trained
    n_test = int(np.asarray(jds.test_mask).sum())
    for strategy in ("aes", "afs", "sfs"):
        for W in (8, 16, 64):
            for quant in (None, 8):
                case = f"{strategy} W={W} quant={quant}"
                want_logits = j_fused_gcn_logits(
                    jds.gcn_adj, jds.features, "gcn", jparams, sh_width=W,
                    strategy=strategy, backend="jax", quantize_bits=quant,
                    granularity="graph", plan_cache=None, tune_kwargs=None)
                want = jevaluate(jds, "gcn", jparams, sh_width=W,
                                 strategy=strategy, backend="jax",
                                 quantize_bits=quant, fuse_layers=True)
                for backend in ("torch", "cuda"):
                    kw = dict(sh_width=W, strategy=strategy, backend=backend,
                              quantize_bits=quant, fuse_layers=True,
                              device=CPU)
                    _close(infer_logits(tds, "gcn", tparams, **kw),
                           want_logits, f"{case} {backend}")
                    acc = evaluate(tds, "gcn", tparams, **kw)
                    assert abs(acc - want) * n_test <= 1 + 1e-6, \
                        f"{case} {backend}"


def test_ops_dequantize_matches_jax():
    """tests/test_kernels.py:test_dequant_kernel_sweep's shapes and bits,
    through the wrapper's CPU route."""
    for shape in ((8, 128), (256, 128), (100, 33), (1, 1)):
        for bits in (8, 16):
            x = np.random.default_rng(3).normal(size=shape).astype(
                np.float32) * 5
            jqf = jquantize(x, bits)
            qf = _jqf_to_port(jqf)
            got = ops.dequantize(qf.q, qf.scale, qf.x_min, bits=bits)
            assert got.dtype == torch.float32 and got.shape == shape
            _close(got, jref.dequantize(jqf.q, jqf.x_min, jqf.x_max, bits),
                   f"{shape} bits={bits}", tol=1e-6)
            assert torch.equal(got, dequant_mod.dequantize_plain(
                qf.q, qf.scale, qf.x_min))
    assert ops.launch_counts()["dequantize"] == 0


def test_fused_error_surfaces():
    """The reference's ValueErrors for fuse_layers, the F, H <= 2048
    bound, and the inputs the wrappers refuse; ``strategy="auto"`` with
    fuse_layers runs (its parity with the reference is in
    tests/test_torch_tuning.py)."""
    ds = make_dataset("cora", scale=0.01, device=CPU)
    gcn = init_gcn(np.random.default_rng(0), 96, 8, 7, device=CPU)
    sage = init_sage(np.random.default_rng(0), 96, 8, 7, device=CPU)
    for model, params, kw, match in (
            ("graphsage", sage, {}, "GCN forward only"),
            ("gcn", gcn, dict(backend="cuda_fused"), "'torch'/'cuda'"),
            ("gcn", gcn, dict(granularity="block"), "granularity"),
            ("gcn", gcn, dict(shards=2), "single-device")):
        with pytest.raises(ValueError, match=match):
            evaluate(ds, model, params, fuse_layers=True, device=CPU, **kw)
    acc = evaluate(ds, "gcn", gcn, strategy="auto", fuse_layers=True,
                   plan_cache=PlanCache(), tune_kwargs={"budget": 1},
                   device=CPU)
    assert 0.0 <= acc <= 1.0

    g = random_csr(np.random.default_rng(1), 12, 3.0, skew=0.0)
    ell = sample(tg.CSR(*(_t(a) for a in (g.row_ptr, g.col_ind, g.val)),
                        g.num_cols), 4)
    for feat, hidden, match in ((2049, 4, "exceed"), (4, 2049, "exceed")):
        with pytest.raises(ValueError, match=match):
            ops.fused_layer_spmm(ell, torch.zeros((12, feat)),
                                 torch.zeros((feat, hidden)),
                                 torch.zeros(hidden))
    with pytest.raises(ValueError, match="weight rows"):
        ops.fused_layer_spmm(ell, torch.zeros((12, 6)), torch.zeros((5, 3)),
                             torch.zeros(3))
    val, col = ell.val, ell.col
    live = tg.ell_live_widths(val, col)
    b, w, bias = torch.zeros((12, 6)), torch.zeros((6, 3)), torch.zeros(3)
    for args, kw, match in (
            ((val, col, live, b, w, torch.zeros(4)), {}, "bias"),
            ((val, col, live, b.to(torch.uint8), w, bias), {}, "float32"),
            ((val, col, live, b, w, bias), dict(quantized_meta=(1.0, 0.0)),
             "uint8 or uint16"),
            ((val, col, live, b, w.T.contiguous().T, bias), {}, "contiguous"),
            ((val, col, live.long(), b, w, bias), {}, "live_w"),
            ((val, col, live, b, w, bias.to("meta")), {}, "several devices"),
            ((val, col, live, torch.zeros((12, 20000)),
              torch.zeros((20000, 1)), torch.zeros(1)), {}, "shared memory")):
        with pytest.raises(ValueError, match=match):
            layer_mod.fused_layer(*args, **kw)
    q = torch.zeros((3, 4), dtype=torch.uint8)
    for args, kw, match in (((q, 1.0, 0.0), dict(bits=16), "does not match"),
                            ((q.float(), 1.0, 0.0), {}, "uint8 or uint16"),
                            ((q.T, 1.0, 0.0), {}, "contiguous"),
                            ((q, torch.ones(2), 0.0), {}, "two scalars")):
        with pytest.raises(ValueError, match=match):
            dequant_mod.dequantize(*args, **kw)
