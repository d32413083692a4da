"""The port's sampled GCN/GraphSAGE inference against the JAX package's:
with JAX-trained parameters passed through ``params_from_numpy``, the same
logits (1e-4) and the same test accuracy (one test node at most) for every
strategy, width, quantization and backend of the paper's protocol.

One test per (model, quantization); each loops over its strategies,
widths and backends, so the file stays smaller than the JAX package's
test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.aes_spmm import sample as jsample
from repro.core.quantization import dequantize as jdequantize
from repro.core.quantization import quantize as jquantize
from repro.exec import PlanExecutor as JPlanExecutor
from repro.gnn import evaluate as jevaluate
from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.gnn.models import MODELS as JMODELS
from repro.gnn.models import exact_agg as jexact_agg
from repro.gnn.models import make_sampled_agg as jmake_sampled_agg
from repro_torch.gnn import (evaluate, infer_logits, make_dataset,
                             params_from_numpy)

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
DATA = dict(name="reddit", scale=0.001, seed=3, max_avg_degree=16.0)


@pytest.fixture(scope="module")
def trained():
    """JAX dataset + JAX-trained params for both models, and the port's
    twins of each (same bytes, converted params)."""
    jds = jmake_dataset(**DATA)
    tds = make_dataset(**DATA, device=CPU)
    out = {}
    for model in ("gcn", "graphsage"):
        params, _ = jtrain_model(jds, model, hidden=16, epochs=30, seed=0)
        out[model] = (params, params_from_numpy(model, params, device=CPU))
    return jds, tds, out


_JAX_LOGITS: dict = {}


def _jax_logits(jds, model, params, strategy, W, quant, int8_gather):
    """Reference logits from the JAX package's own pieces.

    ``int8_gather`` is the semantics of the quantized kernel path
    (``backend="pallas"`` there, ``"cuda"`` here): both layers go through
    ``PlanExecutor.run_ell`` with the stored quantized operand and the
    range guard.  The reference runs it on its jnp backend, since the
    installed jax cannot trace the Pallas kernels.
    """
    key = (model, strategy, W, quant, int8_gather)
    if key not in _JAX_LOGITS:
        _, fwd, adj_name = JMODELS[model]
        adj = getattr(jds, adj_name)
        feats = jds.features
        qf = None
        if quant is not None:
            qf = jquantize(feats, quant)
            feats = jdequantize(qf)
        if strategy == "full":
            agg = jexact_agg
        elif int8_gather:
            def agg(csr, h):
                ell = jsample(csr, W, strategy)
                return JPlanExecutor().run_ell(ell, h, backend="jax",
                                               quantized=qf,
                                               requant_guard=True)
        else:
            agg = jmake_sampled_agg(W, strategy, "jax")
        logits = np.asarray(fwd(params, adj, feats, agg))
        _JAX_LOGITS[key] = logits
    return _JAX_LOGITS[key]


def _cases():
    for backend in ("torch", "cuda"):
        yield "full", 0, backend
    for strategy in ("aes", "afs", "sfs"):
        for W in (8, 16, 64):
            for backend in ("torch", "cuda"):
                yield strategy, W, backend
    for W in (8, 16, 64):
        yield "aes", W, "cuda_fused"


@pytest.mark.parametrize("quant", [None, 8])
@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_logits_and_accuracy_match_jax(trained, model, quant):
    """full/aes/afs/sfs, W in {8, 16, 64}, on torch, cuda (its CPU plain
    path) and cuda_fused."""
    jds, tds, params = trained
    jparams, tparams = params[model]
    for strategy, W, backend in _cases():
        _check_case(jds, tds, model, jparams, tparams, strategy, W, quant,
                    backend)


def _check_case(jds, tds, model, jparams, tparams, strategy, W, quant,
                backend):
    case = f"{model} {strategy} W={W} quant={quant} {backend}"
    int8_gather = (backend == "cuda" and quant is not None
                   and strategy != "full")
    want = _jax_logits(jds, model, jparams, strategy, W, quant, int8_gather)
    got = infer_logits(tds, model, tparams, sh_width=W or 128,
                       strategy=strategy, backend=backend,
                       quantize_bits=quant, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                               err_msg=case)

    acc = evaluate(tds, model, tparams, sh_width=W or 128, strategy=strategy,
                   backend=backend, quantize_bits=quant, device=CPU)
    mask = np.asarray(jds.test_mask)
    labels = np.asarray(jds.labels)
    want_acc = float((want.argmax(1) == labels)[mask].mean())
    if not int8_gather:
        assert want_acc == pytest.approx(
            jevaluate(jds, model, jparams, sh_width=W or 128,
                      strategy=strategy, backend="jax", quantize_bits=quant),
            abs=1e-6), case
    # logits agree to 1e-4, so the argmax can differ only on a test node
    # whose top two classes lie within that of each other: allow one node
    assert abs(acc - want_acc) * mask.sum() <= 1 + 1e-6, case


