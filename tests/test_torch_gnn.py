"""The port's GNN pipeline against the JAX package's: byte-identical
datasets, the same random initialisation, the accuracy grid, the options
a later slice brings, and the obs spans and counters.  The logits grid is
in tests/test_torch_gnn_logits.py.  Cases loop inside tests, so the file
stays smaller than the JAX package's test files (see
tests/test_torch_core.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.gnn.infer import inference_accuracy as jinference_accuracy
from repro.gnn.models import init_gcn as jinit_gcn
from repro.gnn.models import init_sage as jinit_sage
from repro_torch import obs
from repro_torch.gnn import (evaluate, inference_accuracy, init_gcn,
                             init_sage, make_dataset, params_from_numpy)

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
DATA = dict(name="reddit", scale=0.001, seed=3, max_avg_degree=16.0)


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_dataset_byte_identical():
    for name, scale, cap in (("cora", 0.05, 64.0), ("pubmed", 0.01, 64.0),
                             ("ogbn-arxiv", 0.002, 64.0),
                             ("reddit", 0.001, None)):
        want = jmake_dataset(name, scale=scale, seed=1, max_avg_degree=cap)
        got = make_dataset(name, scale=scale, seed=1, max_avg_degree=cap,
                           device=CPU)
        assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
        for adj in ("csr", "gcn_adj", "sage_adj"):
            for field in ("row_ptr", "col_ind", "val"):
                _same(getattr(getattr(got, adj), field),
                      getattr(getattr(want, adj), field))
        for field in ("features", "labels", "train_mask", "test_mask"):
            _same(getattr(got, field), getattr(want, field))


def test_init_draws_match_jax():
    for model, jinit, tinit in (("gcn", jinit_gcn, init_gcn),
                                ("graphsage", jinit_sage, init_sage)):
        want = jinit(np.random.default_rng(4), 12, 8, 5)
        got = tinit(np.random.default_rng(4), 12, 8, 5, device=CPU)
        for field, value in want._asdict().items():
            _same(getattr(got, field).detach(), value)
        round_trip = params_from_numpy(model, want, device=CPU)
        for field, value in want._asdict().items():
            _same(getattr(round_trip, field).detach(), value)


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


def test_inference_accuracy_grid_matches_jax(trained):
    jds, tds, params = trained
    jparams, tparams = params["graphsage"]
    kw = dict(strategies=("full", "aes", "sfs"), widths=(8, 16))
    want = jinference_accuracy(jds, "graphsage", jparams, backend="jax", **kw)
    got = inference_accuracy(tds, "graphsage", tparams, backend="cuda",
                             device=CPU, **kw)
    assert got.keys() == want.keys()
    n_test = int(np.asarray(jds.test_mask).sum())
    for key, acc in want.items():
        assert abs(got[key] - acc) * n_test <= 1 + 1e-6, key


def test_unported_options_raise(trained):
    _, tds, params = trained
    m = params["gcn"][1]
    # shards= is ported (parity in tests/test_torch_serving.py); the SPMD
    # serving mode comes with the multi-card slice
    from repro_torch.serving import GNNServer

    with pytest.raises(NotImplementedError, match="multi-card"):
        GNNServer(tds.gcn_adj, tds.features, mode="spmd", devices=[CPU])
    # the tuned path is ported (parity in tests/test_torch_tuning.py);
    # granularity="block" still needs strategy="auto", as in the reference
    with pytest.raises(ValueError, match='requires strategy="auto"'):
        evaluate(tds, "gcn", m, granularity="block", device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        evaluate(tds, "gcn", m, backend="pallas", device=CPU)


def test_obs_spans_and_counters(trained):
    _, tds, params = trained
    prev = obs.set_enabled(True)
    obs.reset()
    try:
        evaluate(tds, "gcn", params["gcn"][1], sh_width=16, strategy="aes",
                 backend="cuda", quantize_bits=8, device=CPU)
        counters = obs.default_registry().counters()
        spans = obs.default_tracer().spans()
    finally:
        obs.reset()
        obs.set_enabled(prev)
    assert counters["sampler.calls.aes"] == 2
    assert counters["executor.run_ell.cuda.int8"] >= 1
    assert counters["quant.requant_run_ell"] == 2
    assert counters["sampler.edges_kept"] > 0
    root = [s for s in spans if s.name == "gnn.evaluate"]
    runs = [s for s in spans if s.name == "exec.run_ell"]
    assert len(root) == 1 and len(runs) == 2
    assert all(s.trace_id == root[0].trace_id for s in runs)
    assert "accuracy" in root[0].attrs
