"""The port's tuner against the JAX package's: the same fingerprints, the
same sparsity features and analytic ranking, the same tuned plans (block
configs, BlockELL arrays, width buckets, degree-sorted permutation,
quantized operand) bit for bit, and the same ``evaluate(strategy="auto")``
logits (1e-4) and accuracy (one test node at most) with JAX-trained
parameters, at graph and block granularity, natural and degree-sorted,
float and int8, and with the fused GCN layers.

Both tuners run with ``machine=MachineModel()`` and each package's own
fresh ``PlanCache()`` (the process-wide cache's key ignores the tuning
arguments); the global ``tune()`` gets ``budget=1``, so it times only the
analytic top-1 and timings cannot make the two packages choose apart.
Cases loop inside tests, so the file stays smaller than the JAX package's
test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.graph as jg
from repro.core.aes_spmm import aes_spmm as jaes_spmm
from repro.gnn import evaluate as jevaluate
from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.gnn.infer import _fused_gcn_logits as jfused_gcn_logits
from repro.gnn.models import MODELS as JMODELS
from repro.tuning import PlanCache as JPlanCache
from repro.tuning import calibration as jcal
from repro.tuning import cost_model as jcost
from repro.tuning import features as jfeatures
from repro.tuning import tune as jtune
from repro.tuning import tune_blocked as jtune_blocked
from repro.tuning.plan_cache import features_fingerprint as jfeatures_fp
import repro_torch.core.graph as tg
from repro_torch.tuning import calibration as tcal
from repro_torch.gnn import evaluate, infer_logits, init_gcn, make_dataset, \
    params_from_numpy
from repro_torch.tuning import (CandidateConfig, MachineModel, PlanCache,
                                default_grid,
                                extract_block_features, extract_features,
                                features_fingerprint, fingerprint, rank, tune,
                                tune_blocked)

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
DATA = dict(name="reddit", scale=0.001, seed=3, max_avg_degree=16.0)


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _graphs():
    """A uniform graph, skewed ones, one with bimodal hub rows (where
    ``layout="auto"`` sorts), and the empty graph."""
    rng = np.random.default_rng(41)
    n = 200
    deg = np.where(np.arange(n) % 25 == 0, 60, 2)
    dst = np.repeat(np.arange(n), deg)
    bimodal = jg.csr_from_edges(rng.integers(0, n, dst.shape[0]), dst, n,
                                rng.normal(size=dst.shape[0]).astype(
                                    np.float32))
    return {
        "uniform": random_csr(np.random.default_rng(1), 120, 4.0, skew=0.0),
        "skew": random_csr(np.random.default_rng(2), 260, 8.0, skew=0.7),
        "heavy": random_csr(np.random.default_rng(3), 150, 12.0, skew=0.5),
        "bimodal": bimodal,
        "empty": jg.csr_from_edges(np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), 24),
    }


def test_fingerprints_features_and_ranking_match_reference(tmp_path):
    """``fingerprint``, ``features_fingerprint`` (f32 and uint8), the
    whole-graph and per-block features, the analytic ranking of the
    default grid, under the default and under a calibrated
    ``MachineModel``; the calibration fit, its log round trip and the
    budget it earns, and the log's place beside the port's plan entries."""
    records = jcal.synthetic_records(30)
    fitted = tcal.fit_machine_model(records)
    assert fitted.to_dict() == jcal.fit_machine_model(records).to_dict()
    log = tcal.CalibrationLog(tcal.calibration_dir(tmp_path))
    assert log.root == tmp_path / "repro_torch" / "calibration"
    host = tcal.host_fingerprint()
    assert host != jcal.host_fingerprint()      # torch's device, not jax's
    for rec in records:
        log.append({**rec, "host": host})
    jlog = jcal.CalibrationLog(jcal.calibration_dir(tmp_path))
    for rec in records:
        jlog.append({**rec, "host": jcal.host_fingerprint()})
    assert log.records() == [{**r, "host": host} for r in records]
    for min_records in (24, 31):
        got = tcal.calibrated_machine_model(log=log, min_records=min_records)
        want = jcal.calibrated_machine_model(log=jlog,
                                             min_records=min_records)
        assert (got is None) == (want is None)
    assert tcal.calibrated_machine_model(log=log).to_dict() == \
        fitted.to_dict()
    for budget in (1, 2, 6, 9):
        assert tcal.effective_budget(budget, log=log) == \
            jcal.effective_budget(budget, log=jlog)
    jfitted = jcost.MachineModel.from_dict(fitted.to_dict())
    for name, g in _graphs().items():
        p = to_port(g)
        assert fingerprint(p) == jfeatures.fingerprint(g), name
        x = np.random.default_rng(5).normal(size=(g.num_rows, 7)).astype(
            np.float32)
        for arr in (x, (np.abs(x) * 30).astype(np.uint8)):
            assert features_fingerprint(torch.from_numpy(arr)) == \
                jfeatures_fp(jnp.asarray(arr)), name
        got = extract_features(p, feat_dim=32)
        want = jfeatures.extract_features(g, feat_dim=32)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        for gb, wb in zip(extract_block_features(p, 64, feat_dim=16),
                          jfeatures.extract_block_features(g, 64,
                                                           feat_dim=16)):
            assert dataclasses.asdict(gb) == dataclasses.asdict(wb), name
        for quant, (machine, jmachine) in (
                ((None,), (MachineModel(), jcost.MachineModel())),
                ((None, 8), (MachineModel(), jcost.MachineModel())),
                ((None, 8), (fitted, jfitted))):
            ranked = rank(got, default_grid(quant=quant), machine)
            jranked = jcost.rank(want, jcost.default_grid(quant=quant),
                                 jmachine)
            assert [(e.config.key().replace("-torch-", "-jax-"), e.score)
                    for e in ranked] == [(e.config.key(), e.score)
                                         for e in jranked], name


def test_tuned_plans_match_reference():
    """``tune_blocked`` at every layout, float and int8, and ``tune`` with
    ``budget=1``: the same plans bit for bit."""
    kw = dict(block_rows=32, measure_plan=False, warmup=0, iters=1)
    for name, g in _graphs().items():
        p = to_port(g)
        x = np.random.default_rng(6).normal(size=(g.num_rows, 9)).astype(
            np.float32)
        xt, jx = torch.from_numpy(x), jnp.asarray(x)
        for layout in ("natural", "degree_sorted", "auto"):
            for quant in (None, 8):
                case = (name, layout, quant)
                want = jtune_blocked(g, jx, cache=JPlanCache(), backend="jax",
                                     layout=layout, quant=quant,
                                     machine=jcost.MachineModel(), **kw)
                got = tune_blocked(p, xt, cache=PlanCache(), backend="torch",
                                   layout=layout, quant=quant,
                                   machine=MachineModel(), **kw)
                assert got.block_configs() == want.block_configs(), case
                assert got.buckets == want.buckets, case
                assert got.row_layout == want.row_layout, case
                assert got.fingerprint == want.fingerprint, case
                assert got.features_fp == want.features_fp, case
                assert got.block_digests == want.block_digests, case
                assert got.predicted_us == pytest.approx(want.predicted_us)
                for field in ("val", "col", "live_w"):
                    _same(getattr(got.bell, field), getattr(want.bell, field))
                if want.perm is None:
                    assert got.perm is None, case
                else:
                    _same(got.perm, want.perm)
                if quant is not None:
                    _same(got.quantized.q, want.quantized.q)
        if name == "bimodal":
            assert got.row_layout == "degree_sorted"   # auto sorted the hubs
        for quant in ((None,), (None, 8)):
            want = jtune(g, jx, cache=JPlanCache(), budget=1, quant=quant,
                         machine=jcost.MachineModel(), warmup=0, iters=1)
            got = tune(p, xt, cache=PlanCache(), budget=1, quant=quant,
                       machine=MachineModel(), warmup=0, iters=1)
            assert {**got.config.to_dict(), "backend": "jax"} == \
                want.config.to_dict(), name
            _same(got.ell.val, want.ell.val)
            _same(got.ell.col, want.ell.col)
            assert got.features_fp == want.features_fp


@pytest.fixture(scope="module")
def trained():
    """JAX dataset + JAX-trained params for both models, and the port's
    twins (same bytes, converted params)."""
    jds = jmake_dataset(**DATA)
    tds = make_dataset(**DATA, device=CPU)
    out = {}
    for model in ("gcn", "graphsage"):
        params, _ = jtrain_model(jds, model, hidden=16, epochs=30, seed=0)
        out[model] = (params, params_from_numpy(model, params, device=CPU))
    return jds, tds, out


def _auto_cases():
    """(granularity, layout, quant_bits, fuse_layers)."""
    yield "graph", None, None, False
    for layout in ("natural", "degree_sorted"):
        for quant in (None, 8):
            yield "block", layout, quant, False


def _tune_kwargs(granularity, layout, machine):
    if granularity == "graph":
        return {"budget": 1, "machine": machine, "warmup": 0, "iters": 1}
    return {"block_rows": 64, "layout": layout, "machine": machine,
            "warmup": 0, "iters": 1}


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_evaluate_auto_matches_reference(trained, model):
    """``evaluate(strategy="auto")``: graph and block granularity, natural
    and degree-sorted, float and int8, and (GCN) the fused layers."""
    jds, tds, params = trained
    jparams, tparams = params[model]
    _, fwd, adj_name = JMODELS[model]
    mask = np.asarray(jds.test_mask)
    labels = np.asarray(jds.labels)
    cases = list(_auto_cases())
    if model == "gcn":
        cases.append(("graph", None, None, True))
    for granularity, layout, quant, fuse in cases:
        case = f"{model} {granularity} {layout} quant={quant} fuse={fuse}"
        jkw = dict(plan_cache=JPlanCache(), tune_kwargs=_tune_kwargs(
            granularity, layout, jcost.MachineModel()))
        tkw = dict(plan_cache=PlanCache(), tune_kwargs=_tune_kwargs(
            granularity, layout, MachineModel()))
        if fuse:
            want = np.asarray(jfused_gcn_logits(
                jds.gcn_adj, jds.features, model, jparams, sh_width=128,
                strategy="auto", backend="jax", quantize_bits=None,
                granularity="graph", **jkw))
        else:
            tk = dict(jkw["tune_kwargs"])
            if quant is not None:
                tk["quant"] = quant

            def agg(csr, h):
                return jaes_spmm(csr, h, strategy="auto",
                                 granularity=granularity,
                                 plan_cache=jkw["plan_cache"], tune_kwargs=tk)

            want = np.asarray(fwd(jparams, getattr(jds, adj_name),
                                  jds.features, agg))
        got = infer_logits(tds, model, tparams, strategy="auto",
                           granularity=granularity, quantize_bits=quant,
                           fuse_layers=fuse, device=CPU, **tkw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=case)
        want_acc = float((want.argmax(1) == labels)[mask].mean())
        assert want_acc == pytest.approx(jevaluate(
            jds, model, jparams, strategy="auto", granularity=granularity,
            quantize_bits=quant, fuse_layers=fuse,
            plan_cache=JPlanCache(), tune_kwargs=jkw["tune_kwargs"]),
            abs=1e-6), case
        acc = evaluate(tds, model, tparams, strategy="auto",
                       granularity=granularity, quantize_bits=quant,
                       fuse_layers=fuse, device=CPU, **tkw)
        # logits agree to 1e-4: the argmax may differ only on a test node
        # whose top two classes lie within that of each other
        assert abs(acc - want_acc) * mask.sum() <= 1 + 1e-6, case


def test_graph_plans_carry_live_w(tmp_path, monkeypatch):
    """A graph plan, tuned or read back from disk, carries its ELL's live
    widths, the reference's decode of that ELL: the AES plan from the
    sampler, an SFS one decoded once when made or loaded.  A warm
    ``evaluate(strategy="auto")`` on such a plan then decodes none, plain
    and with the fused layers, on the kernel backend (whose wrappers run
    their plain versions on CPU tensors)."""
    tds = make_dataset(**DATA, device=CPU)
    adj, x = tds.gcn_adj, tds.features
    params = init_gcn(np.random.default_rng(0), x.shape[1], 8,
                      tds.spec.num_classes, device=CPU)
    for strategy in ("aes", "sfs"):
        cfg = CandidateConfig(strategy, 32, "cuda")
        kw = dict(grid=[cfg], machine=MachineModel(), warmup=0, iters=1)
        plan = tune(adj, x, cache=PlanCache(tmp_path / strategy), **kw)
        want = jg.ell_live_widths(jnp.asarray(plan.ell.val.numpy()),
                                  jnp.asarray(plan.ell.col.numpy()))
        _same(plan.ell.live_w, want)
        cache = PlanCache(tmp_path / strategy)
        loaded = cache.get(plan.fingerprint, device=CPU)
        assert loaded is not plan and loaded.config == cfg
        _same(loaded.ell.live_w, want)
        decodes = []
        decode = tg.ell_live_widths
        monkeypatch.setattr(tg, "ell_live_widths",
                            lambda v, c: decodes.append(1) or decode(v, c))
        for fuse in (False, True):
            evaluate(tds, "gcn", params, strategy="auto", fuse_layers=fuse,
                     plan_cache=cache, tune_kwargs=kw, device=CPU)
        assert decodes == [], strategy
        monkeypatch.undo()


_NORMALIZERS = {
    "gcn": lambda m, g: m.gcn_normalize(g),
    "gcn_no_loops": lambda m, g: m.gcn_normalize(g, add_loops=False),
    "mean": lambda m, g: m.mean_normalize(g),
}


@pytest.mark.parametrize("norm", sorted(_NORMALIZERS))
def test_digest_memo_drops_collected_csr(norm):
    """A normalized CSR shares ``row_ptr``/``col_ind`` with its input (not
    with loops added) and carries a new ``val``: once it is collected, the
    memo holds nothing under its key, so a later CSR that takes the dead
    ``val``'s id cannot inherit its digests (nor the plan they key)."""
    base = to_port(_graphs()["skew"])
    c = _NORMALIZERS[norm](tg, base)
    digests = tg.csr_block_digests(c, 64)
    key = tuple(id(t) for t in (c.row_ptr, c.col_ind, c.val))
    assert key in tg._DIGEST_MEMO
    assert tg.csr_block_digests(c, 64) == digests         # a memo hit
    del c
    gc.collect()
    assert key not in tg._DIGEST_MEMO
    # the input, whose row_ptr/col_ind outlive the normalized CSR, still
    # digests its own values
    assert tg.csr_block_digests(base, 64) == jg.csr_block_digests(
        _graphs()["skew"], 64)


@pytest.mark.parametrize("tensor", ["row_ptr", "col_ind", "val"])
def test_digest_memo_misses_after_in_place_edit(tensor):
    """An in-place edit of any of a CSR's tensors changes its digests, to
    the reference's digests of the edited arrays."""
    g = jg.mean_normalize(_graphs()["heavy"])
    c = to_port(g)
    before = tg.csr_block_digests(c, 32)
    arrays = {k: np.array(getattr(g, k)) for k in ("row_ptr", "col_ind",
                                                   "val")}
    if tensor == "val":
        c.val.mul_(2.0)
        arrays["val"] *= 2.0
    elif tensor == "col_ind":
        c.col_ind.add_(1).remainder_(g.num_cols)
        arrays["col_ind"] = (arrays["col_ind"] + 1) % g.num_cols
    else:   # move one edge from row 0 to row 1: same nnz, new row_ptr
        c.row_ptr[1] -= 1
        arrays["row_ptr"][1] -= 1
    after = tg.csr_block_digests(c, 32)
    assert after != before
    want = jg.CSR(*(jnp.asarray(arrays[k]) for k in ("row_ptr", "col_ind",
                                                     "val")), g.num_cols)
    assert after == jg.csr_block_digests(want, 32)
    assert fingerprint(c) == jfeatures.fingerprint(want)


@pytest.mark.parametrize("digest_rows", [1, 64, tg.DIGEST_BLOCK_ROWS])
def test_digests_of_untouched_csr_match_reference(digest_rows):
    """Digests stay bit-identical to the reference's for the same numpy
    arrays, computed afresh, served from the memo, and for a subset of
    blocks."""
    for name, g in _graphs().items():
        c = to_port(g)
        want = jg.csr_block_digests(g, digest_rows)
        assert tg.csr_block_digests(c, digest_rows) == want, name
        assert tg.csr_block_digests(c, digest_rows) == want, name
        some = list(range(0, len(want), 3))
        assert tg.csr_block_digests(c, digest_rows, blocks=some) == \
            [want[b] for b in some], name
