"""The port's sharded serving against the JAX package's: ``row_bounds`` and
``partition_csr`` (halo ids, gather indices and shard CSRs bit for bit),
``plan_shards`` (plans bit for bit, float and int8), ``GNNServer`` on the
CPU (``aggregate`` within 1e-5 of the reference's, exact on integer
inputs; int8 within the ``scale/2`` bound), the resident-operand dedupe
decision, enqueue-time validation, the warm restart from disk,
``apply_edge_updates_sharded`` (the same routing report and bit-equal
plans for a patch, a growing and a shrinking halo) and ``evaluate(shards=3)``
with the JAX package's trained parameters.

Every tune uses each package's own fresh ``PlanCache()``, its own
``MachineModel()`` and ``measure_plan=False, measure_buckets=False``.
Cases loop or are parameters of a few tests, so the file stays smaller
than the JAX package's test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.serving as js
from repro.gnn import evaluate as jevaluate
from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.kernels import ref as jref
from repro.tuning import PlanCache as JPlanCache
from repro.tuning.cost_model import MachineModel as JMachineModel
import repro_torch.core.graph as tg
from repro_torch.distributed import shard_devices
from repro_torch.gnn import evaluate, make_dataset, params_from_numpy
from repro_torch.serving import (GNNServer, concat_shard_outputs,
                                 halo_stats, partition_csr, plan_shards,
                                 row_bounds, shard_meta_for)
from repro_torch.serving.plans import apply_edge_updates_sharded
from repro_torch.tuning import MachineModel, PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
NO_MEASURE = dict(measure_plan=False, measure_buckets=False, warmup=0,
                  iters=1)


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _tk(csr, port: bool, exact: bool = True, **over) -> dict:
    """Tuning knobs for one package: with ``exact`` no candidate truncates
    an edge (the engine machinery is under test, not sampling loss)."""
    tk = dict(NO_MEASURE, machine=MachineModel() if port
              else JMachineModel())
    if exact:
        tk.update(widths=(max(int(np.asarray(csr.row_nnz()).max()), 1),),
                  include_full=True)
    else:
        tk.update(block_rows=16, widths=(2, 4, 8))
    tk.update(over)
    return tk


def _servers(g, x, shards=2, exact=True, **kw):
    """The reference's and the port's server over the same graph."""
    jserver = js.GNNServer(g, jnp.asarray(x), num_shards=shards,
                           cache=JPlanCache(),
                           tune_kwargs=_tk(g, False, exact), **kw)
    server = GNNServer(to_port(g), torch.from_numpy(x), num_shards=shards,
                       cache=PlanCache(), tune_kwargs=_tk(g, True, exact),
                       devices=[CPU], **kw)
    return jserver, server


def _dense_ref(g, x):
    return np.asarray(jref.csr_spmm(g.row_ptr, g.col_ind, g.val, x))


def _same_shard(got, want, what=""):
    assert (got.shard_idx, got.num_shards, got.row_start, got.row_stop) \
        == (want.shard_idx, want.num_shards, want.row_start, want.row_stop)
    _same(got.halo_ids, want.halo_ids, f"{what} halo_ids")
    _same(got.gather_index, want.gather_index, f"{what} gather_index")
    for f in ("row_ptr", "col_ind", "val"):
        _same(getattr(got.csr, f), getattr(want.csr, f), f"{what} {f}")
    assert got.csr.num_cols == want.csr.num_cols, what


def _same_plan(got, want, what=""):
    assert got.fingerprint == want.fingerprint, what
    assert got.shard_meta == want.shard_meta, what
    assert got.bell.widths == want.bell.widths, what
    assert got.bell.strategies == want.bell.strategies, what
    assert got.buckets == want.buckets, what
    for f in ("val", "col", "live_w"):
        _same(getattr(got.bell, f), getattr(want.bell, f), f"{what} {f}")
    assert got.features_fp == want.features_fp, what
    assert (got.quantized is None) == (want.quantized is None), what
    if want.quantized is not None:
        _same(got.quantized.q, want.quantized.q, f"{what} q")


@pytest.mark.parametrize("num_shards", [2, 3])
def test_partition_bit_equal_to_reference(num_shards):
    rng = np.random.default_rng(num_shards)
    g = random_csr(rng, 53, 5.0, skew=0.8)
    x = rng.normal(size=(53, 6)).astype(np.float32)
    _same(row_bounds(53, num_shards), js.row_bounds(53, num_shards))
    for bad in ((3, 4), (5, 0)):
        with pytest.raises(ValueError):
            row_bounds(*bad)
        with pytest.raises(ValueError):
            js.row_bounds(*bad)
    shards = partition_csr(to_port(g), num_shards)
    jshards = js.partition_csr(g, num_shards)
    assert len(shards) == len(jshards)
    for s, j in zip(shards, jshards):
        _same_shard(s, j, f"shard {s.shard_idx}")
        _same(s.gather(torch.from_numpy(x)), j.gather(jnp.asarray(x)))
        assert shard_meta_for(s) == js.shard_meta_for(j)
    assert halo_stats(shards) == js.halo_stats(jshards)
    outs = [torch.full((2, 3), float(s)) for s in range(3)]
    assert concat_shard_outputs(outs)[::2, 0].tolist() == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("quant", [None, 8])
def test_plan_shards_bit_equal_to_reference(quant):
    rng = np.random.default_rng(11)
    g = random_csr(rng, 70, 6.0, skew=0.7)
    x = rng.normal(size=(70, 5)).astype(np.float32)
    shards = partition_csr(to_port(g), 3)
    jshards = js.partition_csr(g, 3)
    plans = plan_shards(shards, torch.from_numpy(x), quant=quant,
                        cache=PlanCache(), tune_kwargs=_tk(g, True, False))
    jplans = js.plan_shards(jshards, jnp.asarray(x), quant=quant,
                            cache=JPlanCache(),
                            tune_kwargs=_tk(g, False, False))
    for i, (p, j) in enumerate(zip(plans, jplans)):
        _same_plan(p, j, f"shard {i}")


@pytest.mark.parametrize("num_shards", [2, 4])
def test_server_aggregate_matches_reference(num_shards):
    rng = np.random.default_rng(20 + num_shards)
    # float inputs, sampled plans: within 1e-5 of the reference's server
    g = random_csr(rng, 62, 5.0)
    x = rng.normal(size=(62, 10)).astype(np.float32)
    h = rng.normal(size=(62, 7)).astype(np.float32)
    jserver, server = _servers(g, x, num_shards, exact=False)
    for op in (None, h):
        want = np.asarray(jserver.aggregate(None if op is None
                                            else jnp.asarray(op)))
        got = server.aggregate(None if op is None else torch.from_numpy(op))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert server.num_shards == num_shards
    assert server.plan_summary() == jserver.plan_summary()
    assert server.halo_stats() == jserver.halo_stats()
    # integer inputs, exact plans: every sum is exact in f32, so the sharded
    # port reproduces the dense reference bit for bit
    g = random_csr(rng, 62, 5.0, weighted=False)
    x = rng.integers(-8, 8, size=(62, 10)).astype(np.float32)
    jserver, server = _servers(g, x, num_shards)
    _same(server.aggregate(), _dense_ref(g, x))
    _same(server.aggregate(), np.asarray(jserver.aggregate()))


def test_quantized_server_within_half_scale():
    rng = np.random.default_rng(5)
    g = random_csr(rng, 48, 4.0)
    x = rng.normal(size=(48, 6)).astype(np.float32)
    jserver, server = _servers(g, x, 2, quant=8)
    assert all(r is None for r in server._resident)     # uint8 operands
    got, want = server.aggregate().numpy(), np.asarray(jserver.aggregate())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # against the exact product: scale/2 per element times the row weights
    rows = np.repeat(np.arange(48), np.diff(np.asarray(g.row_ptr)))
    rowsum = np.bincount(rows, np.abs(np.asarray(g.val)), minlength=48)
    bound = max(float(p.quantized.scale) for p in server.plans) / 2 \
        * rowsum[:, None] + 1e-5
    assert np.all(np.abs(got - _dense_ref(g, x)) <= bound)
    # a dense operand takes the float path (no hash, exact)
    h = rng.normal(size=(48, 3)).astype(np.float32)
    np.testing.assert_allclose(server.aggregate(torch.from_numpy(h)).numpy(),
                               _dense_ref(g, h), rtol=1e-5, atol=1e-5)


def test_resident_dedupe_decision_matches_reference():
    """The port decides by a bitwise compare on the operand's device where
    the reference compares host content hashes: the same answer on an
    equal copy, a perturbed copy, another dtype and a signed zero."""
    rng = np.random.default_rng(8)
    g = random_csr(rng, 30, 4.0)
    x = rng.normal(size=(30, 5)).astype(np.float32)
    x[3, 2] = 0.0
    jserver, server = _servers(g, x)
    perturbed = x.copy()
    perturbed[7, 1] = np.nextafter(perturbed[7, 1], np.float32(np.inf))
    signed_zero = x.copy()
    signed_zero[3, 2] = -0.0
    cases = {"equal": x.copy(), "perturbed": perturbed,
             "float64": x.astype(np.float64), "int": x.astype(np.int32),
             "signed_zero": signed_zero, "wider": np.tile(x, (1, 2))}
    decisions = {}
    for name, op in cases.items():
        want = jserver._is_resident_operand(jserver.validate_operand(op))
        got = server._is_resident_operand(server.validate_operand(op))
        assert got == want, name
        decisions[name] = got
    assert decisions == {"equal": True, "perturbed": False, "float64": True,
                         "int": False, "signed_zero": False, "wider": False}
    assert server._is_resident_operand(server.features)
    t = [server.submit(op) for op in cases.values()]
    out = server.flush()
    assert server.stats["resident_dedupes"] == 2
    assert server.stats["sharded_passes"] == 2
    np.testing.assert_allclose(out[t[0]].numpy(), _dense_ref(g, x),
                               rtol=1e-5, atol=1e-5)


def test_batching_validation_and_lifecycle():
    rng = np.random.default_rng(3)
    g = random_csr(rng, 30, 4.0)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    h = rng.normal(size=(30, 9)).astype(np.float32)
    jserver, server = _servers(g, x)
    for srv, arr in ((jserver, jnp.asarray), (server, torch.from_numpy)):
        t = [srv.submit(), srv.submit(arr(h)), srv.submit(),
             srv.submit(arr(h * 2.0))]
        out = srv.flush()
        assert srv.stats["requests"] == 4 and srv.stats["sharded_passes"] == 2
        np.testing.assert_allclose(np.asarray(out[t[1]]), _dense_ref(g, h),
                                   rtol=1e-5, atol=1e-5)
        _same(np.asarray(out[t[0]]), np.asarray(out[t[2]]))
        assert srv.flush() == []
        pending = srv.submit(arr(h))
        np.testing.assert_allclose(np.asarray(srv.aggregate()),
                                   _dense_ref(g, x), rtol=1e-5, atol=1e-5)
        assert len(srv.flush()) == 1 and pending == 0
    with pytest.raises(ValueError, match="num_nodes"):
        server.submit(np.zeros((31, 3), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        server.submit(np.zeros(30, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        server.submit(np.zeros((30, 3), np.complex64))
    with pytest.raises(ValueError, match="dtype"):
        server.submit(torch.zeros((30, 3), dtype=torch.complex64))
    with pytest.raises(ValueError, match="dtype"):
        server.submit(np.array([["a"] * 3] * 30))
    server.submit(np.ones((30, 2), np.int32))
    server.submit(np.ones((30, 2), bool))
    assert len(server.close()) == 2
    with pytest.raises(ValueError, match="closed"):
        server.submit()
    assert server.close() == []
    with pytest.raises(ValueError, match="unknown mode"):
        GNNServer(to_port(g), x, mode="ring", devices=[CPU])
    assert shard_devices(3, ["cpu"]) == [torch.device("cpu")] * 3
    assert GNNServer(to_port(g), x, cache=PlanCache(), devices=[CPU],
                     tune_kwargs=_tk(g, True)).num_shards == 1


def test_warm_restart_is_a_pure_disk_hit(tmp_path, monkeypatch):
    import repro_torch.core.sampling as sampling_mod
    import repro_torch.tuning.cost_model as cost_model_mod

    rng = np.random.default_rng(4)
    g = random_csr(rng, 44, 5.0, skew=0.8)
    x = torch.from_numpy(rng.normal(size=(44, 8)).astype(np.float32))
    c1 = PlanCache(cache_dir=tmp_path)
    want = GNNServer(to_port(g), x, num_shards=4, cache=c1, quant=8,
                     tune_kwargs=_tk(g, True), devices=[CPU]).aggregate()

    def boom(*a, **k):
        raise AssertionError("tuning ran on a warm plan cache")

    monkeypatch.setattr(cost_model_mod, "rank", boom)
    monkeypatch.setattr(sampling_mod, "sample_csr_to_block_ell", boom)
    c2 = PlanCache(cache_dir=tmp_path)
    server = GNNServer(to_port(g), x, num_shards=4, cache=c2, quant=8,
                       tune_kwargs=_tk(g, True), devices=[CPU])
    assert c2.stats.misses == 0 and c2.stats.disk_hits == 4
    _same(server.aggregate(), want.numpy())


def _delta(g, kind):
    """A delta that patches shard 1 in place, grows its halo, or deletes
    the only edge to one of its halo columns (the halo shrinks)."""
    rp, ci = np.asarray(g.row_ptr), np.asarray(g.col_ind)
    shards = js.partition_csr(g, 3)
    sh = shards[1]
    row = sh.row_start + 1
    cols = ci[rp[row]:rp[row + 1]]
    if kind == "patch":
        # replace one edge of `row` by a local column it lacks
        new = next(c for c in range(sh.row_start, sh.row_stop)
                   if c not in cols)
        return [(row, int(new), 0.5)], [(row, int(cols[0]))]
    if kind == "grow":
        new = next(c for c in range(g.num_rows)
                   if not sh.row_start <= c < sh.row_stop
                   and c not in sh.halo_ids)
        return [(row, int(new), 2.0)], []
    seg = np.asarray(sh.csr.col_ind)
    counts = np.bincount(seg[seg >= sh.num_local] - sh.num_local,
                         minlength=sh.num_halo)
    pos = int(np.flatnonzero(counts == 1)[0])
    gcol = int(sh.halo_ids[pos])
    lrow = int(np.searchsorted(np.asarray(sh.csr.row_ptr),
                               int(np.flatnonzero(seg == sh.num_local + pos)
                                   [0]), side="right")) - 1
    return [], [(sh.row_start + lrow, gcol)]


@pytest.mark.parametrize("kind", ["patch", "grow", "shrink"])
def test_sharded_edge_updates_match_reference(kind):
    rng = np.random.default_rng(9)
    g = random_csr(rng, 60, 4.0, skew=0.0)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    adds, dels = _delta(g, kind)
    shards = partition_csr(to_port(g), 3)
    jshards = js.partition_csr(g, 3)
    tk, jtk = _tk(g, True, False), _tk(g, False, False)
    plans = plan_shards(shards, torch.from_numpy(x), cache=PlanCache(),
                        tune_kwargs=tk)
    jplans = js.plan_shards(jshards, jnp.asarray(x), cache=JPlanCache(),
                            tune_kwargs=jtk)
    new, new_plans, report = apply_edge_updates_sharded(
        shards, plans, adds, dels, torch.from_numpy(x), cache=PlanCache(),
        tune_kwargs=tk)
    from repro.serving.plans import apply_edge_updates_sharded as japply

    jnew, jnew_plans, jreport = japply(
        jshards, jplans, adds, dels, jnp.asarray(x), cache=JPlanCache(),
        tune_kwargs=jtk)
    for key in ("patched", "retuned", "untouched", "halo_shrunk"):
        assert report[key] == jreport[key], key
    assert report[{"patch": "patched", "grow": "retuned",
                   "shrink": "halo_shrunk"}[kind]] == [1]
    assert report["untouched"] == [0, 2]
    assert new[0] is shards[0] and new_plans[2] is plans[2]
    for i in range(3):
        _same_shard(new[i], jnew[i], f"shard {i}")
        _same_plan(new_plans[i], jnew_plans[i], f"shard {i}")
    # the live server patched in place equals a fresh server on the
    # patched graph
    server = GNNServer(to_port(g), torch.from_numpy(x), num_shards=3,
                       cache=PlanCache(), tune_kwargs=_tk(g, True),
                       devices=[CPU])
    assert server.apply_edge_updates(adds, dels)["patched" if kind ==
                                                 "patch" else "retuned"] \
        == [1]
    patched, _ = tg.apply_csr_deltas(to_port(g), adds, dels)
    fresh = GNNServer(patched, torch.from_numpy(x), num_shards=3,
                      cache=PlanCache(), tune_kwargs=_tk(g, True),
                      devices=[CPU])
    np.testing.assert_allclose(server.aggregate().numpy(),
                               fresh.aggregate().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_evaluate_shards_matches_reference():
    jds = jmake_dataset("cora", scale=0.08, seed=3)
    tds = make_dataset("cora", scale=0.08, seed=3, device=CPU)
    jparams, _ = jtrain_model(jds, "gcn", epochs=20, seed=3)
    params = params_from_numpy("gcn", jparams, device=CPU)
    g = jds.gcn_adj
    want = jevaluate(jds, "gcn", jparams, strategy="auto", shards=3,
                     plan_cache=JPlanCache(), tune_kwargs=_tk(g, False))
    got = evaluate(tds, "gcn", params, strategy="auto", shards=3,
                   plan_cache=PlanCache(), tune_kwargs=_tk(g, True),
                   device=CPU)
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx(
        jevaluate(jds, "gcn", jparams, strategy="full"), abs=1e-6)
    with pytest.raises(ValueError, match="strategy='auto'"):
        evaluate(tds, "gcn", params, strategy="aes", shards=2, device=CPU)
    with pytest.raises(ValueError, match="single-device"):
        evaluate(tds, "gcn", params, strategy="auto", shards=2,
                 fuse_layers=True, device=CPU)
