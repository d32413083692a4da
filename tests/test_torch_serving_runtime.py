"""The port's serving runtime, telemetry, traffic and observability against
the JAX package's: ``ServingRuntime`` results equal the synchronous
``flush()`` bit for bit; the size/deadline/drain triggers, backpressure
(``block``/``reject``), ``drain`` and ``close`` behave as in the reference;
``LatencyHistogram``/``Telemetry``/``MetricsRegistry`` give the reference's
numbers on the same samples; the runtime's ``serve.request`` ->
``serve.queue``/``serve.device`` span tree; the Perfetto export, span
trees and summaries equal the reference's on the same records; and the
three command lines' ``--smoke --device cpu`` in subprocesses.

Runtimes run on the CPU over small graphs with fresh ``PlanCache()``s.
Cases loop or are parameters of a few tests, so the file stays smaller
than the JAX package's test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import export as jexport
from repro.serving import LatencyHistogram as JLatencyHistogram
from repro.serving import Telemetry as JTelemetry
from repro.serving import poisson_arrivals as jpoisson_arrivals
from repro.kernels import ref as jref
import repro_torch.core.graph as tg
from repro_torch import obs
from repro_torch.obs import export
from repro_torch.serving import (BackpressureError, GNNServer,
                                 LatencyHistogram, ServingRuntime, Telemetry,
                                 poisson_arrivals, run_open_loop,
                                 sync_baseline)
from repro_torch.tuning import PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _server(seed=0, rows=36, shards=2):
    rng = np.random.default_rng(seed)
    g = random_csr(rng, rows, 4.0)
    x = torch.from_numpy(rng.normal(size=(rows, 6)).astype(np.float32))
    w = max(int(np.asarray(g.row_nnz()).max()), 1)
    server = GNNServer(
        tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                 (g.row_ptr, g.col_ind, g.val)), g.num_cols),
        x, num_shards=shards, cache=PlanCache(), devices=["cpu"],
        tune_kwargs=dict(widths=(w,), include_full=True, measure_plan=False,
                         warmup=0, iters=1))
    want = np.asarray(jref.csr_spmm(g.row_ptr, g.col_ind, g.val, x.numpy()))
    return g, x, server, want


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_runtime_results_equal_synchronous_flush():
    """The runtime is a scheduler, not a numeric path: identical requests
    through the runtime and through ``flush()`` give identical tensors."""
    g, x, server, want = _server()
    h = torch.from_numpy(
        np.random.default_rng(1).normal(size=(g.num_rows, 5))
        .astype(np.float32))
    t0, t1 = server.submit(), server.submit(h)
    sync = server.flush()
    _close(sync[t0], want)
    with ServingRuntime(server, max_batch=2, max_delay_ms=50.0) as rt:
        r0, r1 = rt.submit(), rt.submit(h)
        assert torch.equal(r0.result(30), sync[t0])
        assert torch.equal(r1.result(30), sync[t1])
        assert rt.aggregate(h, timeout=30).equal(sync[t1])
        # continuous batching: requests admitted while earlier batches run
        reqs = [rt.submit() for _ in range(12)]
        assert all(torch.equal(r.result(60), sync[t0]) for r in reqs)
        snap = rt.snapshot()
    assert snap["counters"]["completed"] == 15
    assert snap["counters"]["batches"] >= 2
    assert snap["counters"]["queue_depth"] == 0
    assert "counters" in snap["obs"]


def test_deadline_size_and_drain_triggers():
    g, x, server, want = _server()
    # deadline: fewer requests than max_batch and nothing else arriving
    with ServingRuntime(server, max_batch=64, max_delay_ms=20.0) as rt:
        reqs = [rt.submit(), rt.submit(x * 3.0)]
        _close(reqs[0].result(30), want)
        _close(reqs[1].result(30), want * 3, 1e-4)
        snap = rt.snapshot()
    assert (snap["counters"]["batches"], snap["counters"]["batches_deadline"],
            snap["counters"]["batches_size"]) == (1, 1, 0)
    assert reqs[0].batch_size == 2 and reqs[0].latency_us()["total"] > 0
    # size: a burst of 8 at max_batch=4 flushes long before the deadline
    t0 = time.perf_counter()
    with ServingRuntime(server, max_batch=4, max_delay_ms=30_000.0) as rt:
        reqs = [rt.submit() for _ in range(8)]
        for r in reqs:
            _close(r.result(60), want)
        snap = rt.snapshot()
    assert time.perf_counter() - t0 < 20.0
    assert snap["counters"]["batches_size"] >= 2
    assert all(r.batch_size == 4 for r in reqs)
    # drain: close() serves requests parked behind a far deadline
    rt = ServingRuntime(server, max_batch=64, max_delay_ms=60_000.0)
    reqs = [rt.submit() for _ in range(5)]
    assert not any(r.done() for r in reqs)
    rt.close()
    assert all(r.done() for r in reqs)
    _close(reqs[0].result(0), want)
    assert rt.telemetry.counters["batches_drain"] >= 1
    with pytest.raises(ValueError, match="closed"):
        rt.submit()
    rt.close()   # idempotent
    # drain() waits without closing
    with ServingRuntime(server, max_batch=2, max_delay_ms=5.0) as rt:
        reqs = [rt.submit() for _ in range(6)]
        assert rt.drain(timeout=60.0)
        assert all(r.done() for r in reqs)
        rt.submit().result(30)


def test_backpressure_policies():
    g, x, server, _ = _server()
    rt = ServingRuntime(server, max_batch=64, max_delay_ms=60_000.0,
                        queue_depth=2, policy="reject")
    try:
        rt.submit()
        rt.submit()
        with pytest.raises(BackpressureError):
            rt.submit()
        assert rt.telemetry.counters["rejected"] == 1
    finally:
        rt.close()
    assert rt.telemetry.counters["completed"] == 2
    # block: the deadline flush frees the slot the second submitter waits on
    rt = ServingRuntime(server, max_batch=4, max_delay_ms=150.0,
                        queue_depth=1, policy="block")
    try:
        first, got_in = rt.submit(), []
        th = threading.Thread(target=lambda: got_in.append(rt.submit()))
        th.start()
        th.join(timeout=30.0)
        assert not th.is_alive() and len(got_in) == 1
        first.result(30)
        got_in[0].result(30)
    finally:
        rt.close()
    rt = ServingRuntime(server, max_batch=64, max_delay_ms=60_000.0,
                        queue_depth=1, policy="block")
    try:
        rt.submit()
        with pytest.raises(BackpressureError):
            rt.submit(timeout=0.05)
    finally:
        rt.close()
    for bad, match in ((dict(policy="drop-oldest"), "policy"),
                       (dict(max_batch=0), "max_batch"),
                       (dict(queue_depth=0), "queue_depth"),
                       (dict(pipeline_depth=0), "pipeline_depth")):
        with pytest.raises(ValueError, match=match):
            ServingRuntime(server, **bad)


def test_runtime_validates_at_enqueue():
    g, x, server, want = _server()
    with ServingRuntime(server, max_batch=8, max_delay_ms=10.0) as rt:
        ok = rt.submit()
        with pytest.raises(ValueError, match="num_nodes"):
            rt.submit(np.zeros((g.num_rows + 2, 3), np.float32))
        with pytest.raises(ValueError, match="dtype"):
            rt.submit(np.zeros((g.num_rows, 3), np.complex64))
        _close(ok.result(30), want)
        assert rt.telemetry.counters["failed"] == 0


@pytest.mark.parametrize("samples", ["lognormal", "junk_and_overflow"])
def test_latency_histogram_matches_reference(samples):
    rng = np.random.default_rng(2)
    if samples == "lognormal":
        values = list(rng.lognormal(6.0, 2.0, size=500))
    else:
        values = [100.0] * 98 + [10_000.0, 100_000.0, float("nan"), -5.0,
                                 1e12, 0.0, 0.5]
    got, want = LatencyHistogram(), JLatencyHistogram()
    for v in values:
        got.record(v)
        want.record(v)
    assert got.snapshot() == want.snapshot()
    for p in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert got.percentile(p) == want.percentile(p), p
    assert got.num_buckets == want.num_buckets == 72
    assert LatencyHistogram().percentile(99) == 0.0
    with pytest.raises(ValueError):
        LatencyHistogram(lo_us=10.0, hi_us=1.0)


def test_telemetry_and_metrics_match_reference():
    class Stamped:
        def __init__(self, t0, t1, t2):
            self.t_enqueue, self.t_flush, self.t_complete = t0, t1, t2

    rng = np.random.default_rng(3)
    tels = (Telemetry(), JTelemetry())
    for i in range(40):
        t0 = float(i)
        t1 = t0 + rng.exponential(2e-3)
        r = Stamped(t0, t1, t1 + rng.exponential(5e-3))
        for tel in tels:
            tel.record_request(r, rows=7, failed=i % 9 == 0)
            if i % 4 == 0:
                tel.record_batch(4, ("size", "deadline", "drain")[i % 3])
            tel.observe_queue_depth(i % 5)
            tel.count("rejected")
    assert tels[0].snapshot() == tels[1].snapshot()
    assert tels[0].percentile("total", 99) == tels[1].percentile("total", 99)
    tels[0].reset()
    assert tels[0].snapshot()["counters"]["completed"] == 0
    regs = (obs.MetricsRegistry(), jobs.MetricsRegistry())
    for reg in regs:
        reg.count("a.b", 3)
        reg.gauge("g", 2.5)
        for us in (5.0, 50.0, 500.0):
            reg.observe_us("lat", us)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].counter_value("a.b") == 3
    assert regs[0].gauge_value("missing", 1.5) == 1.5
    regs[0].reset(["a.b"])
    assert regs[0].counters() == {} and regs[0].gauge_value("g") == 2.5


def test_runtime_request_spans(tmp_path):
    """Each settled request emits serve.request with serve.queue and
    serve.device children under the trace stamped at submit time, linked
    to its batch, whose serve.batch span holds the engine's spans; the
    JSONL sink writes them and a disabled tracer records nothing."""
    prev = obs.set_enabled(True)
    prev_sink = obs.default_tracer()._sink_dir
    obs.reset()
    obs.configure(sink_dir=str(tmp_path))
    try:
        g, x, server, _ = _server()
        with obs.trace("client") as client:
            with ServingRuntime(server, max_batch=2, max_delay_ms=5.0) as rt:
                for r in [rt.submit() for _ in range(4)]:
                    r.result(30)
        assert obs.current_context() is None
        spans = [sp.to_dict() for sp in obs.default_tracer().spans()]
        assert obs.default_tracer().flush() > 0
        on_disk = obs.load_trace_dir(str(tmp_path))
    finally:
        obs.default_tracer()._sink_dir = prev_sink
        obs.reset()
        obs.set_enabled(prev)
    assert len(on_disk) == len(spans)
    assert obs.validate_tree(spans)["well_formed"]
    trees = obs.build_trees(spans)
    roots = trees[client.trace_id]
    (client_node,) = [n for n in roots if n["record"]["name"] == "client"]
    requests = [c for c in client_node["children"]
                if c["record"]["name"] == "serve.request"]
    assert len(requests) == 4
    batches = {sp["trace_id"] for sp in spans if sp["name"] == "serve.batch"}
    for node in requests:
        assert {c["record"]["name"] for c in node["children"]} == \
            {"serve.queue", "serve.device"}
        assert node["record"]["attrs"]["batch"] in batches
    by_id = {sp["span_id"]: sp for sp in spans}
    runs = [sp for sp in spans if sp["name"] == "engine.run_batch"]
    assert runs and all(by_id[sp["parent_id"]]["name"] == "serve.batch"
                        for sp in runs)
    # the reference's decision log form: a zero-length span under the
    # current one, and a no-op span when collection is off
    prev = obs.set_enabled(True)
    obs.reset()
    try:
        with obs.trace("outer") as outer:
            sp = obs.decision("tune", width=8)
        assert sp.parent_id == outer.span_id and sp.t0 == sp.t1
        assert obs.snapshot()["counters"]["tune.decisions"] == 1
        obs.set_enabled(False)
        assert obs.decision("tune") is obs.NOOP_SPAN
        assert obs.record_span("x", 0.0, 1.0) is obs.NOOP_SPAN
        ctx = obs.request_context()
        assert ctx[1] is None and ctx[0].startswith("t")
    finally:
        obs.reset()
        obs.set_enabled(prev)


def test_export_matches_reference():
    """Perfetto JSON, span trees, the rendered summary and the tree check
    are pure functions of the records: the port's equal the reference's."""
    prev = obs.set_enabled(True)
    obs.reset()
    try:
        with obs.trace("root", k=1):
            with obs.trace("child"):
                pass
            obs.record_span("late", time.perf_counter(),
                            time.perf_counter(), parent_id="s-missing")
        with pytest.raises(KeyError):
            with obs.trace("failing"):
                raise KeyError("x")
        records = [sp.to_dict() for sp in obs.default_tracer().spans()]
        metrics = obs.snapshot()
    finally:
        obs.reset()
        obs.set_enabled(prev)
    doc = export.to_perfetto(records)
    assert doc == jexport.to_perfetto(records)
    assert [e["ph"] for e in doc["traceEvents"]] == ["X"] * 4
    assert export.build_trees(records) == jexport.build_trees(records)
    assert export.render_summary(records, metrics) == \
        jexport.render_summary(records, metrics)
    report = export.validate_tree(records)
    assert report == jexport.validate_tree(records)
    assert report["dangling_parents"] == 1 and not report["well_formed"]
    assert [r["status"] for r in records].count("error") == 1


def test_traffic_generators():
    np.testing.assert_array_equal(poisson_arrivals(100.0, 400, seed=3),
                                  jpoisson_arrivals(100.0, 400, seed=3))
    for bad in ((0.0, 10), (10.0, 0)):
        with pytest.raises(ValueError):
            poisson_arrivals(*bad)
    g, x, server, _ = _server()
    base = sync_baseline(server, iters=3, warmup=1)
    assert base["iters"] == 3 and base["mean_us"] > 0
    assert base["rps"] == pytest.approx(1e6 / base["mean_us"], rel=1e-2)
    with ServingRuntime(server, max_batch=8, max_delay_ms=3.0,
                        policy="block") as rt:
        res = run_open_loop(rt, rate_rps=400.0, num_requests=16, seed=0,
                            operand=lambda i: x * float(i % 2))
    assert res["submitted"] == res["completed"] == 16 and res["failed"] == 0
    assert res["rows_per_s"] == pytest.approx(
        res["achieved_rps"] * g.num_rows, rel=0.01)
    assert 0 < res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
    # an overloaded reject-policy runtime sheds instead of throttling
    rt = ServingRuntime(server, max_batch=4, max_delay_ms=60_000.0,
                        queue_depth=2, policy="reject")
    try:
        res = run_open_loop(rt, rate_rps=5000.0, num_requests=30, seed=1,
                            result_timeout=0.01)
        assert res["rejected"] > 0
        assert res["submitted"] + res["rejected"] == 30
    finally:
        rt.close()


@pytest.mark.parametrize("module", ["repro_torch.serving.server",
                                    "repro_torch.serving.runtime",
                                    "repro_torch.obs"])
def test_cli_smoke_on_the_cpu(module):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_PLAN_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-m", module, "--smoke", "--device", "cpu",
         "--json"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "smoke: OK"
    report = json.loads(lines[-2])
    assert report["device"] == "cpu"
    if module == "repro_torch.serving.server":
        assert report["parity_loop"] == report["parity_quant"] == "ok"
        assert report["parity_spmd"] == "ok"
        assert report["warm_disk_hits"] == 4
    elif module == "repro_torch.serving.runtime":
        assert report["parity_loop"] == report["parity_spmd"] == "ok"
        assert report["open_loop"]["achieved_rps"] > 0
    else:
        assert report["tree"]["well_formed"]
        assert report["request_traces"] == 6
