"""Async continuous-batching request loop over :class:`GNNServer`.

``GNNServer.submit()/flush()`` is a *synchronous* micro-batcher: the
caller decides when to flush, host and device work never overlap across
batches, and nothing bounds how long a request waits.  This module is the
serving layer above it:

  request threads ──► bounded queue ──► batcher thread ──► completer
      submit()         (backpressure:     size-or-deadline    thread
      returns a         block or           flush; dispatches   waits on
      future            reject when        ``run_batch`` on    the batch's
                        full)              its own CUDA        CUDA event,
                                           stream, records     fulfils
                                           an event            futures

* **Continuous micro-batching** — the batcher flushes as soon as
  ``max_batch`` requests are pending *or* the oldest pending request has
  waited ``max_delay_ms``, whichever comes first.  New requests keep
  being admitted while previous batches are on the card.
* **Host/device overlap** — ``GNNServer.run_batch`` only enqueues work.
  The batcher enqueues it on a stream of its own (one per card the server
  uses; the current stream is per thread, so the kernels launch there)
  after that stream waits for the default stream, where the submitters
  made their operands; then it records a CUDA event.  The completer
  thread waits for the event (``Event.synchronize`` releases the
  interpreter lock while it waits).  A two-slot pipeline semaphore lets
  the batcher gather and dispatch batch ``N+1`` while the completer still
  waits for batch ``N``.  On the CPU the work runs inside ``run_batch``
  and there is no event.
* **Backpressure** — the pending queue is bounded (``queue_depth``); a
  full queue either blocks the submitter (``policy="block"``) or raises
  :class:`BackpressureError` (``policy="reject"``, the open-loop traffic
  choice — drops are counted, the loop stays open).  ``close()``
  gracefully drains everything already admitted.
* **Telemetry** — every request is stamped at enqueue/flush/complete and
  folded into :class:`~repro_torch.serving.telemetry.Telemetry`
  histograms (p50/p95/p99 per stage) plus batch/queue counters; with obs
  on, each settled request emits a ``serve.request`` span with
  ``serve.queue`` and ``serve.device`` children under the trace stamped
  at submit time.

CLI::

    python -m repro_torch.serving.runtime --smoke [--device cpu]
    python -m repro_torch.serving.runtime --bench [--device cpu]

Drive it under realistic arrivals with
``repro_torch.serving.traffic.run_open_loop`` (Poisson open loop).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.serving.telemetry import Telemetry

__all__ = ["BackpressureError", "RuntimeRequest", "ServingRuntime"]


class BackpressureError(RuntimeError):
    """The bounded request queue is full and the policy rejects (or a
    blocking submit timed out waiting for space)."""


class RuntimeRequest:
    """A submitted request: a future plus its latency stamps.

    Stamps (``time.perf_counter`` seconds, ``None`` until reached):
    ``t_enqueue`` (admitted to the queue), ``t_flush`` (its batch was
    dispatched), ``t_complete`` (device result ready, future fulfilled).

    ``trace_ctx`` is the (trace_id, parent_span_id) stamped at submit
    time — the submitting thread's active ``repro_torch.obs`` span if any,
    else a fresh trace — so the request's queue/device spans, emitted
    retrospectively from the completer thread, nest under one trace.
    """

    __slots__ = ("x", "t_enqueue", "t_flush", "t_complete", "batch_size",
                 "trace_ctx", "_batch_trace", "_event", "_result", "_error")

    def __init__(self, x, t_enqueue: float):
        self.x = x
        self.t_enqueue = t_enqueue
        self.t_flush: Optional[float] = None
        self.t_complete: Optional[float] = None
        self.batch_size = 0
        self.trace_ctx = None
        self._batch_trace: Optional[str] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    # -- future API ------------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def ok(self) -> bool:
        return self._event.is_set() and self._error is None

    def result(self, timeout: Optional[float] = None):
        """The ``[num_rows, F]`` aggregation result; blocks until the
        request's batch completes.  Re-raises the batch's failure."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not complete after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def latency_us(self) -> dict:
        """Per-stage latency in microseconds (``None`` stages omitted)."""
        out = {}
        if self.t_flush is not None:
            out["queue"] = (self.t_flush - self.t_enqueue) * 1e6
        if self.t_complete is not None:
            if self.t_flush is not None:
                out["device"] = (self.t_complete - self.t_flush) * 1e6
            out["total"] = (self.t_complete - self.t_enqueue) * 1e6
        return out

    # -- runtime-internal ------------------------------------------------

    def _finish(self, value, now: float) -> None:
        self._result = value
        self.t_complete = now
        self._event.set()

    def _fail(self, err: BaseException, now: float) -> None:
        self._error = err
        self.t_complete = now
        self._event.set()


class ServingRuntime:
    """Continuous-batching async front end over a :class:`GNNServer`.

    Args:
      server: the engine to dispatch on.  The runtime *owns* the server's
        execution path once started — do not call ``server.submit()`` /
        ``server.flush()`` concurrently (one-shot setup calls before
        construction are fine).
      max_batch: flush as soon as this many requests are pending.
      max_delay_ms: flush when the oldest pending request has waited this
        long, even if the batch is not full — the latency target.
      queue_depth: bound on admitted-but-unflushed requests; beyond it
        backpressure applies.
      policy: ``"block"`` (submit waits for space — closed-loop callers)
        or ``"reject"`` (submit raises :class:`BackpressureError` — open
        loops count the drop and move on).
      pipeline_depth: batches allowed in flight on the card at once
        (default 2: one being awaited + one dispatched behind it).
      telemetry: share a :class:`Telemetry` across runtimes; default is a
        private one, exported via :meth:`snapshot`.

    Use as a context manager or call :meth:`close` — the batcher and
    completer are daemon threads, but only ``close()`` guarantees every
    admitted request was served.
    """

    def __init__(self, server, *, max_batch: int = 32,
                 max_delay_ms: float = 5.0, queue_depth: int = 128,
                 policy: str = "block", pipeline_depth: int = 2,
                 telemetry: Optional[Telemetry] = None):
        if policy not in ("block", "reject"):
            raise ValueError(f"unknown policy {policy!r} "
                             "(expected 'block' or 'reject')")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.server = server
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.policy = policy
        self.telemetry = telemetry if telemetry is not None else Telemetry()

        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._idle = threading.Condition(self._mu)
        self._pending: deque[RuntimeRequest] = deque()
        self._outstanding = 0          # admitted, not yet completed/failed
        self._closing = False          # batcher drains then exits
        self._closed = False           # submit() refuses

        # Two-slot device pipeline: the batcher acquires a slot before
        # dispatching, the completer releases it once the batch's results
        # are ready — so at most `pipeline_depth` batches are dispatched
        # but not yet complete, and the batcher assembles the next batch
        # while the previous one is still on the card.
        self._slots = threading.BoundedSemaphore(int(pipeline_depth))
        self._inflight: deque = deque()
        self._inflight_ready = threading.Condition()
        # the batcher's stream on every card the server runs on
        cards = {d for d in (server.device, *server._devices)
                 if d.type == "cuda"}
        self._streams = {d: torch.cuda.Stream(d) for d in cards}

        self._rows = int(server.features.shape[0])
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serving-batcher", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="serving-completer", daemon=True)
        self._batcher.start()
        self._completer.start()

    # -- submission ------------------------------------------------------

    def submit(self, x=None, timeout: Optional[float] = None
               ) -> RuntimeRequest:
        """Admit one request; returns its future.

        ``x=None`` requests the aggregation of the server's own (cached,
        possibly quantized) feature matrix; a dense ``[num_nodes, F]``
        matrix takes the float path.  Validation (shape/dtype/closed)
        happens here, at enqueue time — see ``GNNServer.validate_operand``.
        """
        x = self.server.validate_operand(x)
        with self._mu:
            if self._closed:
                raise ValueError("runtime is closed")
            if len(self._pending) >= self.queue_depth:
                if self.policy == "reject":
                    self.telemetry.counters["rejected"] += 1  # under _mu
                    raise BackpressureError(
                        f"queue full ({self.queue_depth} pending)")
                deadline = None if timeout is None \
                    else time.perf_counter() + timeout
                while len(self._pending) >= self.queue_depth:
                    remaining = None if deadline is None \
                        else deadline - time.perf_counter()
                    if remaining is not None and remaining <= 0:
                        self.telemetry.counters["rejected"] += 1
                        raise BackpressureError(
                            f"queue still full after {timeout}s")
                    if self._closed:
                        raise ValueError("runtime is closed")
                    self._not_full.wait(remaining)
                if self._closed:
                    raise ValueError("runtime is closed")
            req = RuntimeRequest(x, time.perf_counter())
            if obs.enabled():
                req.trace_ctx = obs.request_context()
            self._pending.append(req)
            self._outstanding += 1
            self.telemetry.counters["submitted"] += 1
            depth = len(self._pending)
            self.telemetry.counters["queue_depth"] = depth
            if depth > self.telemetry.counters["queue_peak"]:
                self.telemetry.counters["queue_peak"] = depth
            self._not_empty.notify()
        return req

    def aggregate(self, x=None, timeout: Optional[float] = None):
        """One-shot convenience: submit + wait for the result."""
        return self.submit(x).result(timeout)

    # -- lifecycle -------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has completed (or failed);
        returns False on timeout.  The runtime stays open."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._mu:
            while self._outstanding > 0:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admissions, drain every in-flight and pending request,
        and join the worker threads.  Idempotent."""
        with self._mu:
            if self._closed and not self._batcher.is_alive():
                return
            self._closed = True
            self._closing = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        self._batcher.join(timeout)
        self._completer.join(timeout)

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def snapshot(self) -> dict:
        """Telemetry export plus live queue state, merged with the
        process-wide ``repro_torch.obs`` metrics snapshot (executor
        dispatch cells, sampler/cache/quantization counters) — one dict,
        so a scrape of the runtime sees the whole stack it drives."""
        out = self.telemetry.snapshot()
        with self._mu:
            out["pending"] = len(self._pending)
            out["outstanding"] = self._outstanding
            out["closed"] = self._closed
        out["obs"] = obs.snapshot()
        return out

    # -- worker loops ----------------------------------------------------

    def _take_batch(self) -> tuple[list[RuntimeRequest], str]:
        """Block until a batch is due; returns (requests, trigger) with
        trigger in {"size", "deadline", "drain"} — or ([], "") when the
        runtime is closing and the queue is empty."""
        with self._mu:
            while not self._pending and not self._closing:
                self._not_empty.wait()
            if not self._pending:
                return [], ""
            # Size-or-deadline: wait for a full batch, but never past the
            # oldest request's deadline.  close() short-circuits the wait.
            head = self._pending[0]
            deadline = head.t_enqueue + self.max_delay_s
            trigger = "deadline"
            while (len(self._pending) < self.max_batch
                   and not self._closing):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            if self._closing and len(self._pending) < self.max_batch:
                trigger = "drain"
            elif len(self._pending) >= self.max_batch:
                trigger = "size"
            batch = [self._pending.popleft()
                     for _ in range(min(self.max_batch, len(self._pending)))]
            self.telemetry.counters["queue_depth"] = len(self._pending)
            self._not_full.notify_all()
        return batch, trigger

    def _dispatch(self, batch: list[RuntimeRequest]) -> tuple[list, list]:
        """``run_batch`` on the batcher's streams; returns (outputs, one
        recorded event per stream — none on the CPU)."""
        with contextlib.ExitStack() as on_streams:
            for dev, stream in self._streams.items():
                on_streams.enter_context(torch.cuda.stream(stream))
                # operands were made on the default stream by submitters
                stream.wait_stream(torch.cuda.default_stream(dev))
            for r in batch:
                if isinstance(r.x, torch.Tensor) and r.x.is_cuda:
                    r.x.record_stream(self._streams[r.x.device])
            outs = self.server.run_batch([r.x for r in batch])
            events = []
            for stream in self._streams.values():
                events.append(torch.cuda.Event())
                events[-1].record(stream)
        return outs, events

    def _batch_loop(self) -> None:
        while True:
            batch, trigger = self._take_batch()
            if not batch:
                break
            self._slots.acquire()      # two-slot pipeline gate
            now = time.perf_counter()
            for r in batch:
                r.t_flush = now
                r.batch_size = len(batch)
            self.telemetry.record_batch(len(batch), trigger)
            try:
                # The batch span lives in the batcher thread, so engine /
                # executor spans opened inside run_batch nest under it;
                # each request links to it via its `batch` attribute.
                with obs.trace("serve.batch", trigger=trigger,
                               size=len(batch)) as bsp:
                    for r in batch:
                        r._batch_trace = bsp.trace_id
                    outs, events = self._dispatch(batch)
            except BaseException as e:  # noqa: BLE001 — forwarded to futures
                self._slots.release()
                self._settle(batch, error=e)
                continue
            with self._inflight_ready:
                self._inflight.append((batch, outs, events))
                self._inflight_ready.notify()
        # Closing: wake the completer with a sentinel once the queue is
        # drained — every admitted batch is already in _inflight.
        with self._inflight_ready:
            self._inflight.append(None)
            self._inflight_ready.notify()

    def _complete_loop(self) -> None:
        while True:
            with self._inflight_ready:
                while not self._inflight:
                    self._inflight_ready.wait()
                item = self._inflight.popleft()
            if item is None:
                break
            batch, outs, events = item
            try:
                for ev in events:
                    ev.synchronize()
            except BaseException as e:  # noqa: BLE001
                self._slots.release()
                self._settle(batch, error=e)
                continue
            self._slots.release()
            self._settle(batch, outs=outs)

    def _settle(self, batch, outs=None, error=None) -> None:
        now = time.perf_counter()
        failed = error is not None
        if failed:
            for r in batch:
                r._fail(error, now)
                self.telemetry.record_request(r, failed=True)
        else:
            for r, o in zip(batch, outs):
                r._finish(o, now)
                self.telemetry.record_request(r, rows=self._rows)
        if obs.enabled():
            for r in batch:
                self._emit_request_spans(r, failed)
        with self._mu:
            self._outstanding -= len(batch)
            if self._outstanding == 0:
                self._idle.notify_all()

    def _emit_request_spans(self, r: RuntimeRequest, failed: bool) -> None:
        """Retrospective spans for one settled request, under the trace
        stamped at submit(): serve.request wrapping serve.queue (enqueue
        -> flush) and serve.device (flush -> complete)."""
        ctx = r.trace_ctx
        if ctx is None or r.t_complete is None:
            return
        trace_id, parent = ctx
        status = "error" if failed else "ok"
        root = obs.record_span(
            "serve.request", r.t_enqueue, r.t_complete,
            trace_id=trace_id, parent_id=parent, status=status,
            batch_size=r.batch_size, batch=r._batch_trace)
        if r.t_flush is not None:
            obs.record_span("serve.queue", r.t_enqueue, r.t_flush,
                            trace_id=trace_id, parent_id=root.span_id)
            obs.record_span("serve.device", r.t_flush, r.t_complete,
                            trace_id=trace_id, parent_id=root.span_id,
                            status=status)


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.serving.runtime --smoke | --bench
# ---------------------------------------------------------------------------

def _to_numpy(t):
    return t.detach().cpu().numpy()


def _exact_tune_kwargs(csr) -> dict:
    """Tuning knobs under which no candidate truncates an edge, so the
    float engine must match the exact SpMM (the machinery under test is
    the batcher/pipeline, not sampling loss)."""
    w_full = max(int(csr.row_nnz().max()), 1)
    return dict(widths=(w_full,), include_full=True, measure_plan=False,
                warmup=0, iters=1)


def _build_server(args, tune_kwargs=None, quant=None):
    from repro_torch.gnn.datasets import make_dataset
    from repro_torch.serving.engine import GNNServer
    from repro_torch.tuning.plan_cache import PlanCache

    ds = make_dataset(args.dataset, scale=args.scale, seed=args.seed,
                      device=args.device)
    csr, feats = ds.gcn_adj, ds.features
    if tune_kwargs is None:
        tune_kwargs = dict(measure_plan=False)
    server = GNNServer(csr, feats, num_shards=args.shards, mode=args.mode,
                       quant=quant, cache=PlanCache(),
                       tune_kwargs=tune_kwargs, devices=[args.device])
    return ds, csr, feats, server


def _smoke(args) -> dict:
    """Gate: batching correctness (runtime == synchronous flush() == the
    ref oracle), deadline + size flush triggers, graceful drain, and
    nonzero open-loop throughput; loop and spmd mode."""
    import json

    import numpy as np

    from repro_torch.gnn.datasets import make_dataset
    from repro_torch.kernels import ref
    from repro_torch.serving.engine import GNNServer
    from repro_torch.serving.traffic import run_open_loop
    from repro_torch.tuning.plan_cache import PlanCache

    dev = torch.device(args.device)
    ds = make_dataset("cora", scale=0.08, seed=0, device=dev)
    csr, feats = ds.gcn_adj, ds.features
    tk = _exact_tune_kwargs(csr)
    want = _to_numpy(ref.csr_spmm(csr.row_ptr, csr.col_ind, csr.val, feats))

    report: dict = {"device": str(dev), "shards": args.shards,
                    "nodes": csr.num_rows, "edges": csr.nnz,
                    "modes": ["loop", "spmd"]}
    for mode in report["modes"]:
        server = GNNServer(csr, feats, num_shards=args.shards, mode=mode,
                           cache=PlanCache(), tune_kwargs=tk, devices=[dev])
        # synchronous flush() results are the pinned baseline
        t0, t1 = server.submit(), server.submit(feats * 2.0)
        sync = [_to_numpy(r) for r in server.flush()]
        np.testing.assert_allclose(sync[t0], want, rtol=1e-5, atol=1e-5)

        with ServingRuntime(server, max_batch=4, max_delay_ms=10.0) as rt:
            # deadline flush: fewer requests than max_batch, no further
            # submissions — only the deadline can flush these
            r_none = rt.submit()
            r_x2 = rt.submit(feats * 2.0)
            np.testing.assert_allclose(_to_numpy(r_none.result(60)),
                                       sync[t0], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(_to_numpy(r_x2.result(60)),
                                       sync[t1], rtol=1e-6, atol=1e-6)
            # size flush under burst: 8 requests, max_batch=4
            burst = [rt.submit() for _ in range(8)]
            for r in burst:
                np.testing.assert_allclose(_to_numpy(r.result(60)), want,
                                           rtol=1e-5, atol=1e-5)
            snap = rt.snapshot()
        assert snap["counters"]["batches_deadline"] >= 1, snap["counters"]
        assert snap["counters"]["batches_size"] >= 2, snap["counters"]
        assert snap["counters"]["completed"] == 10
        report[f"parity_{mode}"] = "ok"
        report[f"batches_{mode}"] = snap["counters"]["batches"]

    # nonzero-throughput sanity: a short open-loop Poisson run
    server = GNNServer(csr, feats, num_shards=args.shards, cache=PlanCache(),
                       tune_kwargs=tk, devices=[dev])
    with ServingRuntime(server, max_batch=8, max_delay_ms=5.0,
                        policy="block") as rt:
        res = run_open_loop(rt, rate_rps=200.0, num_requests=32, seed=0)
    assert res["completed"] == 32 and res["rejected"] == 0, res
    assert res["achieved_rps"] > 0 and res["rows_per_s"] > 0, res
    report["open_loop"] = {k: res[k] for k in
                           ("offered_rps", "achieved_rps", "rows_per_s",
                            "p50_ms", "p99_ms")}

    print(json.dumps(report, indent=None if args.json else 2))
    print("smoke: OK")
    return report


def _bench(args) -> dict:
    """Offered-load sweep: continuous-batching runtime vs per-request
    synchronous ``flush()`` at each rate."""
    import json

    from repro_torch.serving.traffic import run_open_loop, sync_baseline

    _, csr, _, server = _build_server(args)
    base = sync_baseline(server, iters=args.requests // 2 or 8)
    rates = [base["rps"] * rx for rx in (0.5, 1.0, 2.0, 4.0)]
    sweep = []
    for rate in rates:
        rt = ServingRuntime(server, max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            queue_depth=args.queue_depth, policy="reject")
        try:
            sweep.append(run_open_loop(rt, rate_rps=rate,
                                       num_requests=args.requests,
                                       seed=args.seed))
        finally:
            rt.close()
    report = {
        "dataset": args.dataset, "nodes": csr.num_rows, "edges": csr.nnz,
        "device": str(server.device), "shards": server.num_shards,
        "mode": server.mode, "max_batch": args.max_batch,
        "max_delay_ms": args.max_delay_ms,
        "sync_baseline": base,
        "sweep": sweep,
    }
    print(json.dumps(report, indent=None if args.json else 2))
    return report


def main(argv=None) -> None:
    import argparse

    from repro_torch._device import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.runtime",
        description="Async continuous-batching serving runtime over the "
                    "sharded GNNServer engine.")
    p.add_argument("--dataset", default="cora")
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--mode", choices=("loop", "spmd"), default="loop")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--queue-depth", type=int, default=256)
    p.add_argument("--requests", type=int, default=48,
                   help="open-loop requests per swept rate (--bench)")
    p.add_argument("--smoke", action="store_true",
                   help="batching correctness + throughput gate")
    p.add_argument("--bench", action="store_true",
                   help="offered-load sweep vs synchronous flush()")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.smoke:
        _smoke(args)
    elif args.bench:
        _bench(args)
    else:
        p.error("pick a mode: --smoke or --bench")


if __name__ == "__main__":
    main()
