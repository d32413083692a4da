"""Per-request latency telemetry for the serving runtime.

The runtime (``repro_torch.serving.runtime``) stamps every request at
enqueue, flush (batch dispatch) and complete, and hands the finished
request here.  This module turns those stamps into what a serving operator
watches:

  * stage histograms — ``queue`` (enqueue -> flush: how long admission
    control and the size-or-deadline batcher held the request), ``device``
    (flush -> complete: dispatch + on-device time for the request's
    batch), ``total`` (enqueue -> complete);
  * tail percentiles (p50/p95/p99) per stage, read from log-spaced bucket
    histograms (``repro_torch.obs.metrics.LatencyHistogram``, re-exported
    here);
  * counters — submitted / completed / failed / rejected requests,
    batches flushed (split by size- vs deadline- vs drain-triggered),
    rows served, queue high-water mark and live depth.

Everything is thread-safe (the batcher, completer and submitting threads
all report concurrently).  ``Telemetry.snapshot()`` is the export surface,
a plain JSON-able dict.
"""
from __future__ import annotations

import threading

# LatencyHistogram lives in the shared observability layer; re-exported
# here, as the reference package does.
from repro_torch.obs.metrics import LatencyHistogram

__all__ = ["LatencyHistogram", "Telemetry"]


#: The per-request stages every completed request records, as
#: (name, start-stamp attr, end-stamp attr) on a runtime request.
STAGES = (
    ("queue", "t_enqueue", "t_flush"),
    ("device", "t_flush", "t_complete"),
    ("total", "t_enqueue", "t_complete"),
)


class Telemetry:
    """Aggregated serving-runtime telemetry: stage histograms + counters.

    One instance per :class:`~repro_torch.serving.runtime.ServingRuntime` by
    default; pass a shared instance to aggregate several runtimes.  All
    methods are thread-safe.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self.stages = {name: LatencyHistogram() for name, _, _ in STAGES}
        self.counters = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "batches": 0, "batches_size": 0, "batches_deadline": 0,
            "batches_drain": 0, "batch_requests": 0, "rows_served": 0,
            "queue_peak": 0, "queue_depth": 0,
        }

    # -- recording -------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._mu:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe_queue_depth(self, depth: int) -> None:
        """Track the live queue: ``queue_depth`` is the current value (a
        gauge — it decays as batches drain, unlike the high-water
        ``queue_peak``)."""
        with self._mu:
            self.counters["queue_depth"] = depth
            if depth > self.counters["queue_peak"]:
                self.counters["queue_peak"] = depth

    def record_batch(self, size: int, trigger: str) -> None:
        """One flushed batch; ``trigger`` is ``size``/``deadline``/``drain``."""
        with self._mu:
            self.counters["batches"] += 1
            self.counters["batch_requests"] += size
            key = f"batches_{trigger}"
            self.counters[key] = self.counters.get(key, 0) + 1

    def record_request(self, request, rows: int = 0,
                       failed: bool = False) -> None:
        """Fold one settled request's stamps into the histograms.

        Failed requests record their stage latencies too (a timed-out or
        crashed batch is exactly the tail an operator needs to see) —
        they bump ``failed`` instead of ``completed``/``rows_served``.
        """
        with self._mu:
            if failed:
                self.counters["failed"] += 1
            else:
                self.counters["completed"] += 1
                self.counters["rows_served"] += int(rows)
            for name, start, end in STAGES:
                t0 = getattr(request, start, None)
                t1 = getattr(request, end, None)
                if t0 is not None and t1 is not None:
                    self.stages[name].record((t1 - t0) * 1e6)

    # -- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: counters + per-stage latency percentiles."""
        with self._mu:
            batches = self.counters["batches"]
            out = {
                "counters": dict(self.counters),
                "mean_batch_size": round(
                    self.counters["batch_requests"] / batches, 2)
                if batches else 0.0,
                "latency": {name: hist.snapshot()
                            for name, hist in self.stages.items()},
            }
        return out

    def percentile(self, stage: str, p: float) -> float:
        with self._mu:
            return self.stages[stage].percentile(p)

    def reset(self) -> None:
        with self._mu:
            self.stages = {name: LatencyHistogram() for name, _, _ in STAGES}
            for k in self.counters:
                self.counters[k] = 0
