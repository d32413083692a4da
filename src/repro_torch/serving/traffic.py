"""Open-loop traffic generation for the serving runtime.

Throughput taken by hammering ``flush()`` back to back measures a *closed*
loop: the next request only arrives once the previous one finished.  Real
serving traffic is open — users do not wait for each other — and the
question is "at an offered load of R requests/s, what latency tail does
the system hold, and when does it start shedding?":

  * :func:`poisson_arrivals` — exponential inter-arrival times (a Poisson
    process);
  * :func:`run_open_loop` — replay an arrival schedule against a
    :class:`~repro_torch.serving.runtime.ServingRuntime`, submitting on
    schedule regardless of completions (with ``policy="reject"`` an
    overloaded runtime sheds, the generator never throttles), then drain
    and report achieved throughput + latency percentiles from the
    requests' own stamps;
  * :func:`sync_baseline` — the closed-loop comparator: sequential
    ``GNNServer`` submit+flush round trips, one request per pass, each
    waiting for the card.

``python -m repro_torch.serving.runtime --bench`` sweeps
:func:`run_open_loop` over a rate ladder.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["poisson_arrivals", "run_open_loop", "sync_baseline"]


def synchronize(outputs) -> None:
    """Wait until the card has computed ``outputs`` (a list of tensors):
    one synchronize of each CUDA device they lie on; nothing on the CPU."""
    for dev in {o.device for o in outputs if o.is_cuda}:
        torch.cuda.synchronize(dev)


def poisson_arrivals(rate_rps: float, num: int,
                     seed: int = 0) -> np.ndarray:
    """``num`` cumulative arrival offsets (seconds from start) of a
    Poisson process with mean rate ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=num)
    return np.cumsum(gaps)


def _percentiles_ms(lat_us: list[float]) -> dict:
    if not lat_us:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    arr = np.asarray(lat_us) / 1e3
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p95_ms": round(float(np.percentile(arr, 95)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def run_open_loop(runtime, *, rate_rps: float, num_requests: int,
                  operand: Optional[Callable[[int], object]] = None,
                  seed: int = 0, result_timeout: float = 120.0) -> dict:
    """Replay a Poisson arrival schedule against ``runtime``.

    Args:
      runtime: an open :class:`~repro_torch.serving.runtime.ServingRuntime`.
      rate_rps: offered load (mean arrival rate).
      num_requests: schedule length.
      operand: optional ``i -> x`` factory producing each request's dense
        operand (default: every request asks for the server's own cached
        feature matrix, ``x=None`` — the dedupe fast path).
      seed: arrival-schedule seed.
      result_timeout: per-request wait bound during the final drain.

    Returns a dict: offered/achieved rates, completion/rejection counts,
    latency percentiles over *completed* requests (total = enqueue to
    device-result), rows/s served, and the runtime's batch counters for
    the window.

    The submitting loop never waits on results; with the runtime's
    ``policy="reject"`` a saturated queue sheds load (counted in
    ``rejected``) instead of throttling the generator, so the offered
    rate is honored even past saturation.
    """
    from repro_torch.serving.runtime import BackpressureError

    schedule = poisson_arrivals(rate_rps, num_requests, seed=seed)
    batches_before = runtime.telemetry.counters["batches"]
    reqs, rejected = [], 0
    t0 = time.perf_counter()
    for i, at in enumerate(schedule):
        delay = t0 + float(at) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        x = operand(i) if operand is not None else None
        try:
            reqs.append(runtime.submit(x))
        except BackpressureError:
            rejected += 1
    for r in reqs:
        try:
            r.result(result_timeout)
        except Exception:  # noqa: BLE001 — counted below, not fatal here
            pass
    wall_s = time.perf_counter() - t0

    done = [r for r in reqs if r.ok()]
    lat_us = [r.latency_us()["total"] for r in done]
    rows = int(runtime.server.features.shape[0])
    out = {
        "offered_rps": round(rate_rps, 2),
        "submitted": len(reqs),
        "completed": len(done),
        "failed": len(reqs) - len(done),
        "rejected": rejected,
        "wall_s": round(wall_s, 4),
        "achieved_rps": round(len(done) / max(wall_s, 1e-9), 2),
        "rows_per_s": round(len(done) * rows / max(wall_s, 1e-9), 1),
        "batches": runtime.telemetry.counters["batches"] - batches_before,
    }
    out.update(_percentiles_ms(lat_us))
    return out


def sync_baseline(server, *, iters: int = 16, warmup: int = 2,
                  operand: Optional[Callable[[int], object]] = None) -> dict:
    """The per-request synchronous comparator: one ``submit()`` +
    ``flush()`` + host-blocking round trip per request, no overlap,
    no batching.  Returns mean/percentile latency and the closed-loop
    rate it implies (``rps`` = 1 / mean latency) — the load beyond which
    a synchronous server necessarily falls behind."""
    def one(i: int) -> float:
        x = operand(i) if operand is not None else None
        t0 = time.perf_counter()
        server.submit(x)
        synchronize(server.flush())
        return (time.perf_counter() - t0) * 1e6

    for i in range(warmup):
        one(i)
    lat_us = [one(i) for i in range(iters)]
    mean_us = float(np.mean(lat_us))
    out = {
        "iters": iters,
        "mean_us": round(mean_us, 1),
        "rps": round(1e6 / max(mean_us, 1e-9), 2),
    }
    out.update(_percentiles_ms(lat_us))
    return out
