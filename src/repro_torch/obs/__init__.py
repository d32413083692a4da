"""repro_torch.obs — process-wide tracing + metrics for the port.

The port's own copy of the reference package's ``obs``, with the same
names and the same span and counter names (``gnn.evaluate``,
``exec.run_{ell,block,plan,fused_layer}``, ``tune``, ``plan_cache.*``,
``engine.run_batch``, ``serve.{batch,request,queue,device}``,
``sampler.*``, ``executor.run_{ell,block}.<backend>.<dtype>``,
``quant.requant_*``)::

    from repro_torch import obs

    with obs.trace("gnn.evaluate", model="gcn") as sp:
        ...
    obs.count("sampler.edges_dropped", dropped)

Spans (``trace``/``traced``/``record_span``; the serving runtime emits
its per-request spans retrospectively from its completer thread) land in
a bounded ring on the process :class:`Tracer` and, with
``$REPRO_PLAN_CACHE_DIR`` set, a JSONL sink under ``<cache>/traces/``;
counters, gauges and histograms live in the process
:class:`MetricsRegistry`.  ``$REPRO_OBS=0`` disables collection.

CLI: ``python -m repro_torch.obs summary|export --perfetto out.json|--smoke``.

Stdlib only: every subsystem of the port imports it.
"""
from __future__ import annotations

import time

from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.export import (build_trees, load_trace_dir,
                                    load_trace_file, render_summary,
                                    to_perfetto, validate_tree,
                                    write_perfetto)
from repro_torch.obs.metrics import (LatencyHistogram, MetricsRegistry,
                                     default_registry)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer, configure,
                                   current_context, default_tracer, enabled,
                                   record_span, request_context, set_enabled,
                                   trace, traced)

__all__ = [
    "LatencyHistogram", "MetricsRegistry", "Span", "Tracer",
    "build_trees", "configure", "count", "current_context", "decision",
    "default_registry", "default_tracer", "enabled", "gauge",
    "load_trace_dir", "load_trace_file", "observe_us", "record_span",
    "render_summary", "request_context", "reset", "set_enabled",
    "snapshot", "to_perfetto", "trace", "traced", "validate_tree",
    "write_perfetto", "NOOP_SPAN",
]


def count(name: str, n: int = 1) -> None:
    """Increment a counter — no-op (one branch) when disabled."""
    if _trace_mod._enabled:
        default_registry().count(name, n)


def gauge(name: str, value: float) -> None:
    """Set a gauge — no-op when disabled."""
    if _trace_mod._enabled:
        default_registry().gauge(name, value)


def observe_us(name: str, us: float) -> None:
    """Record into a named latency histogram — no-op when disabled."""
    if _trace_mod._enabled:
        default_registry().observe_us(name, us)


def decision(name: str, **attrs):
    """One-line decision log: a zero-duration ``<name>.decision`` span
    carrying the chosen config as attributes (what the tuner picked and
    why), under the current span, plus a ``<name>.decisions`` counter.
    Returns the span (no-op when disabled)."""
    if not _trace_mod._enabled:
        return NOOP_SPAN
    now = time.perf_counter()
    default_registry().count(f"{name}.decisions")
    cur = current_context()
    return record_span(f"{name}.decision", now, now,
                       trace_id=cur[0] if cur else None,
                       parent_id=cur[1] if cur else None, **attrs)


def snapshot() -> dict:
    """JSON-able snapshot of every counter/gauge/histogram."""
    return default_registry().snapshot()


def reset() -> None:
    """Clear the span ring and the metrics registry (tests/smoke only —
    the sink file, if any, is left in place)."""
    default_tracer().reset()
    default_registry().reset()
