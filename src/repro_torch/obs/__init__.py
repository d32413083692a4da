"""repro_torch.obs — spans and counters for the port.

The port's own copy of the part of the reference package's ``obs`` that
this package calls, with the same span and counter names
(``gnn.evaluate``, ``exec.run_ell``, ``exec.run_block``, ``exec.run_plan``,
``tune``, ``plan_cache.*``, ``sampler.*``,
``executor.run_{ell,block}.<backend>.<dtype>``, ``quant.requant_*``)::

    from repro_torch import obs

    with obs.trace("gnn.evaluate", model="gcn") as sp:
        ...
    obs.count("sampler.edges_dropped", dropped)

Stdlib only.  ``$REPRO_OBS=0`` disables collection.
"""
from __future__ import annotations

from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer, default_tracer,
                                   enabled, set_enabled, trace, traced)

__all__ = ["MetricsRegistry", "NOOP_SPAN", "Span", "Tracer", "count",
           "decision", "default_registry", "default_tracer", "enabled",
           "reset", "set_enabled", "trace", "traced"]


def count(name: str, n: int = 1) -> None:
    """Increment a counter — no-op (one branch) when disabled."""
    if _trace_mod._enabled:
        default_registry().count(name, n)


def decision(name: str, **attrs):
    """One-line decision log: a ``<name>.decision`` span carrying the chosen
    config as attributes (what the tuner picked and why), plus a
    ``<name>.decisions`` counter.  Returns the span (no-op when disabled)."""
    if not _trace_mod._enabled:
        return NOOP_SPAN
    default_registry().count(f"{name}.decisions")
    with trace(f"{name}.decision", **attrs) as sp:
        return sp


def reset() -> None:
    """Clear the span ring and every counter (tests/smoke only)."""
    default_tracer().reset()
    default_registry().reset()
