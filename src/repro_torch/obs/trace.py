"""Structured spans for the port: ``trace()`` with nesting through a
context variable, finished spans kept in a bounded ring.

The port's own copy of the span half of the reference package's
``obs.trace``: the same span model (name, trace id, parent id, attributes,
error status), without the JSONL sink and the retrospective cross-thread spans, which
nothing in this package emits yet.

``$REPRO_OBS=0`` (or ``set_enabled(False)``) makes :func:`trace` return a
shared no-op context manager, so a disabled call site costs one branch.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

ENV_ENABLED = "REPRO_OBS"

_FALSEY = {"0", "false", "off", "no", ""}

_enabled = os.environ.get(ENV_ENABLED, "1").strip().lower() not in _FALSEY


def enabled() -> bool:
    """True when tracing/metrics collection is on (default; $REPRO_OBS=0
    turns it off)."""
    return _enabled


def set_enabled(on: bool) -> bool:
    """Flip collection at runtime (tests, smoke); returns prior state."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


_ID_PREFIX = os.urandom(3).hex()
_ids = itertools.count(1)  # .__next__ is atomic in CPython


def _new_id(tag: str) -> str:
    return f"{tag}{_ID_PREFIX}{next(_ids):x}"


# (trace_id, span_id) of the innermost active span in this thread/task.
_ctx: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("repro_torch_obs_ctx", default=None)


class Span:
    """A finished or in-flight span; ``set()`` attaches attributes until
    its ``trace`` block exits."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "status", "attrs")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 t0: float, attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id("s")
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t0
        self.status = "ok"
        self.attrs = attrs or {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_us(self) -> float:
        return (self.t1 - self.t0) * 1e6


class _NoopSpan:
    """Shared do-nothing span + context manager for disabled mode."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class _ActiveSpan:
    """Pushes the context on enter; records the span on exit (error status
    on exception, which propagates)."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span):
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _ctx.set((self.span.trace_id, self.span.span_id))
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        sp.t1 = time.perf_counter()
        if exc_type is not None:
            sp.status = "error"
            sp.attrs.setdefault("error", exc_type.__name__)
        _ctx.reset(self._token)
        default_tracer().record(sp)
        return False


def trace(name: str, **attrs):
    """Open a span: ``with obs.trace("gnn.evaluate", model="gcn") as sp``.

    Spans opened inside the block (same thread) nest under it."""
    if not _enabled:
        return NOOP_SPAN
    cur = _ctx.get()
    trace_id, parent = (_new_id("t"), None) if cur is None else cur
    return _ActiveSpan(Span(name, trace_id, parent, time.perf_counter(),
                            attrs or None))


def traced(name: str, **attrs):
    """Decorator form of :func:`trace`: ``@traced("tune", k=v)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with trace(name, **attrs):
                return fn(*a, **kw)
        return wrapper
    return deco


class Tracer:
    """Bounded ring of finished spans."""

    def __init__(self, capacity: int = 4096):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)

    def record(self, span: Span) -> None:
        with self._mu:
            self._ring.append(span)

    def spans(self) -> list:
        with self._mu:
            return list(self._ring)

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()


_TRACER = Tracer()


def default_tracer() -> Tracer:
    return _TRACER
