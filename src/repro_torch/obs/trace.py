"""Structured spans for the port: ``trace()``/``@traced``, trace-ID
propagation, retrospective cross-thread spans, a bounded ring and a JSONL
sink.

The port's own copy of the reference package's ``obs.trace``, with the
same span model: a *span* is a named [t0, t1) interval with attributes, a
``trace_id`` shared by everything belonging to one logical operation (a
request, an ``evaluate`` call) and a ``parent_id`` linking it into a tree.
Within one thread the current (trace, span) pair propagates through a
``contextvars.ContextVar``; across threads (the serving runtime's batcher
and completer) callers stamp the context explicitly
(:func:`request_context`) and emit retrospective spans with
:func:`record_span`.

Finished spans land in a bounded ring on the process :class:`Tracer` and,
when ``$REPRO_PLAN_CACHE_DIR`` is set (or a sink dir is configured), are
appended as JSONL to ``<dir>/trace-<pid>.jsonl`` in small batches and at
interpreter exit.  ``python -m repro_torch.obs summary`` renders the tree;
``export --perfetto`` converts it to Chrome ``trace_event`` JSON.

``$REPRO_OBS=0`` (or ``set_enabled(False)``) makes :func:`trace` return a
shared no-op context manager and every helper an early-out, so a disabled
call site costs one branch.
"""
from __future__ import annotations

import atexit
import contextvars
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

ENV_ENABLED = "REPRO_OBS"
ENV_CACHE_DIR = "REPRO_PLAN_CACHE_DIR"

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


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None outside any."""
    return _ctx.get()


def request_context() -> Tuple[str, Optional[str]]:
    """Context to stamp on a cross-thread work item: the active
    (trace_id, span_id) when called under a span, else a fresh trace with
    no parent."""
    cur = _ctx.get()
    if cur is not None:
        return cur
    return _new_id("t"), None


class Span:
    """A finished or in-flight span; ``set()`` attaches attributes until
    its ``trace`` block exits."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "status", "attrs", "thread", "pid")

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
        self.thread = threading.get_ident()
        self.pid = os.getpid()

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_us(self) -> float:
        return (self.t1 - self.t0) * 1e6

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t0": self.t0, "t1": self.t1, "status": self.status,
                "thread": self.thread, "pid": self.pid, "attrs": self.attrs}


class _NoopSpan:
    """Shared do-nothing span + context manager for disabled mode."""

    __slots__ = ()
    name = trace_id = span_id = parent_id = None
    status = "ok"
    duration_us = 0.0

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


def record_span(name: str, t0: float, t1: float, *,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                status: str = "ok", **attrs):
    """Record a retrospective span from stored ``time.perf_counter()``
    stamps — the cross-thread path (serving requests carry their trace
    context on the ``RuntimeRequest``).  Returns the span (the no-op
    singleton when disabled) so callers can parent children."""
    if not _enabled:
        return NOOP_SPAN
    sp = Span(name, trace_id or _new_id("t"), parent_id, t0, attrs or None)
    sp.t1 = t1
    sp.status = status
    default_tracer().record(sp)
    return sp


class Tracer:
    """Bounded ring of finished spans + optional JSONL sink.

    The sink directory is ``sink_dir`` when given, else
    ``$REPRO_PLAN_CACHE_DIR/traces`` resolved at flush time.  Writes append
    to ``<dir>/trace-<pid>.jsonl`` in batches of ``flush_every`` records;
    :meth:`flush` and interpreter exit drain the rest.  Sink failures are
    swallowed: observability must never take the workload down."""

    def __init__(self, capacity: int = 4096,
                 sink_dir: Optional[str] = None, flush_every: int = 64):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._buffer: list = []
        self._sink_dir = sink_dir
        self._flush_every = max(1, int(flush_every))
        self.recorded = 0  # lifetime total, beyond the ring bound

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, span: Span) -> None:
        with self._mu:
            self._ring.append(span)
            self.recorded += 1
            self._buffer.append(span)
            need_flush = len(self._buffer) >= self._flush_every
        if need_flush:
            self.flush()

    def spans(self) -> list:
        with self._mu:
            return list(self._ring)

    def sink_path(self) -> Optional[str]:
        root = self._sink_dir
        if root is None:
            cache = os.environ.get(ENV_CACHE_DIR)
            if not cache:
                return None
            root = os.path.join(cache, "traces")
        return os.path.join(root, f"trace-{os.getpid()}.jsonl")

    def flush(self) -> int:
        """Drain buffered spans to the JSONL sink; returns lines written
        (0 when no sink is configured)."""
        with self._mu:
            batch, self._buffer = self._buffer, []
        if not batch:
            return 0
        path = self.sink_path()
        if path is None:
            return 0
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            lines = [json.dumps(sp.to_dict(), default=str,
                                separators=(",", ":")) for sp in batch]
            with open(path, "a", encoding="utf-8") as fh:
                fh.write("\n".join(lines) + "\n")
            return len(lines)
        except OSError:
            return 0

    def configure(self, *, capacity: Optional[int] = None,
                  sink_dir: Optional[str] = None,
                  flush_every: Optional[int] = None) -> "Tracer":
        with self._mu:
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=int(capacity))
            if sink_dir is not None:
                self._sink_dir = sink_dir
            if flush_every is not None:
                self._flush_every = max(1, int(flush_every))
        return self

    def reset(self) -> None:
        """Drop the ring and the unflushed buffer (tests/smoke)."""
        with self._mu:
            self._ring.clear()
            self._buffer.clear()
            self.recorded = 0


_TRACER = Tracer()
atexit.register(_TRACER.flush)


def default_tracer() -> Tracer:
    return _TRACER


def configure(**kw) -> Tracer:
    """Tune the process tracer: capacity / sink_dir / flush_every."""
    return _TRACER.configure(**kw)
