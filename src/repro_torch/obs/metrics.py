"""Process-wide metrics: counters, gauges, latency histograms.

The port's own copy of the reference package's ``obs.metrics``: a flat,
thread-safe namespace of named metrics with a JSON-able ``snapshot()``.
Counters are monotonically increasing ints, gauges last-write-wins floats,
histograms the log-spaced :class:`LatencyHistogram` the serving telemetry
reads its percentiles from (same bucket edges as the reference, so the
same samples give the same percentiles).  Stdlib only.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable


class LatencyHistogram:
    """Fixed-memory latency histogram with log-spaced buckets.

    Buckets span ``[lo_us, hi_us)`` with ``per_decade`` buckets per decade
    (default: 1us .. 1000s at 8/decade = 72 buckets); underflow clamps into
    the first bucket, overflow into the last.  Percentiles are read back
    with log-linear interpolation inside the hit bucket (honest to within
    one bucket's ratio, ~33% at 8/decade); the exact min/max/mean are
    tracked separately.  Carries its own lock, so concurrent ``record()``
    is safe.
    """

    def __init__(self, lo_us: float = 1.0, hi_us: float = 1e9,
                 per_decade: int = 8):
        if not (0 < lo_us < hi_us):
            raise ValueError(f"need 0 < lo_us < hi_us, got {lo_us}, {hi_us}")
        self.lo_us = float(lo_us)
        self.hi_us = float(hi_us)
        decades = math.log10(hi_us / lo_us)
        self.num_buckets = max(int(math.ceil(decades * per_decade)), 1)
        self._log_lo = math.log10(lo_us)
        self._scale = self.num_buckets / decades   # buckets per log10 unit
        self.counts = [0] * self.num_buckets
        self.count = 0
        self.sum_us = 0.0
        self.min_us = math.inf
        self.max_us = 0.0
        self._mu = threading.Lock()

    def _bucket(self, us: float) -> int:
        if us <= self.lo_us:
            return 0
        idx = int((math.log10(us) - self._log_lo) * self._scale)
        return min(idx, self.num_buckets - 1)

    def _edges(self, idx: int) -> tuple:
        lo = 10.0 ** (self._log_lo + idx / self._scale)
        hi = 10.0 ** (self._log_lo + (idx + 1) / self._scale)
        return lo, hi

    def record(self, us: float) -> None:
        us = float(us)
        if not (us >= 0.0 and math.isfinite(us)):
            return
        with self._mu:
            self.counts[self._bucket(us)] += 1
            self.count += 1
            self.sum_us += us
            self.min_us = min(self.min_us, us)
            self.max_us = max(self.max_us, us)

    def _percentile_locked(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        target = max(min(p, 100.0), 0.0) / 100.0 * self.count
        seen = 0
        for idx, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                frac = (target - seen) / c
                lo, hi = self._edges(idx)
                us = 10.0 ** (math.log10(lo)
                              + frac * (math.log10(hi) - math.log10(lo)))
                return float(min(max(us, self.min_us), self.max_us))
            seen += c
        return float(self.max_us)

    def percentile(self, p: float) -> float:
        """The ``p``-th percentile (0..100) in microseconds, log-linearly
        interpolated inside the hit bucket and clamped to the observed
        min/max; 0.0 on an empty histogram."""
        with self._mu:
            return self._percentile_locked(p)

    @property
    def mean_us(self) -> float:
        with self._mu:
            return self.sum_us / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._mu:
            mean = self.sum_us / self.count if self.count else 0.0
            return {
                "count": self.count,
                "mean_us": round(mean, 1),
                "min_us": round(self.min_us, 1) if self.count else 0.0,
                "p50_us": round(self._percentile_locked(50), 1),
                "p95_us": round(self._percentile_locked(95), 1),
                "p99_us": round(self._percentile_locked(99), 1),
                "max_us": round(self.max_us, 1),
            }

    def reset(self) -> None:
        with self._mu:
            self.counts = [0] * self.num_buckets
            self.count = 0
            self.sum_us = 0.0
            self.min_us = math.inf
            self.max_us = 0.0


class MetricsRegistry:
    """Thread-safe flat namespace of counters / gauges / histograms."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, LatencyHistogram] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        with self._mu:
            self._gauges[name] = float(value)

    def histogram(self, name: str) -> LatencyHistogram:
        """Get-or-create a histogram (safe to call from any thread)."""
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            return h

    def observe_us(self, name: str, us: float) -> None:
        self.histogram(name).record(us)

    def counter_value(self, name: str) -> int:
        with self._mu:
            return self._counters.get(name, 0)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._mu:
            return self._gauges.get(name, default)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        with self._mu:
            return {k: v for k, v in sorted(self._counters.items())
                    if k.startswith(prefix)}

    def snapshot(self) -> dict:
        """JSON-able view of every metric."""
        with self._mu:
            counters = dict(sorted(self._counters.items()))
            gauges = dict(sorted(self._gauges.items()))
            hists = dict(sorted(self._hists.items()))
        # each histogram snapshot takes the histogram's own lock, never
        # nested inside the registry's
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.snapshot() for k, h in hists.items()}}

    def reset(self, names: Iterable[str] = ()) -> None:
        """Clear everything (or just the named metrics)."""
        with self._mu:
            if not names:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
                return
            for n in names:
                self._counters.pop(n, None)
                self._gauges.pop(n, None)
                self._hists.pop(n, None)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
