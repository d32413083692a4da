"""Process-wide counters: the port's own copy of the counter half of the
reference package's ``obs.metrics.MetricsRegistry`` (no gauges or
histograms: nothing in this package records them yet)."""
from __future__ import annotations

import threading
from typing import Dict


class MetricsRegistry:
    """Thread-safe flat namespace of integer counters."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter_value(self, name: str) -> int:
        with self._mu:
            return self._counters.get(name, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        with self._mu:
            return {k: v for k, v in sorted(self._counters.items())
                    if k.startswith(prefix)}

    def reset(self) -> None:
        with self._mu:
            self._counters.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
