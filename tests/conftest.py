"""Shared test fixtures: random CSR graphs with controlled degree skew.

Also installs a ``hypothesis`` shim when the real package is absent (it is
optional — see requirements-dev.txt): property-based tests then collect but
individually skip, instead of killing collection for the whole suite.
Environments that must run the property tests for real (CI does) set
``$REPRO_REQUIRE_HYPOTHESIS`` — a missing hypothesis is then a hard
collection error, never a silent skip.
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest

try:  # pragma: no cover - exercised only where hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    if os.environ.get("REPRO_REQUIRE_HYPOTHESIS"):
        raise RuntimeError(
            "hypothesis is not installed but $REPRO_REQUIRE_HYPOTHESIS is "
            "set — property tests would silently skip; install "
            "requirements-dev.txt") from None
    def _skip_given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements-dev.txt)"
            )(fn)
        return deco

    def _identity_settings(*_a, **_k):
        return lambda fn: fn

    class _AnyStrategy:
        """Stands in for any ``st.*`` strategy builder at decoration time."""

        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _AnyStrategy()  # type: ignore[attr-defined]

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _skip_given
    _hyp.settings = _identity_settings
    _hyp.strategies = _st
    _hyp.HealthCheck = _AnyStrategy()
    _hyp.assume = lambda *a, **k: True
    _hyp.note = lambda *a, **k: None

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

from repro.core.graph import CSR, csr_from_edges


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running subprocess/compile tests")
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel on the card; skips without one")


def random_csr(rng: np.random.Generator, num_nodes: int, avg_deg: float,
               skew: float = 1.0, weighted: bool = True) -> CSR:
    """Power-law-ish degree graph: deg_i ~ avg_deg * pareto(skew)."""
    raw = rng.pareto(skew, num_nodes) + 0.2 if skew else np.ones(num_nodes)
    deg = np.minimum((raw / raw.mean() * avg_deg).astype(np.int64), num_nodes * 4)
    src = (np.concatenate([rng.integers(0, num_nodes, d) for d in deg])
           if deg.sum() else np.zeros(0, np.int64))
    dst = np.repeat(np.arange(num_nodes), deg)
    val = rng.normal(size=len(src)).astype(np.float32) if weighted else None
    return csr_from_edges(src, dst, num_nodes, val)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_graph(rng):
    return random_csr(rng, 64, 6.0, skew=1.2)


@pytest.fixture(scope="session")
def skewed_graph(rng):
    """A few very heavy rows (exercises every strategy band)."""
    g = random_csr(rng, 96, 4.0, skew=0.7)
    return g
