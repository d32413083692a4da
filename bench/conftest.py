"""Fixtures of the benchmark's tests: a small configuration of each model
(the published widths but for the features, a few thousand nodes) that the
harness runs on the CPU in about a second."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel on the card; skips without one")


def small(name: str, nodes: int = 3000, edges: int = 80000,
          features: int = 24) -> dict:
    """Configuration ``name`` cut to a CPU test's size."""
    from bench import run

    cfg = run.load_json(ROOT / "bench" / "configs" / f"{name}.json")
    cfg.update(nodes=nodes, edges=edges, features=features)
    return cfg


@pytest.fixture
def manifest() -> dict:
    from bench import run

    return run.load_json(ROOT / "BENCHMARK.json")
