"""The command on the card: one cell for a few seconds, the last line's
keys, and no result from a directory that holds only the benchmark.
Skips without a card (decided in a fixture, not at import)."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench import run

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _command(cwd, trace: int):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gcn-reddit.aes-f32",
         "--seed", str(2**31 + 77), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=cwd)


@pytest.mark.parametrize("trace", [0, 1])
def test_one_cell_prints_the_contract_line(card, trace):
    out = _command(run.ROOT, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0 and "H100" in dev["kind"]
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    want = manifest["per_layer"] if trace else manifest["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        roof = line["metrics"]["spmm_roofline"]["value"]
        assert 0 < roof <= 100


def test_the_benchmark_alone_prints_no_result(card, tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, 0)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
