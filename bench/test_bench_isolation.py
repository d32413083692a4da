"""The benchmark stands apart: no module under ``bench/`` imports JAX,
Flax or the JAX package (top-level names compared whole: ``repro_torch``
begins with ``repro``), the plain reference imports nothing of the port,
and a run leaves none of them loaded."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_bench_module_imports_jax_or_the_jax_package():
    files = sorted(run.BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((run.BENCH / "reference").glob("*.py"))
    assert {f.stem for f in files} >= {"aes", "quant", "gcn", "graphsage"}
    for f in files:
        assert "repro_torch" not in _imports(f), f
        assert _imports(f) <= {"__future__", "importlib", "torch", "bench"}


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(run.ROOT)!r}, {str(run.ROOT / 'src')!r}]\n"
        "from bench import run\n"
        "from bench.conftest import small\n"
        "m = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "r = run.run_cell(m, 'gcn-reddit.aes-int8', 1, 0.2, True,\n"
        "                 torch.device('cpu'), config=small('gcn-reddit'),\n"
        "                 log=lambda *a, **k: None)\n"
        "assert r['correct'], r\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card (here) the command exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload",
         "gcn-reddit.aes-f32", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
