"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load neither
JAX nor any module of the JAX package (the optimizer, the configs, the
example modules, incremental plan maintenance, serving, the whole of
``obs``, the LM configs, models and serving driver included, and the LM
training substrate: ``data``, ``checkpoint``, ``runtime``,
``launch.train``, ``models.ssm``, ``models.xlstm``,
``examples.lm_train``, and the device mesh: ``launch.mesh``,
``launch.dryrun``, ``distributed.sharding``, ``distributed.mesh_compat``),
importing every module starts no process group and sets no environment
variable, the port's entry points default to the card
(and raise without one instead of running on the CPU: ``evaluate``,
``make_dataset``, ``train_model``, ``make_presampled_agg``,
``GNNServer``, the LM's ``init_params`` and ``serve``, also for the
pattern archs, ``launch.train.main``, and the command lines of
``repro_torch.exec``, ``tuning.autotune`` and ``tuning.calibration``), and
the smoke script refuses to report a result without a card or without the
repository around it."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

_PROBE = r"""
import importlib, os, pkgutil, sys
import numpy as np
import torch
import torch.distributed as dist
import repro_torch

environ = dict(os.environ)
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert not dist.is_initialized()
assert dict(os.environ) == environ, set(os.environ) ^ set(environ)
for name in ("repro_torch.optim.adamw", "repro_torch.configs.gnn_paper",
             "repro_torch.examples.quickstart",
             "repro_torch.examples.gnn_inference", "repro_torch.gnn.train",
             "repro_torch.tuning.incremental", "repro_torch.serving.engine",
             "repro_torch.serving.partition", "repro_torch.serving.plans",
             "repro_torch.serving.runtime", "repro_torch.serving.server",
             "repro_torch.serving.telemetry", "repro_torch.serving.traffic",
             "repro_torch.distributed.serving", "repro_torch.obs.export",
             "repro_torch.obs.__main__", "repro_torch.configs.base",
             "repro_torch.configs.qwen2_7b", "repro_torch.configs.zamba2_7b",
             "repro_torch.models.layers", "repro_torch.models.attention",
             "repro_torch.models.moe", "repro_torch.models.lm",
             "repro_torch.models.convert", "repro_torch.launch.serve",
             "repro_torch.examples.aes_kv_serving",
             "repro_torch.models.ssm", "repro_torch.models.xlstm",
             "repro_torch.optim.schedules",
             "repro_torch.optim.grad_compression",
             "repro_torch.data.pipeline",
             "repro_torch.checkpoint.checkpointer",
             "repro_torch.runtime.fault_tolerance",
             "repro_torch.launch.train", "repro_torch.examples.lm_train",
             "repro_torch.exec.__main__", "repro_torch.tuning.autotune",
             "repro_torch.tuning.calibration", "repro_torch.launch.mesh",
             "repro_torch.launch.dryrun", "repro_torch.distributed.sharding",
             "repro_torch.distributed.mesh_compat"):
    assert name in names, name
print("MODULES", len(names))

from repro_torch.gnn import (evaluate, init_gcn, make_dataset,
                             make_presampled_agg, train_model)
ds = make_dataset("cora", scale=0.01, device="cpu")
model = init_gcn(np.random.default_rng(0), 96, 8, 7, device="cpu")
if torch.cuda.is_available():
    print("EVALUATED_ON_CUDA", evaluate(ds, "gcn", model, sh_width=8))
else:
    try:
        evaluate(ds, "gcn", model, sh_width=8)
    except RuntimeError as exc:
        assert "cuda" in str(exc), exc
        print("RAISED_WITHOUT_CARD")
    else:
        raise AssertionError("evaluate() ran without a card")
    try:
        make_dataset("cora", scale=0.01)
    except RuntimeError:
        print("DATASET_RAISED_WITHOUT_CARD")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.dryrun import main as dryrun_main
    lm_cfg = smoke_config(get_config("qwen2-7b"))
    lm = init_params(lm_cfg, device="cpu")
    zamba = smoke_config(get_config("zamba2-7b"))
    xl = smoke_config(get_config("xlstm-350m"))
    xl_lm = init_params(xl, device="cpu")
    from repro_torch.serving import GNNServer
    from repro_torch.exec.__main__ import main as exec_cli
    from repro_torch.tuning.autotune import main as autotune_cli
    from repro_torch.tuning.calibration import main as calibration_cli
    for name, call in (
            ("TRAIN", lambda: train_model(ds, "gcn", hidden=8, epochs=1)),
            ("PRESAMPLED", lambda: make_presampled_agg(ds.gcn_adj, 8,
                                                       backend="cuda")),
            ("SERVER", lambda: GNNServer(ds.gcn_adj, ds.features)),
            ("LM_INIT", lambda: init_params(lm_cfg)),
            ("LM_SERVE", lambda: serve(lm_cfg, lm, np.ones((1, 4), np.int32),
                                       2)),
            ("PATTERN_INIT", lambda: init_params(zamba)),
            ("PATTERN_SERVE", lambda: serve(xl, xl_lm,
                                            np.ones((1, 4), np.int32), 2)),
            ("TRAIN_MAIN", lambda: train_main(["--smoke", "--steps", "1"])),
            ("DRYRUN", lambda: dryrun_main(["--arch", "tinyllama-1.1b",
                                            "--shape", "decode_32k"])),
            ("EXEC_CLI", lambda: exec_cli(["--smoke"])),
            ("AUTOTUNE_CLI", lambda: autotune_cli(["--smoke"])),
            ("CALIBRATION_CLI", lambda: calibration_cli(["--smoke"]))):
        try:
            call()
        except RuntimeError as exc:
            assert "cuda" in str(exc), exc
            print(name + "_RAISED_WITHOUT_CARD")
    assert not dist.is_initialized()
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **extra)
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_loads_no_jax_and_defaults_to_the_card():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 15
    if "EVALUATED_ON_CUDA" not in out.stdout:
        for what in ("", "DATASET_", "TRAIN_", "PRESAMPLED_", "SERVER_",
                     "LM_INIT_", "LM_SERVE_", "PATTERN_INIT_",
                     "PATTERN_SERVE_", "TRAIN_MAIN_", "DRYRUN_", "EXEC_CLI_",
                     "AUTOTUNE_CLI_", "CALIBRATION_CLI_"):
            assert what + "RAISED_WITHOUT_CARD" in out.stdout, what


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_no_import_of_jax_or_the_jax_package():
    """Every import in the port's sources, module level or inside a
    function, stays away from JAX and from ``repro``."""
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) >= 20
    bad = [(str(path.relative_to(REPO)), root, line) for path in paths
           for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "repro_torch" in out.stderr
