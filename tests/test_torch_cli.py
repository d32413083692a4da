"""The port's command lines against the JAX package's, on the CPU:

  * ``python -m repro_torch.exec --smoke``: passes with the reference's
    report keys; ``_random_csr`` is bit-equal for the same seed, and the
    port's fused 2-layer output is within 1e-4 of the reference's unfused
    ``jax`` pipeline on the same graph and draws (the reference's own smoke
    reaches a Pallas kernel, which fails at trace time on the installed
    jax, so its unfused half is rebuilt here);
  * ``python -m repro_torch.tuning.autotune --smoke`` in the graph, block
    (natural and degree-sorted) and ``--shards 2`` branches: the
    reference's keys, cache hits, and the analytic fields (nodes, edges,
    block configs, buckets, per-shard widths) equal; ``--calibrate``
    without a cache directory exits, with one it logs records;
  * ``synthetic_records(30)`` bit-equal, the calibration smoke's report
    equal, and ``fit``/``show``/``clear``/``compact`` on the same log
    records giving the reference's reports;
  * ``table2_stats`` equal for every dataset.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.aes_spmm import sample as jsample
from repro.exec import default_executor as jdefault_executor
from repro.exec.__main__ import _random_csr as j_random_csr
from repro.gnn.datasets import SYNTHETIC_DATASETS as J_DATASETS
from repro.gnn.datasets import table2_stats as j_table2_stats
from repro.tuning import autotune as jautotune
from repro.tuning import calibration as jcalibration
from repro_torch.exec import __main__ as exec_main
from repro_torch.gnn import SYNTHETIC_DATASETS, table2_stats
from repro_torch.tuning import autotune, calibration

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
#: the reference's exec smoke report (src/repro/exec/__main__.py)
EXEC_KEYS = {"nodes", "feat", "width", "float_max_err", "quant_max_err",
             "drift_guard_err"}


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_exec_random_csr_is_the_reference_graph():
    for seed, nodes, deg in ((0, 96, 5.0), (3, 40, 2.5)):
        got = exec_main._random_csr(np.random.default_rng(seed), nodes, deg,
                                    "cpu")
        want = j_random_csr(np.random.default_rng(seed), nodes, deg)
        for f in ("row_ptr", "col_ind", "val"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert got.num_cols == want.num_cols


def test_exec_smoke_passes_with_the_reference_keys(capsys):
    exec_main.main(["--smoke", "--json"] + CPU)
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "smoke: OK"
    report = _json_lines(out)[0]
    assert set(report) == EXEC_KEYS
    assert report["float_max_err"] < 1e-3 and report["quant_max_err"] < 1e-3
    assert report["drift_guard_err"] == 0.0

    # the port's fused layers against the reference's unfused jax pipeline,
    # on the smoke's graph and draws
    from repro_torch.core.aes_spmm import sample
    from repro_torch.exec import default_executor

    def draws(rng, nodes=96, feat=24, hidden=12, out_dim=7):
        return [rng.normal(size=s).astype(np.float32) for s in
                ((nodes, feat), (feat, hidden), (hidden,), (hidden, out_dim),
                 (out_dim,))]

    rng = np.random.default_rng(0)
    g = j_random_csr(rng, 96, 5.0)
    x, w1, b1, w2, b2 = draws(rng)
    jex, jell = jdefault_executor(), jsample(g, 8, "aes")
    h = jnp.maximum(jex.run_ell(jell, jnp.asarray(x)) @ w1 + b1, 0.0)
    want = np.asarray(jex.run_ell(jell, h) @ w2 + b2)

    rng = np.random.default_rng(0)
    csr = exec_main._random_csr(rng, 96, 5.0, "cpu")
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in draws(rng))
    ex, ell = default_executor(), sample(csr, 8, "aes", backend="cuda")
    h = ex.run_fused_layer(ell, x, w1, b1, relu=True, backend="cuda")
    got = ex.run_fused_layer(ell, h, w2, b2, relu=False, backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("branch", [[], ["--granularity", "block"],
                                    ["--granularity", "block", "--layout",
                                     "degree_sorted"],
                                    ["--shards", "2"]],
                         ids=["graph", "block", "block-degree-sorted",
                              "shards"])
def test_autotune_smoke_branches_match_the_reference(monkeypatch, capsys,
                                                      branch):
    monkeypatch.delenv("REPRO_PLAN_CACHE_DIR", raising=False)
    jautotune.main(["--smoke", "--json"] + branch)
    want = _json_lines(capsys.readouterr().out)[0]
    autotune.main(["--smoke", "--json"] + branch + CPU)
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "smoke: OK"
    got = _json_lines(out)[0]
    assert set(got) == set(want)
    for key in ("dataset", "nodes", "edges", "layout", "block_rows",
                "num_blocks", "block_configs", "width_buckets", "quant_bits",
                "live_edges", "shards", "cache_stats", "calibration"):
        assert got.get(key) == want.get(key), key
    if "per_shard" in want:
        for a, b in zip(got["per_shard"], want["per_shard"]):
            assert {k: a[k] for k in ("shard", "rows", "halo", "widths")} \
                == {k: b[k] for k in ("shard", "rows", "halo", "widths")}
    if not branch:
        assert got["cache_stats"] == {"hits": 1, "misses": 1}
        assert got["calibration"] == "off"


def test_autotune_calibrate_flag(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("REPRO_PLAN_CACHE_DIR", raising=False)
    with pytest.raises(SystemExit):
        autotune.main(["--smoke", "--calibrate"] + CPU)
    try:
        autotune.main(["--smoke", "--json", "--cache-dir", str(tmp_path),
                       "--calibrate"] + CPU)
    finally:
        calibration.reset_default_log()
    report = _json_lines(capsys.readouterr().out)[0]
    assert report["calibration"]["records"] > 0
    assert calibration.calibration_dir(tmp_path).is_dir()
    assert not (tmp_path / "calibration").exists()   # the reference's log


def test_synthetic_records_are_bit_equal():
    """Every number bit-equal; the config's backend is the port's name of
    the reference's eager backend ("jax" -> "torch")."""
    for num, seed in ((30, 0), (7, 3)):
        got = calibration.synthetic_records(num, seed)
        want = jcalibration.synthetic_records(num, seed)
        assert len(got) == len(want) == 2 * num
        for r in want:
            assert r["config"]["backend"] == "jax"
            r["config"]["backend"] = "torch"
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)


def test_calibration_smoke_equals_the_reference(capsys):
    jcalibration.main(["--smoke", "--json"])
    want = capsys.readouterr().out
    calibration.main(["--smoke", "--json"] + CPU)
    got = capsys.readouterr().out
    assert got == want and got.splitlines()[-1] == "smoke: OK"


def test_calibration_fit_show_clear_compact(tmp_path, capsys):
    """Each command on a port log and a reference log holding the same
    records (host "h"): the same reports, paths aside."""
    records = calibration.synthetic_records(30, seed=9, host="h")
    roots = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
    logs = {"port": calibration.CalibrationLog(
                calibration.calibration_dir(roots["port"])),
            "ref": jcalibration.CalibrationLog(
                jcalibration.calibration_dir(roots["ref"]))}
    for log in logs.values():
        for r in records:
            log.append(r)
    mains = {"port": lambda a: calibration.main(a + CPU),
             "ref": jcalibration.main}

    def run(cmd, *extra):
        out = {}
        for side in ("port", "ref"):
            mains[side]([cmd, "--cache-dir", str(roots[side]), "--host",
                         "h", "--json", *extra])
            out[side] = json.loads(capsys.readouterr().out.splitlines()[0])
            out[side].pop("path", None)
        return out

    fit = run("fit")
    assert fit["port"] == fit["ref"]
    assert fit["port"]["latency_records"] == 30
    show = run("show")
    assert show["port"] == show["ref"] and show["port"]["active"] is True
    compact = run("compact", "--max-records", "8")
    assert compact["port"] == compact["ref"]
    assert compact["port"]["kept"] == 8
    assert len(logs["port"].records("h")) == 8
    clear = run("clear")
    assert clear["port"] == clear["ref"] == {"cleared_files": 1}
    assert logs["port"].records("h") == []
    with pytest.raises(SystemExit):
        calibration.main(["fit", "--cache-dir", str(roots["port"]), "--host",
                          "h"] + CPU)


def test_calibration_cli_requires_a_log_location(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE_DIR", raising=False)
    with pytest.raises(SystemExit):
        calibration.main(["show"] + CPU)


def test_table2_stats_equal_for_every_dataset():
    assert sorted(SYNTHETIC_DATASETS) == sorted(J_DATASETS)
    for name in J_DATASETS:
        got, want = table2_stats(name), j_table2_stats(name)
        assert got == want and type(got["edges"]) is int, name
