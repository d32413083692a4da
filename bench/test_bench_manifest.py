"""``BENCHMARK.json`` keeps to the benchmark's contract: keys, names and
units, files found by name, metrics that each cell reports, bounds and
the run length that fits a full check."""
from __future__ import annotations

import json
import re

from bench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for group in ("configs", "workloads"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_is_found_by_name(manifest):
    assert manifest["paths"] == ["bench"]
    assert manifest["command"] == ["python3", "bench/run.py"]
    used = {w["config"] for w in manifest["workloads"]}
    files = []
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (run.BENCH / "reference" / f"{cfg['model']}.py").exists()
        files.append(c["file"])
    assert len(files) == len(set(files))
    for w in manifest["workloads"]:
        assert (run.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        limits = run.load_json(run.BENCH / "limits" / f"{w['name']}.json")
        assert "logit_rel_err" in limits and set(limits) <= set(run.NUMBERS)
        assert all(c["lower"] < c["limit"] < c["upper"]
                   for c in limits.values())
    for m in manifest["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def test_each_cell_reports_what_its_metrics_move(manifest):
    cells = [w["name"] for w in manifest["workloads"]]

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items()
                   if n != "setup_s")
        assert any(reports(m, cell) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_length_and_chips_fit_a_full_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24   # what later PRs may grow the benchmark to
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
