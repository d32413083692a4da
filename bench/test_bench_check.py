"""The output check decides ``correct`` as it should: sound runs of every
cell pass, the control (the reference one precision lower) fails, and so
does each fault planted in the timed path underneath the entry.  The
harness runs on the CPU at a small size, past its look for a card."""
from __future__ import annotations

import pytest
import torch

from bench import reference, run
from bench.conftest import small
from repro_torch.exec import executor
from repro_torch.gnn import models
from repro_torch.kernels import ops

CPU = torch.device("cpu")
CELLS = {"gcn-reddit.aes-f32": "gcn-reddit",
         "graphsage-ogbn-products.aes-f32": "graphsage-ogbn-products",
         "gcn-reddit.aes-int8": "gcn-reddit"}


def _run(manifest, cell, program=None, trace_on=False, seed=3):
    return run.run_cell(manifest, cell, seed, 0.3, trace_on, CPU,
                        config=small(CELLS[cell]), program=program,
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(manifest, cell):
    r = _run(manifest, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"requests_per_s", "latency_p95_ms",
                                 "setup_s"}
    assert list(r)[-1] == "checks"
    limits = run.load_json(run.BENCH / "limits" / f"{cell}.json")
    assert set(r["checks"]) == set(limits) | {"requests_failed"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(manifest):
    r = _run(manifest, "gcn-reddit.aes-f32", trace_on=True)
    per_layer = {m["name"] for m in manifest["per_layer"]}
    assert r["correct"] and set(r["metrics"]) <= per_layer
    assert "entry_host_ms" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _control(precision=None, bits=None):
    """The reference in the program's place, one precision lower."""
    def program(ds, model, module, *, quantize_bits=None, **_):
        params = {k: v.detach() for k, v in module.named_parameters()}
        cfg = {"model": model, "sh_width": 128}
        kw = ({"quant_bits": bits} if bits else
              {"quant_bits": quantize_bits, "precision": precision})
        adj = ds.gcn_adj if model == "gcn" else ds.sage_adj
        return reference.logits(cfg, adj.row_ptr, adj.col_ind, adj.val,
                                ds.features, params, **kw).float()
    return program


@pytest.mark.parametrize("cell,control", [
    ("gcn-reddit.aes-f32", _control(precision="tf32")),
    ("graphsage-ogbn-products.aes-f32", _control(precision="tf32")),
    ("gcn-reddit.aes-int8", _control(bits=4)),
    ("gcn-reddit.aes-int8", _control(precision="tf32"))])
def test_the_control_is_not_correct(manifest, cell, control):
    assert _run(manifest, cell, program=control)["correct"] is False


def _unchanged(monkeypatch):
    """Each aggregation returns its operand unchanged."""
    monkeypatch.setattr(executor.PlanExecutor, "run_ell",
                        lambda self, ell, features, **_: features)


def _half(monkeypatch):
    """Each row sums the first half of its live slots, scaled to their
    mean over the whole row."""
    orig = ops.ell_spmm

    def half(ell, b, live_w=None, *, quantized_meta=None):
        live = ell.live_widths() if live_w is None else live_w
        keep = (live + 1) // 2
        out = orig(ell, b, keep.to(torch.int32),
                   quantized_meta=quantized_meta)
        return out * (live / keep.clamp(min=1)).unsqueeze(1)

    monkeypatch.setattr(ops, "ell_spmm", half)


def _altered(monkeypatch):
    """One logit of every answer is off by a tenth of the largest one."""
    for cls in (models.GCN, models.GraphSAGE):
        orig = cls.forward

        def forward(self, *a, _orig=orig, **k):
            out = _orig(self, *a, **k)
            out[7, 3] += 0.1 * out.abs().max()
            return out

        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_in_the_timed_path_is_not_correct(manifest, monkeypatch,
                                                  cell, fault):
    fault(monkeypatch)
    r = _run(manifest, cell)
    assert r["correct"] is False
    assert r["checks"]["logit_rel_err"]["value"] > \
        r["checks"]["logit_rel_err"]["limit"]


def test_a_failing_request_is_counted_and_not_correct(manifest):
    """Requests that raise in the window count as failed; a warm-up that
    raises ends the run with no result."""
    from repro_torch.gnn.infer import infer_logits

    calls = []

    def every_other(*a, **k):
        calls.append(1)
        if len(calls) > 2 and len(calls) % 2:
            raise RuntimeError("planted")
        return infer_logits(*a, **k)

    r = _run(manifest, "gcn-reddit.aes-f32", program=every_other)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["requests_failed"]["value"] == r["failed"]

    def broken(*a, **k):
        raise RuntimeError("planted")

    with pytest.raises(RuntimeError, match="planted"):
        _run(manifest, "gcn-reddit.aes-f32", program=broken)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_calibration_readings_separate_program_and_control(manifest, cell):
    from bench import calibrate

    r = calibrate.readings(manifest, cell, 4, CPU, True,
                           config=small(CELLS[cell]))
    limits = run.load_json(run.BENCH / "limits" / f"{cell}.json")
    traffic = run.find_cell(manifest, cell)[0]["traffic"]
    bits = run.load_json(run.BENCH / "traffic" / f"{traffic}.json")[
        "quantize_bits"]
    assert set(r["controls"]) == set(calibrate.controls(bits))
    for each in [r["program_each"], *r["controls_each"].values()]:
        assert all(len(v) == 4 for v in each.values())
    # the program passes every number; each control fails one
    assert all(r["program"][n] <= c["limit"] for n, c in limits.items())
    for ctrl in r["controls"].values():
        assert any(ctrl[n] > c["limit"] for n, c in limits.items())
