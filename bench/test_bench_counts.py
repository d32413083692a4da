"""The yardstick's arithmetic on hand-worked cases: bytes, operations and
least times, the trace reduction, and every per-layer reader."""
from __future__ import annotations

import pytest

from bench import counts, reference, run, trace

PEAK = {"bytes_per_s": 1000.0, "flops_f32": 100.0}


def test_aggregation_bytes_and_operations():
    # row lengths 4 * 11, live entries 8 * 30, the operand 10 * 4 * 4 once,
    # the output 4 * 10 * 4 once
    assert counts.agg_bytes(10, 30, 4, 4) == 44 + 240 + 160 + 160
    # uint8 operand: 10 * 4 bytes and 8 bytes of Eq. 2 constants
    assert counts.agg_bytes(10, 30, 4, 1) == 44 + 240 + 40 + 8 + 160
    assert counts.agg_flops(30, 4) == 240
    assert counts.gemm_flops(10, 4, 2) == 160
    assert counts.least_s(604, 240, PEAK) == 2.4        # operation-bound
    assert counts.least_s(604, 24, PEAK) == 0.604       # byte-bound


def test_forward_counts_of_a_small_gcn(monkeypatch):
    cfg = {"nodes": 10, "features": 4, "hidden": 2, "classes": 3}
    gcn = reference.model("gcn")
    monkeypatch.setitem(counts.PEAKS, "toy", PEAK)
    c = counts.forward_counts(gcn, cfg, 30, None, "toy card")
    # aggregations 2*30*4 + 2*30*2, transforms 2*10*4*2 + 2*10*2*3
    assert c["model_flops"] == 240 + 120 + 160 + 120
    least = (max(604 / 1000, 240 / 100)
             + max(counts.agg_bytes(10, 30, 2, 4) / 1000, 120 / 100))
    assert c["agg_least_s"] == pytest.approx(least)
    sage = counts.forward_counts(reference.model("graphsage"), cfg, 30, 8,
                                 "toy card")
    assert sage["model_flops"] == 240 + 120 + 2 * 160 + 2 * 120
    assert counts.forward_counts(gcn, cfg, 30, None, "cpu")[
        "agg_least_s"] is None


def test_peaks_of_the_h100():
    assert counts.peak("NVIDIA H100 80GB HBM3") == {
        "bytes_per_s": 3.35e12, "flops_f32": 67e12}
    assert counts.peak("cpu") is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _x(trace.REQUEST, "user_annotation", 0, 100),
    _x(trace.REQUEST, "user_annotation", 110, 90),
    _x("void ell_spmm_kernel<float>(float const*)", "kernel", 10, 30),
    _x("void ell_spmm_kernel<float>(float const*)", "kernel", 30, 30),
    _x("aes_sample_kernel<4>", "kernel", 120, 30),
    _x("Memcpy DtoH", "gpu_memcpy", 150, 10),
    _x(trace.REQUEST, "gpu_user_annotation", 0, 200),
    _x("aten::mm", "cpu_op", 60, 30),
    _x("before the span", "kernel", -50, 20),
]}


def test_trace_reduction():
    tr = trace.parse(TRACE)
    assert tr["requests"] == 2
    assert tr["span"] == pytest.approx((0.0, 200e-6))
    assert trace.busy_s(tr) == pytest.approx(90e-6)     # [10, 60] + [120, 160]
    gaps = trace.idle_gaps(tr, 2)
    assert gaps[0][0] == "aten::mm" and gaps[0][1] == pytest.approx(60e-6)
    assert gaps[1][0] == trace.REQUEST and gaps[1][1] == pytest.approx(40e-6)
    ops = trace.device_ops(tr)
    assert ops[0][0].startswith("void ell_spmm") \
        and ops[0][1] == pytest.approx(60e-6)
    own = trace.own_kernel_s(tr, ["ell_spmm_kernel", "aes_sample_kernel"])
    assert own == pytest.approx(90e-6)
    assert trace.own_kernel_s(tr, ["spmm_kernel"]) == 0.0   # whole words
    assert trace.parse({"traceEvents": []})["requests"] == 0


def test_kernel_names_come_from_the_sources():
    names = trace.kernel_names(run.ROOT / "src" / "repro_torch" / "kernels"
                               / "csrc")
    assert {"aes_sample_kernel", "ell_spmm_kernel", "block_ell_spmm_kernel",
            "dequant_kernel", "fused_layer_kernel",
            "fused_aes_spmm_kernel"} <= set(names)


def test_every_reader_on_a_hand_worked_run():
    tr = trace.parse(TRACE)
    r = {"requests": 4, "window_s": 2.0, "host_s": [0.1, 0.3],
         "launches": {"ell_spmm": 8, "aes_sample": 8}, "trace": tr,
         "counts": {"agg_least_s": 9e-6, "model_flops": 50.0, "peak": PEAK},
         "own_kernels": ["ell_spmm_kernel", "aes_sample_kernel"]}
    read = {m: run.load_reader(m)(r) for m in (
        "entry_host_ms", "launches_per_request", "spmm_roofline",
        "step_mfu_pct", "device_idle_pct")}
    assert read["entry_host_ms"] == pytest.approx(200.0)
    assert read["launches_per_request"] == 4.0
    # own kernels 90 us over 2 traced requests: 45 us a request
    assert read["spmm_roofline"] == pytest.approx(100 * 9 / 45)
    # 50 operations a request over 0.5 s a request at 100 operations/s
    assert read["step_mfu_pct"] == pytest.approx(100.0)
    # busy 90 us over 2 traced requests, 45 us a request, against the
    # window's 0.5 s a request: idle all but 45 us of it
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 45e-6 / 0.5))
    # the traced span's own idle share (110 us of 200, 55%) is not the
    # reading: a window of 90 us a request reads 1 - 45 / 90
    fast = dict(r, window_s=4 * 90e-6)
    assert run.load_reader("device_idle_pct")(fast) == pytest.approx(50.0)
    silent = dict(r, trace=None, counts={"agg_least_s": None,
                                         "model_flops": 50.0, "peak": None})
    assert run.load_reader("spmm_roofline")(silent) is None
    assert run.load_reader("device_idle_pct")(silent) is None
    assert run.load_reader("step_mfu_pct")(silent) is None
