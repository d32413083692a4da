"""CLI over the port's observability layer.

    python -m repro_torch.obs summary                  # span trees + metrics
    python -m repro_torch.obs export --perfetto out.json
    python -m repro_torch.obs --smoke [--device cpu] [--json]

``summary``/``export`` read the JSONL trace files under
``$REPRO_PLAN_CACHE_DIR/traces`` (or ``--traces-dir``) — what a traced run
leaves behind.  ``--smoke`` runs a traced ``gnn.evaluate(strategy="auto")``
plus a ``ServingRuntime`` burst in-process on ``--device`` (default
``cuda``) and asserts: a well-formed span tree nesting tune -> cache ->
executor under ``gnn.evaluate``, per-request ``serve.request`` traces with
``serve.queue``/``serve.device`` children, non-zero sampler / cache /
executor counters, a Perfetto-loadable export, and zero records when
collection is disabled.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch import obs


def _traces_dir(args) -> str:
    if args.traces_dir:
        return args.traces_dir
    cache = os.environ.get("REPRO_PLAN_CACHE_DIR")
    if not cache:
        sys.exit("no trace source: pass --traces-dir or set "
                 "$REPRO_PLAN_CACHE_DIR (traces live under <cache>/traces)")
    return os.path.join(cache, "traces")


def _cmd_summary(args) -> None:
    records = obs.load_trace_dir(_traces_dir(args))
    if not records:
        print("no trace records")
        return
    print(obs.render_summary(records, obs.snapshot()))


def _cmd_export(args) -> None:
    if not args.perfetto:
        sys.exit("export needs --perfetto OUT.json")
    records = obs.load_trace_dir(_traces_dir(args))
    n = obs.write_perfetto(args.perfetto, records)
    print(f"wrote {n} trace events -> {args.perfetto}")


def _find(node: dict, name: str):
    if node["record"]["name"] == name:
        return node
    for c in node["children"]:
        hit = _find(c, name)
        if hit is not None:
            return hit
    return None


def _smoke(device, as_json: bool) -> dict:
    import numpy as np

    from repro_torch.gnn.datasets import make_dataset
    from repro_torch.gnn.infer import evaluate
    from repro_torch.gnn.models import MODELS
    from repro_torch.serving.engine import GNNServer
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.tuning.cost_model import CandidateConfig
    from repro_torch.tuning.plan_cache import PlanCache

    ds = make_dataset("cora", scale=0.05, seed=0, device=device)
    csr, feats = ds.gcn_adj, ds.features
    init, _, _ = MODELS["gcn"]
    params = init(np.random.default_rng(0), feats.shape[1], 16,
                  int(ds.labels.max()) + 1, device=device)
    backend = "cuda" if device.type == "cuda" else "torch"
    # W=4 AES-only grid: narrower than the max degree, so the sampler must
    # drop edges (the default grid's "full" candidate would win on a graph
    # this small and drop none).
    tune_kwargs = dict(grid=[CandidateConfig("aes", 4, backend)], budget=1,
                       warmup=0, iters=1)
    report: dict = {"device": str(device), "nodes": csr.num_rows,
                    "edges": csr.nnz}

    with tempfile.TemporaryDirectory() as tmp:
        obs.set_enabled(True)
        obs.reset()
        obs.configure(sink_dir=tmp)

        # -- enabled phase: traced evaluate + runtime burst ---------------
        evaluate(ds, "gcn", params, strategy="auto", plan_cache=PlanCache(),
                 tune_kwargs=tune_kwargs, device=device)
        w_full = max(int(csr.row_nnz().max()), 1)
        server = GNNServer(csr, feats, num_shards=2, cache=PlanCache(),
                           tune_kwargs=dict(widths=(w_full,),
                                            include_full=True,
                                            measure_plan=False,
                                            warmup=0, iters=1),
                           devices=[device])
        with ServingRuntime(server, max_batch=4, max_delay_ms=5.0) as rt:
            for r in [rt.submit() for _ in range(6)]:
                r.result(60)
            runtime_snap = rt.snapshot()

        flushed = obs.default_tracer().flush()
        records = obs.load_trace_dir(tmp)
        assert flushed > 0 and len(records) >= flushed, \
            f"JSONL sink empty ({flushed} flushed, {len(records)} read)"

        # span tree well-formedness (every parent resolves in its trace)
        tree_report = obs.validate_tree(records)
        assert tree_report["well_formed"], tree_report
        report["tree"] = tree_report

        # nesting: gnn.evaluate -> tune -> plan_cache.get, and the executor
        # under the same trace
        trees = obs.build_trees(records)
        ev = next((r for roots in trees.values() for r in roots
                   if r["record"]["name"] == "gnn.evaluate"), None)
        assert ev is not None, "no gnn.evaluate root span"
        tune_node = _find(ev, "tune")
        assert tune_node is not None and _find(tune_node, "plan_cache.get"), \
            "tune/plan_cache spans not nested under gnn.evaluate"
        assert _find(ev, "exec.run_plan"), "executor span not under evaluate"
        assert _find(ev, "tune.decision"), "no tuner decision log"

        # per-request traces: serve.request roots with queue+device
        # children, linked to their batch
        req_roots = [r for roots in trees.values() for r in roots
                     if r["record"]["name"] == "serve.request"]
        assert len(req_roots) == 6, \
            f"expected 6 request traces: {len(req_roots)}"
        for node in req_roots:
            kids = {c["record"]["name"] for c in node["children"]}
            assert kids == {"serve.queue", "serve.device"}, kids
            assert node["record"]["attrs"].get("batch"), "no batch link"
        report["request_traces"] = len(req_roots)

        # quality counters
        counters = obs.snapshot()["counters"]
        for key in ("sampler.edges_dropped", "sampler.edges_kept",
                    "plan_cache.hit_memory", "plan_cache.miss",
                    "tune.decisions"):
            assert counters.get(key, 0) > 0, f"counter {key} is zero"
        assert any(k.startswith("executor.") and v > 0
                   for k, v in counters.items()), "no executor path counters"
        assert runtime_snap["counters"]["completed"] == 6
        assert runtime_snap["counters"]["queue_depth"] == 0  # gauge decayed
        report["counters"] = {k: counters[k] for k in sorted(counters)
                              if k.startswith(("sampler.", "plan_cache.",
                                               "tune."))}

        # Perfetto export loads as trace_event JSON
        pf_path = os.path.join(tmp, "perfetto.json")
        obs.write_perfetto(pf_path, records)
        with open(pf_path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        events = doc.get("traceEvents")
        assert events and all(
            e["ph"] == "X" and e["dur"] >= 0 and "ts" in e and e["name"]
            for e in events), "malformed Perfetto export"
        report["perfetto_events"] = len(events)

        # -- disabled phase: $REPRO_OBS=0 semantics -----------------------
        obs.set_enabled(False)
        obs.reset()
        evaluate(ds, "gcn", params, strategy="auto", plan_cache=PlanCache(),
                 tune_kwargs=tune_kwargs, device=device)
        obs.default_tracer().flush()
        assert obs.default_tracer().recorded == 0, "spans recorded while off"
        assert obs.snapshot()["counters"] == {}, "counters bumped while off"
        report["disabled_records"] = 0
        obs.set_enabled(True)

    print(json.dumps(report, indent=None if as_json else 2, default=str))
    print("smoke: OK")
    return report


def main(argv=None) -> None:
    from repro_torch._device import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render, export, or smoke-test the port's traces and "
                    "metrics.")
    p.add_argument("command", nargs="?", choices=("summary", "export"),
                   help="summary: span trees + metrics; export: Perfetto")
    p.add_argument("--traces-dir", default=None,
                   help="trace JSONL dir (default: "
                        "$REPRO_PLAN_CACHE_DIR/traces)")
    p.add_argument("--perfetto", default=None, metavar="OUT.json",
                   help="output path for `export`")
    p.add_argument("--smoke", action="store_true",
                   help="traced end-to-end gate")
    p.add_argument("--device", default="cuda",
                   help="--smoke's device: cuda (default) or cpu")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if args.smoke:
        _smoke(resolve_device(args.device), args.json)
    elif args.command == "summary":
        _cmd_summary(args)
    elif args.command == "export":
        _cmd_export(args)
    else:
        p.error("pick a mode: summary | export --perfetto OUT | --smoke")


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # e.g. `summary | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
