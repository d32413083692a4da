"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``bench/configs/<file>``, its plain reference ``bench/reference/<model>.py``)
under a traffic mix (``bench/traffic/<traffic>.json``: the entry's
``strategy`` and ``quantize_bits``), with the limits of its output check
in ``bench/limits/<cell>.json``.  A run

  1. draws the graph, a pool of feature matrices and the weights on the
     card from ``--seed`` (``bench/gen.py``) and logs the realized graph;
  2. warms up with the first :data:`WARMUP_REQUESTS` requests;
  3. runs the window: a closed loop with one client, request ``i`` a
     full-graph inference through ``repro_torch.gnn.infer.infer_logits``
     with the port's CUDA kernels on pool entry ``i mod`` :data:`POOL`,
     each timed from its call to its ``torch.cuda.synchronize()``, for
     ``--seconds``;
  4. with ``--trace 1``, profiles :data:`TRACE_REQUESTS` further requests
     of the same loop;
  5. reads the peak device memory, then compares a seeded sample of the
     window's outputs with the plain reference;
  6. prints the cell's metrics as one JSON line, last on standard output,
     after the numbers compared beside their limits on standard error.

It exits non-zero, printing no result, without enough CUDA cards, and if
JAX, Flax or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level module names that may not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The entry's kernel backend in every cell: the port's CUDA kernels.
BACKEND = "cuda"
#: Feature matrices a run draws; request ``i`` serves entry ``i mod POOL``.
POOL = 4
#: Requests of the cell's own shapes served before the window.
WARMUP_REQUESTS = 2
#: Window requests, drawn from the seed, checked against the reference.
CHECKED_REQUESTS = 4
#: Requests profiled after the window in a ``--trace 1`` run.
TRACE_REQUESTS = 10


def _since_process_start() -> float:
    """Seconds from this process's start to ``_T0``'s reading, from
    ``/proc`` (0.0 where it cannot be read)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text()
                          .rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        ago = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(ago - (time.perf_counter() - _T0), 0.0)


def _setup_env() -> None:
    """Kernel caches at fixed places inside the checkout, and the
    checkout's ``src`` and root on the import path."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _steps(marks: dict) -> dict:
    """Seconds of each set-up step: process start to the first mark, then
    mark to mark, in the order ``marks`` took them (host clock)."""
    out, prev = {}, _T0 - _since_process_start()
    for name, t in marks.items():
        out[name] = t - prev
        prev = t
    return out


def _host_ms() -> float:
    """The host's time for a fixed loop of Python, in ms: how fast the
    host runs right now, logged so that a run whose host path was slow
    shows why (a one-chip machine shares its host's cores)."""
    t = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def find_cell(manifest: dict, name: str) -> tuple:
    """``(cell, config entry)`` of workload ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def load_reader(name: str):
    """The reader of per-layer metric ``name``: ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_module(model: str, params: dict, device):
    """The program's model of ``model`` holding ``params``."""
    import numpy as np
    import torch

    from repro_torch.gnn.models import MODELS

    cls = MODELS[model][1]
    module = cls(**{k: np.zeros(tuple(v.shape), np.float32)
                    for k, v in params.items()}).to(device)
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(v)
    return module


class Prepared(NamedTuple):
    """A cell's inputs on the device, and the program's model over them."""

    cfg: dict
    mix: dict
    ref_model: object
    graph: object
    pool: list
    params: dict
    module: object
    ds: object


def prepare(cfg: dict, mix: dict, seed: int, device, log=None) -> Prepared:
    """Draw the graph, the feature pool and the weights of ``cfg`` for
    ``seed`` on ``device`` and build the program's model and dataset."""
    import torch

    from bench import gen, reference
    from repro_torch.core.graph import CSR
    from repro_torch.gnn.datasets import DatasetSpec, GraphDataset

    ref_model = reference.model(cfg["model"])
    graph = gen.make_graph(cfg, seed, device, self_loops=ref_model.SELF_LOOPS,
                           norm=ref_model.NORM)
    if log:
        log(json.dumps({"graph": cfg["name"], "seed": seed, **graph.stats}))
    n = int(cfg["nodes"])
    pool = gen.make_features(cfg, graph.labels, seed, POOL, device)
    params = gen.make_params(ref_model.shapes(cfg), seed, cfg["name"], device)
    module = _build_module(cfg["model"], params, device)
    csr = CSR(graph.row_ptr, graph.col, graph.val, n)
    spec = DatasetSpec(cfg["name"], n, graph.edges / n,
                       float(cfg["degree_sigma"]), int(cfg["classes"]),
                       int(cfg["features"]), large=True)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    ds = GraphDataset(spec, csr, csr, csr, pool[0], graph.labels, mask, mask)
    return Prepared(cfg, mix, ref_model, graph, pool, params, module, ds)


def serve(p: Prepared, program, i: int):
    """Request ``i``: one full-graph inference by ``program`` (the entry
    ``infer_logits``'s signature) on pool entry ``i mod pool``."""
    return program(p.ds._replace(features=p.pool[i % len(p.pool)]),
                   p.cfg["model"], p.module, sh_width=int(p.cfg["sh_width"]),
                   strategy=p.mix["strategy"], backend=BACKEND,
                   quantize_bits=p.mix["quantize_bits"],
                   device=p.ds.features.device)


def reference_logits(p: Prepared, i: int, **kw):
    """The plain reference's logits for pool entry ``i``."""
    from bench import reference

    g = p.graph
    kw.setdefault("quant_bits", p.mix["quantize_bits"])
    return reference.logits(p.cfg, g.row_ptr, g.col, g.val, p.pool[i],
                            p.params, **kw)


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             trace_on: bool, device, *, config=None, program=None,
             log=print, marks=None) -> dict:
    """One run of cell ``cell_name`` on ``device``; the result's dict.

    ``config`` replaces the configuration file's contents and ``program``
    the entry ``infer_logits`` (the tests run the harness on the CPU at a
    small size, and with faults planted in the timed path); ``marks``
    holds the caller's set-up steps for the log.
    """
    import torch

    from bench import counts, trace
    from bench.reference import aes
    from repro_torch.gnn.infer import infer_logits
    from repro_torch.kernels import ops

    cell, centry = find_cell(manifest, cell_name)
    cfg = config or load_json(ROOT / centry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell_name}.json")
    program = program or infer_logits
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)

    # --- set-up: data, weights, the program's model, warm-up ------------
    marks = dict(marks or {}, imports=time.perf_counter())
    p = prepare(cfg, mix, seed, device, log)
    _sync(torch, device)
    marks["data"] = time.perf_counter()
    nnz = (p.graph.row_ptr[1:] - p.graph.row_ptr[:-1]).long()
    live = int(aes.live_slots(nnz, int(cfg["sh_width"])).sum())
    cnt = counts.forward_counts(p.ref_model, cfg, live, mix["quantize_bits"],
                                kind)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(WARMUP_REQUESTS):
        serve(p, program, i)
    _sync(torch, device)
    marks["warmup"] = time.perf_counter()
    log(json.dumps({"setup_s_by_step": _steps(marks),
                    "host_loop_ms": _host_ms()}))

    # --- the window -----------------------------------------------------
    keep = CHECKED_REQUESTS
    rng = random.Random(seed)
    kept, lat, host = [], [], []
    failed = attempted = done = 0
    before = ops.launch_counts()
    t_start = time.perf_counter()
    setup_s = _since_process_start() + (t_start - _T0)
    t_end = t_start
    while t_end - t_start < seconds:
        i = attempted
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = serve(p, program, i)
            t1 = time.perf_counter()
            _sync(torch, device)
        except Exception:  # a request that fails counts, and the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        host.append(t1 - t0)
        # reservoir sample of the completed requests, drawn from the seed
        if done < keep:
            kept.append((i, out))
        else:
            j = rng.randrange(done + 1)
            if j < keep:
                kept[j] = (i, out)
        done += 1
        del out
    window_s = t_end - t_start
    if lat:
        tenth = [sorted(lat[k * len(lat) // 10:(k + 1) * len(lat) // 10]
                        or lat) for k in range(10)]
        log(json.dumps({"latency_ms_median_by_tenth": [
            1e3 * t[len(t) // 2] for t in tenth]}), file=sys.stderr)
    after = ops.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}

    tr = None
    if trace_on:
        def traced(k):
            serve(p, program, attempted + k)
            _sync(torch, device)

        tr = trace.capture(traced, TRACE_REQUESTS,
                           Path(tempfile.gettempdir()))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # --- the check: a seeded sample against the plain reference --------
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lim = {name: float(limits[name]["limit"]) for name in NUMBERS
           if name in limits}
    refs, worst = {}, dict.fromkeys(lim, float("-inf") if kept else
                                    float("inf"))
    for i, out in sorted(kept, key=lambda e: e[0]):
        k = i % len(p.pool)
        if k not in refs:
            refs[k] = reference_logits(p, k)
        for name in lim:
            value = NUMBERS[name](out, refs[k])
            worst[name] = max(worst[name], value)
            log(f"check request {i} (pool {k}): {name} {value!r} "
                f"limit {lim[name]!r}", file=sys.stderr)
    correct = bool(done and not failed and lim
                   and all(worst[n] <= lim[n] for n in lim))

    run = {"requests": done, "window_s": window_s, "latency_s": lat,
           "host_s": host, "launches": launches, "counts": cnt, "trace": tr,
           "own_kernels": trace.kernel_names(
               ROOT / "src" / "repro_torch" / "kernels" / "csrc")}
    metrics = {}
    if trace_on:
        for m in manifest["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"requests_per_s": done / window_s if window_s else 0.0,
               "latency_p95_ms": (1e3 * statistics.quantiles(lat, n=20)[18]
                                  if len(lat) > 1 else None),
               "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]) \
                    and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = trace.busy_s(tr)
        dev["window_s"] = tr["span"][1] - tr["span"][0]
        result["breakdown"] = {"device_ops": trace.device_ops(tr)[:10],
                               "idle_gaps": trace.idle_gaps(tr, 10)}
    result["checks"] = {   # a non-finite gap prints as null
        **{n: {"value": worst[n] if math.isfinite(worst[n]) else None,
               "limit": lim[n]} for n in lim},
        "requests_failed": {"value": failed, "limit": 0}}
    return result


def _gaps(out, ref):
    """``|out - ref|`` in ``ref``'s dtype (None for a wrong shape)."""
    if tuple(out.shape) != tuple(ref.shape):
        return None
    return (out.to(ref.dtype) - ref).abs()


def _finite(err) -> float:
    err = float(err)
    return err if math.isfinite(err) else float("inf")


def rel_err(out, ref) -> float:
    """The widest gap of ``out`` from ``ref`` over ``ref``'s largest
    magnitude (inf for a wrong shape or a non-finite gap)."""
    gap = _gaps(out, ref)
    return float("inf") if gap is None else _finite(
        gap.max() / ref.abs().max().clamp(min=1e-30))


def mean_rel_err(out, ref) -> float:
    """The mean gap of ``out`` from ``ref`` over ``ref``'s mean magnitude
    (inf for a wrong shape or a non-finite gap): a loss of precision on
    every logit moves it, a rare flip of one quantization level hardly
    does."""
    gap = _gaps(out, ref)
    return float("inf") if gap is None else _finite(
        gap.mean() / ref.abs().mean().clamp(min=1e-30))


#: The numbers a cell's output check can compare, by the name its limits
#: file gives them; each is the worst over the checked requests.
NUMBERS = {"logit_rel_err": rel_err, "logit_mean_rel_err": mean_rel_err}


def _log(*args, file=None) -> None:
    print(*args, file=file or sys.stdout, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, _ = find_cell(manifest, args.workload)

    import torch

    marks = {"torch": time.perf_counter()}
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks["cuda"] = time.perf_counter()
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), log=_log,
                      marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
