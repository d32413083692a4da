"""Trace export and rendering: Perfetto JSON, span trees, summaries.

The port's own copy of the reference package's ``obs.export``.
Everything here operates on span *records* — the plain dicts produced
by ``Span.to_dict()`` / read back from the JSONL sink — so live ring
contents and on-disk trace files go through the same code.  Stdlib only.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def _as_record(sp) -> dict:
    return sp if isinstance(sp, dict) else sp.to_dict()


def to_perfetto(spans: Sequence) -> dict:
    """Convert spans to the Chrome/Perfetto ``trace_event`` format
    (load the result at https://ui.perfetto.dev).  Each span becomes a
    complete ("ph": "X") event; timestamps are ``perf_counter``-based
    microseconds, comparable within one process."""
    events = []
    for sp in spans:
        r = _as_record(sp)
        events.append({
            "name": r["name"],
            "cat": "repro",
            "ph": "X",
            "ts": r["t0"] * 1e6,
            "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6),
            "pid": r.get("pid", 0),
            "tid": r.get("thread", 0),
            "args": dict(r.get("attrs") or {},
                         trace_id=r.get("trace_id"),
                         span_id=r.get("span_id"),
                         parent_id=r.get("parent_id"),
                         status=r.get("status", "ok")),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path: str, spans: Sequence) -> int:
    doc = to_perfetto(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str)
    return len(doc["traceEvents"])


def load_trace_file(path: str) -> List[dict]:
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def load_trace_dir(root: str) -> List[dict]:
    """All records from every ``*.jsonl`` under a traces dir."""
    records: List[dict] = []
    if not os.path.isdir(root):
        return records
    for name in sorted(os.listdir(root)):
        if name.endswith(".jsonl"):
            records.extend(load_trace_file(os.path.join(root, name)))
    return records


def build_trees(spans: Sequence) -> Dict[str, List[dict]]:
    """Group records by trace and link parents: returns
    ``{trace_id: [root_node, ...]}`` where a node is
    ``{"record": rec, "children": [node, ...]}``.  Records whose parent
    never arrived (ring eviction, partial file) surface as roots rather
    than vanishing."""
    records = [_as_record(sp) for sp in spans]
    nodes = {r["span_id"]: {"record": r, "children": []} for r in records}
    trees: Dict[str, List[dict]] = {}
    for r in records:
        node = nodes[r["span_id"]]
        parent = nodes.get(r.get("parent_id"))
        if parent is not None and parent["record"]["trace_id"] == r["trace_id"]:
            parent["children"].append(node)
        else:
            trees.setdefault(r["trace_id"], []).append(node)
    for roots in trees.values():
        roots.sort(key=lambda n: n["record"]["t0"])
        stack = list(roots)
        while stack:
            n = stack.pop()
            n["children"].sort(key=lambda c: c["record"]["t0"])
            stack.extend(n["children"])
    return trees


def _dur_us(r: dict) -> float:
    return max(0.0, (r["t1"] - r["t0"]) * 1e6)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def _render_node(node: dict, depth: int, out: List[str]) -> None:
    r = node["record"]
    total = _dur_us(r)
    self_us = total - sum(_dur_us(c["record"]) for c in node["children"])
    attrs = r.get("attrs") or {}
    attr_str = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
    mark = " !" if r.get("status") not in (None, "ok") else ""
    line = (f"{'  ' * depth}{r['name']}{mark}  "
            f"total={_fmt_us(total)} self={_fmt_us(max(0.0, self_us))}")
    if attr_str:
        line += f"  [{attr_str}]"
    out.append(line)
    for c in node["children"]:
        _render_node(c, depth + 1, out)


def render_summary(spans: Sequence, metrics: Optional[dict] = None,
                   max_traces: int = 20) -> str:
    """Human-readable per-trace span trees (self/total times) followed
    by the metrics snapshot — the `python -m repro_torch.obs summary` body."""
    trees = build_trees(spans)
    out: List[str] = [f"{sum(len(v) for v in trees.values())} root span(s) "
                      f"across {len(trees)} trace(s)"]
    ordered = sorted(trees.items(),
                     key=lambda kv: kv[1][0]["record"]["t0"] if kv[1] else 0.0)
    for trace_id, roots in ordered[:max_traces]:
        out.append(f"\ntrace {trace_id}")
        for root in roots:
            _render_node(root, 1, out)
    if len(ordered) > max_traces:
        out.append(f"\n... {len(ordered) - max_traces} more trace(s)")
    if metrics:
        counters = metrics.get("counters") or {}
        gauges = metrics.get("gauges") or {}
        hists = metrics.get("histograms") or {}
        if counters:
            out.append("\ncounters:")
            out.extend(f"  {k} = {v}" for k, v in counters.items())
        if gauges:
            out.append("gauges:")
            out.extend(f"  {k} = {v:g}" for k, v in gauges.items())
        if hists:
            out.append("histograms:")
            for k, h in hists.items():
                out.append(
                    f"  {k}: n={h['count']} p50={_fmt_us(h['p50_us'])} "
                    f"p95={_fmt_us(h['p95_us'])} p99={_fmt_us(h['p99_us'])}")
    return "\n".join(out)


def validate_tree(spans: Sequence) -> dict:
    """Structural well-formedness report for a span set: every
    non-None parent_id resolves within its own trace, t1 >= t0, and
    children lie inside their parent's interval (small slack for
    retrospective stamps).  Used by the smoke gate."""
    records = [_as_record(sp) for sp in spans]
    by_id = {r["span_id"]: r for r in records}
    dangling = orphans = inverted = escaped = 0
    for r in records:
        if r["t1"] < r["t0"]:
            inverted += 1
        pid = r.get("parent_id")
        if pid is None:
            continue
        p = by_id.get(pid)
        if p is None:
            dangling += 1
            continue
        if p["trace_id"] != r["trace_id"]:
            orphans += 1
        slack = 5e-3  # 5ms: cross-thread clock stamps are not ordered
        if r["t0"] < p["t0"] - slack or r["t1"] > p["t1"] + slack:
            escaped += 1
    return {
        "spans": len(records),
        "traces": len({r["trace_id"] for r in records}),
        "dangling_parents": dangling,
        "cross_trace_parents": orphans,
        "inverted_intervals": inverted,
        "escaped_children": escaped,
        "well_formed": dangling == 0 and orphans == 0 and inverted == 0,
    }
