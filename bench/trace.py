"""Reading a ``torch.profiler`` trace: device intervals, busy time, idle
gaps and what the host did in them, and the time of the program's own
kernels (named from the ``__global__`` declarations of its CUDA sources).

The trace is exported as Chrome trace JSON into a directory the caller
names (the run's ``TMPDIR``), read, and deleted.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

#: Trace categories of work on the device, and of the host's doings.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
REQUEST = "bench.request"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_names(csrc: Path) -> list:
    """Names of the kernels declared ``__global__`` in ``csrc``'s sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return sorted(names)


def capture(fn, count: int, tmpdir: Path) -> dict:
    """Profile ``count`` calls ``fn(k)``, each inside a ``bench.request``
    range, and return :func:`parse` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for k in range(count):
            with record_function(REQUEST):
                fn(k)
    path = Path(tmpdir) / "bench_trace.json"
    try:
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    return parse(data)


def parse(data: dict) -> dict:
    """``{"span": (t0, t1), "requests", "device": [(name, t0, dur)],
    "host": [(name, t0, dur)]}`` of a Chrome trace, in seconds, clipped to
    the span of its ``bench.request`` ranges."""
    events = [e for e in data.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    reqs = [e for e in events if e.get("name") == REQUEST
            and e.get("cat") == "user_annotation"]
    if not reqs:
        return {"span": (0.0, 0.0), "requests": 0, "device": [], "host": []}
    t0 = min(float(e["ts"]) for e in reqs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in reqs)

    def within(cats):
        out = []
        for e in events:
            if e.get("cat") not in cats:
                continue
            a = max(float(e["ts"]), t0)
            b = min(float(e["ts"]) + float(e["dur"]), t1)
            if b > a:
                out.append((e["name"], a * 1e-6, (b - a) * 1e-6))
        return out

    return {"span": (t0 * 1e-6, t1 * 1e-6), "requests": len(reqs),
            "device": within(DEVICE_CATS), "host": within(HOST_CATS)}


def busy_intervals(device: list) -> list:
    """The union of the device intervals, as sorted ``(t0, t1)``."""
    merged = []
    for _, a, d in sorted(device, key=lambda e: e[1]):
        b = a + d
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_s(tr: dict) -> float:
    return sum(b - a for a, b in busy_intervals(tr["device"]))


def idle_gaps(tr: dict, top: int = 10) -> list:
    """The ``top`` longest idle stretches of the device inside the span, as
    ``[host op, seconds]``: the innermost host event under the stretch's
    midpoint (the latest-starting one), or ``"(no host event)"``."""
    t0, t1 = tr["span"]
    edges = [t0]
    for a, b in busy_intervals(tr["device"]):
        edges += [a, b]
    edges.append(t1)
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:top]
    out = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        under = [h for h in tr["host"] if h[1] <= mid <= h[1] + h[2]]
        name = max(under, key=lambda h: h[1])[0] if under else \
            "(no host event)"
        out.append([name, length])
    return out


def device_ops(tr: dict) -> list:
    """Device time by operation name, longest first, as ``[name, s]``."""
    total = {}
    for name, _, d in tr["device"]:
        total[name] = total.get(name, 0.0) + d
    return sorted(([k, v] for k, v in total.items()), key=lambda g: -g[1])


def own_kernel_s(tr: dict, names: list) -> float:
    """Device time of the kernels named in ``names`` (whole words)."""
    if not names:
        return 0.0
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(d for name, _, d in tr["device"] if pat.search(name))
