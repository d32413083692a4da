"""``device_idle_pct``: the share of a request's time in the window in which
no operation ran on the device, in %: 1 - the device's busy time a traced
request (the union of its intervals over the traced requests) / the
window's time a request.  The busy time comes from the trace, the time a
request from the untraced window, so the profiler's own cost on the host,
which stretches the traced requests' idle gaps, stays out of it."""
from bench import trace


def read(run: dict):
    tr = run["trace"]
    if tr is None or not tr["device"] or not tr["requests"] \
            or not run["requests"]:
        return None
    busy = trace.busy_s(tr) / tr["requests"]
    return 100.0 * (1.0 - busy / (run["window_s"] / run["requests"]))
