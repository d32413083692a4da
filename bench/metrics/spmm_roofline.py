"""``spmm_roofline``: the aggregations' least time a request (bytes over
peak bandwidth or operations over peak float32 rate, the larger, for each
aggregation: ``bench/counts.py``) over the device time a request of the
program's own kernels (those its CUDA sources declare ``__global__``), from
the traced requests, in %."""
from bench import trace


def read(run: dict):
    tr, least = run["trace"], run["counts"]["agg_least_s"]
    if tr is None or not tr["requests"] or least is None:
        return None
    own = trace.own_kernel_s(tr, run["own_kernels"]) / tr["requests"]
    return 100.0 * least / own if own > 0 else None
