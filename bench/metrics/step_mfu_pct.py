"""``step_mfu_pct``: the model's operations a request (each aggregation's
``2 * live * feat`` and each dense transform's ``2 * n * in * out``:
``bench/counts.py``) over the window's time a request times the card's
peak float32 rate, in %."""


def read(run: dict):
    pk = run["counts"]["peak"]
    if pk is None or not run["requests"]:
        return None
    per_request_s = run["window_s"] / run["requests"]
    return 100.0 * run["counts"]["model_flops"] / (per_request_s
                                                    * pk["flops_f32"])
