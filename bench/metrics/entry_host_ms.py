"""``entry_host_ms``: the host's time in ``infer_logits``, from the call to
its return (before the harness's synchronize), the mean over the window's
requests, in ms."""


def read(run: dict):
    host = run["host_s"]
    return 1e3 * sum(host) / len(host) if host else None
