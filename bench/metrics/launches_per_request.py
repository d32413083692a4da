"""``launches_per_request``: the program's kernel launches over the window
(the change of ``repro_torch.kernels.ops.launch_counts()``) over its
requests."""


def read(run: dict):
    if not run["requests"]:
        return None
    return sum(run["launches"].values()) / run["requests"]
