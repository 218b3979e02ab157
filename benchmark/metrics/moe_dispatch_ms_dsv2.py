"""Device milliseconds a step of the kernels launched under the program's
`k3m.moe.route` and `k3m.moe.combine` spans (the router, its softmax and
top-k, the sort, the gathers and the combine, forward and backward), in
the traced program segment of drivers/pretrain_moe.py."""

from benchmark.lib import mla_bounds


def read(run):
    seg = getattr(run, "moe_trace", None)
    if not seg:
        return None
    s = mla_bounds.spans_device_seconds(seg["events"], ("k3m.moe.route", "k3m.moe.combine"))
    return 1e3 * s / seg["n_steps"] if s > 0 else None
