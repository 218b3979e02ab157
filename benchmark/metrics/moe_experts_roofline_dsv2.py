"""The held experts' grouped GEMMs' bound (lib/mla_bounds.py
`experts_bound`, from the rows the program's `k3m.moe.rows` counter
counted) over the device time of the kernels under its `k3m.moe.experts`
spans, in percent, in the traced program segment
of drivers/pretrain_moe.py."""

from benchmark.lib import mla_bounds


def read(run):
    seg = getattr(run, "moe_trace", None)
    if not seg or not seg["counts"].get("k3m.moe.rows"):
        return None
    cfg = run.spec.config
    rows = float(seg["counts"]["k3m.moe.rows"][0])
    held = cfg["experts_held"][1] - cfg["experts_held"][0]
    layers = (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]) * seg["n_steps"]
    device = mla_bounds.spans_device_seconds(seg["events"], ("k3m.moe.experts",))
    if device <= 0:
        return None
    bound = mla_bounds.experts_bound(rows, layers, held, cfg["hidden_size"],
                                     cfg["moe_intermediate_size"])
    return 100.0 * bound / device
