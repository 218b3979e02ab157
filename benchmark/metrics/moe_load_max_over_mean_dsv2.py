"""The busiest held expert's rows over the held experts' mean, from the
program's `k3m.moe.expert_rows` counter summed over the MoE layers and the
steps of the traced program segment of drivers/pretrain_moe.py."""


def read(run):
    seg = getattr(run, "moe_trace", None)
    rows = seg["counts"].get("k3m.moe.expert_rows") if seg else None
    if not rows or sum(rows) <= 0:
        return None
    return max(rows) / (sum(rows) / len(rows))
