"""The share of the sort's capacity rows that the held experts' per-pair
kernels skip: 100 (1 - the program's `k3m.moe.rows` counter (the held
pairs) over its `k3m.moe.pairs` counter (every (row, choice) pair of each
MoE layer call)), summed over the traced program segment of
drivers/pretrain_moe.py. Nothing where the program keeps no capacity
counter."""


def read(run):
    seg = getattr(run, "moe_trace", None)
    counts = seg["counts"] if seg else {}
    rows, pairs = counts.get("k3m.moe.rows"), counts.get("k3m.moe.pairs")
    if not rows or not pairs or pairs[0] <= 0:
        return None
    return 100.0 * (1.0 - rows[0] / pairs[0])
