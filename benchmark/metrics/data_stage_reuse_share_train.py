"""Share (%) of the batches staged in the program's traced epoch that took
a pinned slot the program's pool already held (data_stage_reuse_share_score)."""

from benchmark.metrics.data_stage_reuse_share_score import share


def read(run):
    return share(run, "pretrain")
