"""Training samples completed over the whole window, across all ranks."""

from benchmark.lib.readers import rate


def read(run):
    return rate(run, 'pretrain')
