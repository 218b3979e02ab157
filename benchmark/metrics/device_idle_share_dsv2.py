"""Percent of a training step with no operation on the card: a traced step's device busy seconds over the mean time of the window's unprofiled steps."""

from benchmark.lib.readers import idle_share


def read(run):
    return idle_share(run, 'pretrain')
