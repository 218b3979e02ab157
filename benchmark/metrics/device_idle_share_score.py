"""Percent of a scored batch with no operation on the card: a traced batch's
device busy seconds over the mean time of the window's unprofiled batches."""

from benchmark.lib.readers import idle_share


def read(run):
    return idle_share(run, 'score')
