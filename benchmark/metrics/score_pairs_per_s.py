"""Pairs whose embeddings and probabilities reached the host, over the whole window."""

from benchmark.lib.readers import rate


def read(run):
    return rate(run, 'score')
