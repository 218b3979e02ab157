"""The attention forward's (#3) bound time over its kernels' device time, in the traced batches."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, ('fused_attention',), 'score')
