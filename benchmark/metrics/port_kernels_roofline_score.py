"""The port's forward functions' summed bound time over their kernels' device time, in the traced batches."""

from benchmark.lib.readers import roofline, FUNCTIONS


def read(run):
    return roofline(run, FUNCTIONS, 'score')
