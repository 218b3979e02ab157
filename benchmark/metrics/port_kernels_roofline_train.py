"""The five port functions' summed bound time over their kernels' device time, in the traced steps."""

from benchmark.lib.readers import roofline, FUNCTIONS


def read(run):
    return roofline(run, FUNCTIONS, 'pretrain')
