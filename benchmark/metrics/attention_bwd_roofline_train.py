"""The attention backward's (#4) bound time over its kernels' device time, in the traced steps."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, ('attention_bwd',), 'pretrain')
