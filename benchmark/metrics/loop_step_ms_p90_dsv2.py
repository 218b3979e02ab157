"""90th percentile of the window's step times: from asking for the staged batch to the end of the step's device sync."""

from benchmark.lib.readers import span_p90_ms


def read(run):
    return span_p90_ms(run, 'loop.step', 'pretrain')
