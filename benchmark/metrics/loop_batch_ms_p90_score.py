"""90th percentile of the window's batch times: from asking for the batch to its results on the host."""

from benchmark.lib.readers import span_p90_ms


def read(run):
    return span_p90_ms(run, 'loop.batch', 'score')
