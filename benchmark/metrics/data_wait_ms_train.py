"""Mean host ms a step waits for its staged batch (prefetch's queue)."""

from benchmark.lib.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, 'data.wait', 'pretrain')
