"""Mean host ms of a batch outside the forward: the wait for the loader, then the synchronous staging."""

from benchmark.lib.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, 'data.stage', 'score')
