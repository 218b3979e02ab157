"""Device kernels a batch, counted in the device trace of the traced batches."""

from benchmark.lib.readers import launches


def read(run):
    return launches(run, 'score')
