"""Device kernels a step, counted in the device trace of the traced steps."""

from benchmark.lib.readers import launches


def read(run):
    return launches(run, 'pretrain')
