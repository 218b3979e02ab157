"""Seconds from the process start to the first timed step: imports, records and
weights from the seed, kernels built, warm-up and the checked steps."""


def read(run):
    return run.setup_s
