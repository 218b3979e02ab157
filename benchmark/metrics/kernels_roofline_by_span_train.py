"""The five kernel functions' summed bound, from their spans' attributes, over
the device time of the kernels launched inside their spans, in percent, in
the program's traced segment (lib/program_trace.py)."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.roofline(run, "pretrain")
