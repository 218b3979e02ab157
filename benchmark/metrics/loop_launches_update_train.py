"""Kernels a step launched under `k3m.update`, in the program's traced segment
(lib/program_trace.py)."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.launches(run, "pretrain", "update")
