"""Idle ms a step of the card under `k3m.data_wait`, in the program's traced
segment (lib/program_trace.py)."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.idle_ms(run, "pretrain", "data")
