"""Idle ms a step of the card whose innermost span is `k3m.fit`, `k3m.epoch`,
`k3m.step` or `k3m.sync`, in the program's traced segment
(lib/program_trace.py)."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.idle_ms(run, "pretrain", "loop")
