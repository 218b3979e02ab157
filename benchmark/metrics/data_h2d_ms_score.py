"""Host ms a batch in `k3m.stage.h2d`, in the program's traced segment
(lib/program_trace.py)."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.host_ms(run, "score", "k3m.stage.h2d")
