"""Share (%) of the batches staged in the program's traced segment
(lib/program_trace.py) that took a pinned slot the program's pool already
held: its `k3m.stage` spans with `slot_reused` true. None where no span
carries the attribute (a program without the slot pool, or the CPU)."""

from benchmark.lib import program_trace


def share(run, driver):
    seg = program_trace.program_segment(run, driver)
    if seg is None:
        return None
    stages = [s for s in seg["recorder"].spans if s["name"] == "k3m.stage"]
    if not any("slot_reused" in s["attrs"] for s in stages):
        return None
    return 100.0 * sum(s["attrs"].get("slot_reused") is True for s in stages) / len(stages)


def read(run):
    return share(run, "score")
