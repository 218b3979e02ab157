"""The latent attention's kernel instance (#3/#4 at q.k 192, v 128): the
bound of its calls in the traced steps (lib/mla_bounds.py, forward and
backward) over its kernels' device time, in percent."""

from benchmark.lib import mla_bounds, trace


def read(run):
    calls = getattr(run, "mla_calls", None)
    if not calls or not run.profile:
        return None
    bound = sum(b for _, b in calls)
    device = trace.kernel_seconds(run.profile, mla_bounds.PATTERNS)
    return 100.0 * bound / device if bound > 0 and device > 0 else None
