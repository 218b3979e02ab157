"""Arithmetic that the metric readers share."""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from benchmark.lib import bounds, trace
from benchmark.lib.harness import BENCH_DIR, Run, load_json, percentile

FUNCTIONS = ("fused_layernorm", "layernorm_bwd", "fused_attention", "attention_bwd",
             "fused_biattention")


def _is(run: Run, kind: str) -> bool:
    """Whether the run's entry kind is `kind`: its driver's name, or a
    name that begins with it and an underscore (a later `pretrain_tp`
    would be a pretraining entry)."""
    driver = run.spec.traffic["driver"]
    return driver == kind or driver.startswith(kind + "_")


def patterns(function: str):
    """The kernel-name patterns of one of the port's functions
    (benchmark/kernels/<function>.json)."""
    return load_json(BENCH_DIR / "kernels" / f"{function}.json")["patterns"]


def rate(run: Run, driver: str) -> Optional[float]:
    if not _is(run, driver) or not run.window.get("seconds"):
        return None
    return run.window["work"] / run.window["seconds"]


def span_p90_ms(run: Run, name: str, driver: str) -> Optional[float]:
    if not _is(run, driver) or not run.spans.get(name):
        return None
    return 1e3 * percentile(run.spans[name], 90)


def span_mean_ms(run: Run, name: str, driver: str) -> Optional[float]:
    if not _is(run, driver) or not run.spans.get(name):
        return None
    return 1e3 * statistics.fmean(run.spans[name])


def launches(run: Run, driver: str) -> Optional[float]:
    if not _is(run, driver) or not run.profile or not run.profile["kernels"]:
        return None
    return len(run.profile["kernels"]) / run.profile["n_steps"]


def idle_share(run: Run, driver: str) -> Optional[float]:
    """Percent of a window's step with no operation on the card: the device
    busy seconds of a traced step (the union of its operations' intervals)
    over the mean host time of the window's unprofiled steps. (The traced
    window's own length, `device.window_s`, holds the profiler's host
    overhead too.)"""
    p = run.profile
    if not _is(run, driver) or not p or p["busy_s"] <= 0 \
            or not run.window.get("steps"):
        return None
    step_s = run.window["seconds"] / run.window["steps"]
    return 100.0 * (1.0 - p["busy_s"] / p["n_steps"] / step_s)


def mfu(run: Run, driver: str) -> Optional[float]:
    """The window's model FLOPs a second over the bf16 peak of every card
    the cell uses, in percent."""
    r = rate(run, driver)
    if r is None or not run.flops_per_item:
        return None
    return 100.0 * run.flops_per_item * r / (bounds.BF16_PEAK * run.spec.chips)


def roofline(run: Run, functions: Iterable[str], driver: str) -> Optional[float]:
    """The summed bound time of the calls of `functions` in the traced
    steps over the summed device time of their kernels, in percent; None
    where the calls or their kernels were not seen."""
    functions = tuple(functions)
    if not _is(run, driver) or not run.profile or run.kernel_calls is None:
        return None
    bound = sum(b for f, b in run.kernel_calls if f in functions)
    pats = [p for f in functions for p in patterns(f)]
    device = trace.kernel_seconds(run.profile, pats)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
