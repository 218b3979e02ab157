"""Runs of a cell on the CPU at a tiny width, for the benchmark's tests:
the cell's files as committed, with the configuration's widths and depth,
the traffic's counts and the run's window cut down."""

from __future__ import annotations

import copy
import shutil

from benchmark.lib import harness

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, v_hidden_size=24, v_num_hidden_layers=2,
            v_num_attention_heads=4, v_intermediate_size=24, bi_hidden_size=24,
            bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1])


def tiny_run(workload: str, seed: int = 2 ** 31 + 17, seconds: float = 0.01,
             trace: bool = False, traffic=None, cell=None) -> harness.Run:
    spec = harness.Spec(workload)
    spec.config = dict(spec.config, **TINY)
    spec.traffic = dict(spec.traffic, **(traffic or {}))
    spec.cell = dict(copy.deepcopy(spec.cell), **(cell or {}))
    return harness.Run(spec, seed, seconds, trace)


def run_on_cpu(run: harness.Run, **kw):
    import importlib
    driver = importlib.import_module(f"benchmark.drivers.{run.spec.traffic['driver']}")
    try:
        driver.run_cell(run, device="cpu", **kw)
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    return run
