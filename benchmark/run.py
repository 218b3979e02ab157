#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (benchmark/configs/), its traffic (benchmark/traffic/, whose
`driver` names the entry's driver in benchmark/drivers/) and its cell file
(benchmark/cells/<name>.json: chips, steps, limits). The run makes its
records and weights from the seed, warms up, measures for `--seconds`,
checks what the timed path produced against the plain reference
(benchmark/reference/) and prints one JSON line last on standard output.
With `--trace 1` it then traces a few steps and prints the cell's
per-layer metrics (benchmark/metrics/<metric>.py) in place of the
end-to-end ones.

Exits non-zero with no result where CUDA is missing or has fewer cards
than the cell asks for, where BENCHMARK.json or the cell's files are
missing, and where a module of JAX, Flax, optax, the JAX package or its
scripts is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=[0, 1])
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def result_line(run: harness.Run, torch) -> dict:
    spec = run.spec
    metrics = {}
    if run.trace:
        for m in spec.per_layer():
            value = harness.read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in spec.end_to_end():
            value = harness.read_metric(m["name"], run)
            if value is None:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=spec.chips,
                  memory_peak_bytes=int(run.peak_bytes))
    out = dict(correct=run.correct, attempted=int(run.window["attempted"]),
               failed=int(run.window["failed"]), metrics=metrics, device=device)
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = dict(device_ops=run.profile["device_ops"],
                                idle_gaps=run.profile["idle_gaps"])
    out["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"]) for c in run.checks}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        return fail(f"no BENCHMARK.json in {root}")
    try:
        spec = harness.Spec(args.workload, root)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the workload {args.workload}: {e}")
    harness.set_cache_dirs(root)
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    if torch.cuda.device_count() < spec.chips:
        return fail(f"the cell asks for {spec.chips} cards, {torch.cuda.device_count()} seen")
    if not (root / "k3m_tpu_torch").is_dir():
        return fail(f"the program k3m_tpu_torch is not in {root}")
    run = harness.Run(spec, args.seed, args.seconds, bool(args.trace))
    try:
        driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
        driver.run_cell(run)
        bad = harness.forbidden_modules()
        if bad:
            return fail(f"modules loaded that the port may not use: {bad}")
        power = harness.card_power()
        line = result_line(run, torch)
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    print(f"card: {power}; setup_s {run.setup_s:.3f}; window {run.window}; "
          f"notes {run.notes}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
