"""What every cell's run shares: the run's specification read from
BENCHMARK.json and the files it names, the process start, host spans,
the device trace, the forbidden-module check and the result line."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# modules a run may not hold once its window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "k3m_tpu", "bench", "__graft_entry__",
             "chip_smoke")

# the caches of the program and of the libraries it may use, at fixed paths
# inside the checkout, so that a run after the first finds them built
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": "build/bench_cache/triton",
              "CUDA_CACHE_PATH": "build/bench_cache/nv_compute"}


def process_start() -> float:
    """The time.time() at which this process started (from /proc), so that
    set-up counts the interpreter's own start too."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text()
                    .splitlines() if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules in FORBIDDEN, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Spec:
    """One workload: its BENCHMARK.json entry, its cell file, its
    configuration and its traffic, each found by name."""

    def __init__(self, workload: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise SystemExit(f"unknown workload {workload}; known: {sorted(entries)}")
        self.bench = bench
        self.entry = entries[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.cell = load_json(BENCH_DIR / "cells" / f"{workload}.json")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


class Run:
    """The state of one run that the metrics read: the spec, the seed, the
    window's host spans and counts, the traced steps, the device."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool):
        self.spec = spec
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_process = process_start()
        self.spans: Dict[str, List[float]] = {}      # host seconds by span name
        self.counts: Dict[str, float] = {}
        self.window: Dict[str, float] = {}           # work, seconds, attempted, failed
        self.profile: Optional[dict] = None          # the traced steps (lib/trace.py)
        self.flops_per_item: Optional[float] = None  # the model's FLOPs per sample or pair
        self.kernel_calls: Optional[list] = None     # (function, bound s) of the traced steps
        self.setup_s: Optional[float] = None
        self.peak_bytes: Optional[int] = None
        self.checks: List[dict] = []                 # {name, value, limit}
        self.notes: Dict[str, object] = {}           # what the check found, for the log
        self.tmp = tempfile.mkdtemp(prefix="k3m_bench_")

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append(dict(name=name, value=float(value), limit=float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks)


def set_cache_dirs(root: Path = ROOT) -> None:
    for var, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # keep libraries that can load JAX or Flax by themselves from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def read_metric(name: str, run: Run):
    """The value of a per-layer metric, from its reader
    benchmark/metrics/<name>.py (dots read as underscores); None where it
    found nothing to read."""
    module = importlib.import_module("benchmark.metrics." + name.replace(".", "_"))
    return module.read(run)

