"""The program's own spans (`k3m_tpu_torch.utils.trace`) over one more traced
segment of a cell, read against its device trace.

The segment runs once a run, when the first of its readers asks for it
(`reading`), after the entry's `run_cell` has returned: a trainer or model
of its own, built by the entry's driver's functions from the run's seed,
configuration and traffic, warmed up as the entry warms up its own, then
traced. Pretraining: `check_steps` + `warmup_steps` steps of `fit`, then
one `fit` call of one whole epoch (its start weighs as in the window).
Scoring: `warmup_batches` batches, then `traced_batches`. What the other
readers read (`run.spans`, `run.window`, `run.profile`,
`run.kernel_calls`, `run.peak_bytes`) stays as the entry left it; the
segment is kept as `run.program_trace`.

`segment(steps, n_steps, tmpdir)` runs `steps()` (n_steps steps or
batches) under torch.profiler (every thread, where the profiler can) with
the program's recorder on, and keeps the trace's device operations,
runtime calls and annotations beside the recorder. Where the program has
no recorder (an older checkout) nothing runs, and every reader here
returns None.

The recorder's spans carry `time.time_ns()`; the trace's `ts` are
microseconds after its `baseTimeNanoseconds`. The spans are moved onto the
trace's clock by that base and by the median gap between each span of the
recording thread and its own annotation (the same name, in the same
order), which the profiler wrote on its clock.

- Idle: every instant of the segment (the recording's start to its end, a
  device sync included) with no kernel, copy or memset on the card goes to
  the innermost span open on the recording thread at that instant, and to
  that span's phase: the first of `k3m.forward`, `k3m.backward`,
  `k3m.update`, `k3m.data_wait`, `k3m.stage` among it and its enclosing
  spans, else `loop` where a `k3m.fit`, `k3m.epoch`, `k3m.step` or
  `k3m.sync` is open, else `none`.
- Launches: each kernel goes, through the `correlation` of its runtime
  call, to the innermost span open on the launching thread when it was
  launched; where that span has no phase (autograd's engine thread, whose
  only spans are the backward kernels'), to the recording thread's.
- Roofline by span: the summed bound (lib/bounds.py) of every
  `k3m.kernel.*` span, from its attributes on meta tensors, over the device
  time of the kernels launched inside such spans.
"""

from __future__ import annotations

import bisect
import gc
import inspect
import json
import os
import shutil
import statistics
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from benchmark.lib import bounds, synthetic
from benchmark.lib.trace import DEVICE_CATS

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
PHASES = {"k3m.forward": "forward", "k3m.backward": "backward", "k3m.update": "update",
          "k3m.data_wait": "data", "k3m.stage": "stage"}
LOOP = ("k3m.fit", "k3m.epoch", "k3m.step", "k3m.sync")
# each kernel span's bound: lib/bounds.py's function of its attributes
BOUNDS = {"k3m.kernel.fused_layernorm": bounds.layernorm_fwd,
          "k3m.kernel.layernorm_bwd": bounds.layernorm_bwd,
          "k3m.kernel.fused_attention": bounds.attention_fwd,
          "k3m.kernel.attention_bwd": bounds.attention_bwd,
          "k3m.kernel.fused_biattention": bounds.biattention_fwd}
# a span's attributes are the call's arguments; these take the bound's names
RENAME = {"keep_words": "words", "dropout1": "rate1", "dropout2": "rate2"}


def program_recorder():
    """The program's trace module, or None where the program has none."""
    try:
        from k3m_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _profiler_config() -> Dict:
    """torch.profiler's option to trace every thread, where it has one."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return dict(experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return {}


def segment(steps: Callable[[], object], n_steps: int, tmpdir: str) -> Optional[Dict]:
    """`steps()` traced with the program's recorder on (module docstring):
    {result, n_steps, recorder, base_ns, events}; None without a recorder."""
    trace = program_recorder()
    if trace is None:
        return None
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, **_profiler_config()) as prof:
        with trace.recording() as rec:
            result = steps()
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(tmpdir, "program_trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    os.unlink(path)
    keep = DEVICE_CATS + RUNTIME_CATS + ("user_annotation",)
    events = [e for e in raw["traceEvents"] if e.get("ph") == "X" and e.get("cat") in keep]
    return dict(result=result, n_steps=n_steps, recorder=rec,
                base_ns=int(raw.get("baseTimeNanoseconds", 0)), events=events)


# ------------------------------------------------------------ the bounds

def _meta(value):
    if isinstance(value, dict) and "shape" in value and "dtype" in value:
        return torch.empty(value["shape"], dtype=getattr(torch, value["dtype"]),
                           device="meta")
    if isinstance(value, str) and isinstance(getattr(torch, value, None), torch.dtype):
        return getattr(torch, value)
    return value


def span_bound(span: Dict) -> float:
    """The bound seconds of one `k3m.kernel.*` span from its attributes."""
    fn = BOUNDS[span["name"]]
    params = inspect.signature(fn).parameters
    attrs = {RENAME.get(k, k): v for k, v in span["attrs"].items()}
    return fn(**{k: _meta(v) for k, v in attrs.items() if k in params})


def bound_seconds(recorder) -> float:
    return sum(span_bound(s) for s in recorder.spans if s["name"] in BOUNDS)


# ------------------------------------------------------------ the clock

class _Thread:
    """One thread's spans on the trace's clock: the innermost open span at
    any instant, as pieces (start, end, span) in time order."""

    def __init__(self, spans: List[Dict]):
        pieces, stack, last = [], [], None
        marks = sorted([(s["ts"], 1, -s["end"], i) for i, s in enumerate(spans)]
                       + [(s["end"], 0, 0, i) for i, s in enumerate(spans)])
        for t, opening, _, i in marks:
            if last is not None and t > last and stack:
                pieces.append((last, t, spans[stack[-1]]))
            last = t
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, t: float) -> Optional[Dict]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.pieces[i][0] <= t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _on_trace_clock(seg: Dict) -> List[Dict]:
    """The recorder's spans with `ts` and `end` in the trace's microseconds."""
    rec, base = seg["recorder"], seg["base_ns"]
    spans = [dict(s, ts=(s["start_ns"] - base) * 1e-3, end=(s["end_ns"] - base) * 1e-3)
             for s in rec.spans]
    notes: Dict[tuple, List[float]] = {}
    for e in seg["events"]:
        if e["cat"] == "user_annotation":
            notes.setdefault((e.get("tid"), e["name"]), []).append(float(e["ts"]))
    mine: Dict[tuple, List[float]] = {}
    for s in spans:
        if s["tid"] == rec.thread:
            mine.setdefault((s["tid"], s["name"]), []).append(s["ts"])
    gaps = []
    for key, starts in mine.items():
        theirs = notes.get(key, [])
        if len(theirs) == len(starts):
            gaps += [b - a for a, b in zip(sorted(starts), sorted(theirs))]
    shift = statistics.median(gaps) if gaps else 0.0
    for s in spans:
        s["ts"] += shift
        s["end"] += shift
    seg["window"] = ((rec.start_ns - base) * 1e-3 + shift, (rec.end_ns - base) * 1e-3 + shift)
    return spans


def _phase(span: Optional[Dict], by_id: Dict[int, Dict]) -> str:
    """The phase of the innermost open span `span` (module docstring), or
    `kernel` where it and its enclosing spans are kernel spans alone."""
    loop = kernel = False
    while span is not None:
        if span["name"] in PHASES:
            return PHASES[span["name"]]
        loop = loop or span["name"] in LOOP
        kernel = kernel or span["name"].startswith("k3m.kernel.")
        span = by_id.get(span["parent"])
    return "loop" if loop else "kernel" if kernel else "none"


def _merged(intervals):
    """The intervals' union as sorted, disjoint [start, end] pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


# ------------------------------------------------------------ the readings

def analyse(seg: Dict) -> Dict:
    """Idle ms and launches a step by phase, the kernels' bound and device
    seconds, and the host ms a step of every span name (kept in `seg`)."""
    if "analysis" in seg:
        return seg["analysis"]
    spans = _on_trace_clock(seg)
    by_id = {s["id"]: s for s in spans}
    step_tid = seg["recorder"].thread
    threads = {}
    for s in spans:
        threads.setdefault(s["tid"], []).append(s)
    threads = {tid: _Thread(ss) for tid, ss in threads.items()}
    step = threads.get(step_tid) or _Thread([])
    n = seg["n_steps"]
    w0, w1 = seg["window"]

    dev = [e for e in seg["events"] if e["cat"] in DEVICE_CATS]
    busy = _merged((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev)
    idle: Dict[str, float] = {}
    t = w0
    for s, e in busy + [[w1, w1]]:
        s, e = min(max(s, w0), w1), min(e, w1)
        if s > t:
            _split_idle(t, s, step, by_id, idle)
        t = max(t, e)
    idle_ms = {k: v * 1e-3 / n for k, v in idle.items()}

    runtime = {}
    for e in seg["events"]:
        if e["cat"] in RUNTIME_CATS and "correlation" in e.get("args", {}):
            runtime[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    launches: Dict[str, float] = {}
    kernel_span_s = 0.0
    kernels = [e for e in dev if e["cat"] == "kernel"]
    for e in kernels:
        tid, ts = runtime.get(e.get("args", {}).get("correlation"), (None, None))
        inner = threads[tid].at(ts) if tid in threads else None
        phase = _phase(inner, by_id)
        if phase in ("kernel", "none") and tid != step_tid and ts is not None:
            phase = _phase(step.at(ts), by_id)
        launches[phase] = launches.get(phase, 0) + 1
        if inner is not None and inner["name"].startswith("k3m.kernel."):
            kernel_span_s += float(e.get("dur", 0.0)) * 1e-6
    host: Dict[str, float] = {}
    for s in spans:
        host[s["name"]] = host.get(s["name"], 0.0) + (s["end"] - s["ts"]) * 1e-3 / n
    seg["analysis"] = dict(
        idle_ms=idle_ms, idle_ms_total=sum(idle_ms.values()),
        launches={k: v / n for k, v in launches.items()},
        kernels=len(kernels) / n, bound_s=bound_seconds(seg["recorder"]),
        kernel_span_s=kernel_span_s, host_ms=host, window_ms=(w1 - w0) * 1e-3 / n)
    return seg["analysis"]


def _split_idle(t0: float, t1: float, step: _Thread, by_id, idle: Dict[str, float]):
    """Add the idle interval [t0, t1) to `idle` by the phase of the step
    thread's innermost span over each of its parts."""
    i = max(0, bisect.bisect_right(step.starts, t0) - 1)
    t = t0
    while t < t1:
        piece = step.pieces[i] if i < len(step.pieces) else None
        if piece is None or piece[0] >= t1:
            _add(idle, "none", t1 - t)
            return
        s, e, span = piece
        if s > t:
            _add(idle, "none", s - t)
            t = s
        if e > t:
            end = min(e, t1)
            _add(idle, _phase(span, by_id), end - t)
            t = end
        i += 1


def _add(acc: Dict[str, float], key: str, value: float):
    acc[key] = acc.get(key, 0.0) + value


# ------------------------------------------------------------ the segment

def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _after(device: torch.device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def pretrain_segment(run, tmpdir: str) -> Dict:
    """A trainer of its own through the pretraining entry's set-up steps,
    then one whole epoch of `fit` traced (module docstring)."""
    from benchmark.drivers import pretrain
    traffic, cell, device = run.spec.traffic, run.spec.cell, _device()
    cfg = pretrain.program_config(run.spec.config)
    path = os.path.join(tmpdir, "train_feat.k3mr")
    synthetic.write_pretrain_records(path, run.seed, traffic["records"])
    loader = pretrain.make_loader(run, cfg, path, traffic)
    trainer = pretrain.make_trainer(run, cfg, traffic, device)
    try:
        warm = cell["check_steps"] + cell.get("warmup_steps", 0)
        epoch = pretrain.fit_steps(run, trainer, loader, 0, steps=warm)["epochs"]
        n = len(loader)
        return segment(lambda: pretrain.fit_steps(run, trainer, loader, epoch, steps=n),
                       n, tmpdir)
    finally:
        del trainer, loader
        _after(device)


def score_segment(run, tmpdir: str) -> Dict:
    """A model and feeder of their own through the scoring entry's warm-up
    batches, then `traced_batches` batches traced (module docstring)."""
    from benchmark.drivers import score
    traffic, cell, device = run.spec.traffic, run.spec.cell, _device()
    cfg = score.program_config(run.spec.config)
    path = os.path.join(tmpdir, "test_item_alignment.k3mr")
    synthetic.write_pair_records(path, run.seed, traffic["records"])
    loader = score.make_loader(run, cfg, path, traffic)
    model = score.make_model(run, cfg, device)
    feeder = score.Feeder(loader, traffic["feed_depth"])
    gen = score.score_batches(run, model, feeder, cfg, device, traffic)
    try:
        for _ in range(cell["warmup_batches"]):
            next(gen)
        n = cell["traced_batches"]
        return segment(lambda: [next(gen) for _ in range(n)], n, tmpdir)
    finally:
        gen.close()
        feeder.close()
        del gen, feeder, loader, model
        _after(device)


SEGMENTS = {"pretrain": pretrain_segment, "score": score_segment}


def program_segment(run, driver: str) -> Optional[Dict]:
    """The run's program segment, run on the first call (module docstring);
    None where the run is not of entry kind `driver` or the program has no
    recorder."""
    from benchmark.lib.readers import _is
    if not _is(run, driver):
        return None
    if not hasattr(run, "program_trace"):
        run.program_trace = None
        if program_recorder() is not None:
            spans = {k: list(v) for k, v in run.spans.items()}
            os.makedirs(run.tmp, exist_ok=True)
            tmpdir = tempfile.mkdtemp(prefix="program_trace_", dir=run.tmp)
            try:
                run.program_trace = SEGMENTS[driver](run, tmpdir)
            finally:
                run.spans = spans
                shutil.rmtree(tmpdir, ignore_errors=True)
    return run.program_trace


def reading(run, driver: str) -> Optional[Dict]:
    """The analysis of the run's program segment, where the run is of
    entry kind `driver` and has one."""
    seg = program_segment(run, driver)
    return None if seg is None else analyse(seg)


def idle_ms(run, driver: str, phase: str) -> Optional[float]:
    r = reading(run, driver)
    if r is None or r["kernels"] <= 0:
        return None
    return r["idle_ms"].get(phase, 0.0)


def launches(run, driver: str, phase: str) -> Optional[float]:
    r = reading(run, driver)
    if r is None or r["kernels"] <= 0:
        return None
    return r["launches"].get(phase, 0.0)


def roofline(run, driver: str) -> Optional[float]:
    r = reading(run, driver)
    if r is None or r["bound_s"] <= 0 or r["kernel_span_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["kernel_span_s"]


def host_ms(run, driver: str, name: str) -> Optional[float]:
    r = reading(run, driver)
    if r is None or name not in r["host_ms"]:
        return None
    return r["host_ms"][name]
