"""The readers of the program's spans (lib/program_trace.py) on a hand-made
trace, and the program segment that their first read runs after a traced
run of an entry, on the CPU, which leaves what the other readers read as
it was."""

from __future__ import annotations

import copy
import importlib
import shutil

import pytest
import torch

from benchmark.lib import bounds, program_trace
from benchmark.tests.helpers import tiny_run

BASE = 1_000_000_000_000_000   # the trace's baseTimeNanoseconds
SHIFT = 3.0                    # the recorder's clock behind the profiler's, us
STEP, PRODUCER, ENGINE = 1, 2, 3
Q = dict(shape=[4, 37, 8, 128], dtype="bfloat16")
BIAS = dict(shape=[4, 37], dtype="float32")
ATTRS = dict(q=Q, k=Q, v=Q, bias=BIAS, rate=0.1, for_backward=True)


class _Recorder:
    def __init__(self, spans, start, end):
        self.spans, self.thread = spans, STEP
        self.start_ns, self.end_ns = _ns(start), _ns(end)


def _ns(us):
    """A trace time (us) as the recorder's clock reads it."""
    return BASE + int(round((us - SHIFT) * 1e3))


def _made_up_segment():
    """One step on the recording thread: forward [0, 40) with a kernel span
    [10, 12), backward [40, 80), sync [80, 100), then the wait for the next
    batch [100, 120); staging [90, 115) on the producer thread; autograd's
    engine thread has no span. Kernels: one launched in the kernel span
    (runs 12-30), one from the engine thread at 50 (50-70), one from the
    producer at 95 (96-98), one after every span at 121 (122-125); copies
    run 99-100 and, after the recording (0 to 130), 5000-5001."""
    table = [(1, "k3m.step", STEP, None, 0, 100, {}), (2, "k3m.forward", STEP, 1, 0, 40, {}),
             (3, "k3m.kernel.fused_attention", STEP, 2, 10, 12, ATTRS),
             (4, "k3m.backward", STEP, 1, 40, 80, {}), (5, "k3m.sync", STEP, 1, 80, 100, {}),
             (6, "k3m.data_wait", STEP, None, 100, 120, {}),
             (7, "k3m.stage", PRODUCER, None, 90, 115, {})]
    spans = [dict(id=i, name=n, tid=tid, parent=p, start_ns=_ns(s), end_ns=_ns(e), attrs=a)
             for i, n, tid, p, s, e, a in table]
    notes = [dict(ph="X", cat="user_annotation", name=n, tid=tid, ts=float(s), dur=float(e - s))
             for _, n, tid, _, s, e, _ in table if tid == STEP]
    kernels = [(1, STEP, 11, 12, 30), (2, ENGINE, 50, 50, 70), (3, PRODUCER, 95, 96, 98),
               (4, STEP, 121, 122, 125)]
    events = notes + [dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=ts, dur=1.0,
                           args=dict(correlation=5)) for ts in (99.0, 5000.0)]
    for corr, tid, launch, s, e in kernels:
        events.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", tid=tid,
                           ts=float(launch), dur=0.5, args=dict(correlation=corr)))
        events.append(dict(ph="X", cat="kernel", name=f"kernel{corr}", ts=float(s),
                           dur=float(e - s), args=dict(correlation=corr)))
    return dict(result=None, n_steps=1, recorder=_Recorder(spans, 0, 130), base_ns=BASE,
                events=events)


def test_bench_program_trace_splits_idle_and_launches_by_phase():
    got = program_trace.analyse(_made_up_segment())
    # idle: [0, 12) forward, [30, 40) forward, [40, 50) and [70, 80) backward,
    # [80, 96) and [98, 99) the sync, [100, 120) the wait, [120, 122) and
    # [125, 130) no span
    want = dict(forward=22, backward=20, loop=17, data=20, none=7)
    assert got["idle_ms"] == pytest.approx({k: v * 1e-3 for k, v in want.items()})
    assert got["idle_ms_total"] == pytest.approx(86e-3)
    assert got["launches"] == dict(forward=1, backward=1, stage=1, none=1)
    assert got["kernels"] == 4
    assert got["host_ms"]["k3m.stage"] == pytest.approx(25e-3)
    meta = lambda a: torch.empty(a["shape"], dtype=getattr(torch, a["dtype"]), device="meta")
    bound = bounds.attention_fwd(meta(Q), meta(Q), meta(Q), meta(BIAS), 0.1, True)
    assert got["bound_s"] == pytest.approx(bound)
    assert got["kernel_span_s"] == pytest.approx(18e-6)


def test_bench_program_trace_readers_of_a_made_up_run(monkeypatch):
    from benchmark.lib import harness
    run = harness.Run(harness.Spec("pretrain-packed-b96"), 1, 30.0, True)
    # a program without the recorder: no segment runs, nothing is read
    with monkeypatch.context() as m:
        m.setattr(program_trace, "program_recorder", lambda: None)
        assert program_trace.idle_ms(run, "pretrain", "forward") is None
        assert run.program_trace is None
    run.program_trace = _made_up_segment()
    assert program_trace.idle_ms(run, "pretrain", "forward") == pytest.approx(22e-3)
    assert program_trace.idle_ms(run, "pretrain", "update") == 0.0
    assert program_trace.launches(run, "pretrain", "backward") == 1
    assert program_trace.roofline(run, "pretrain") == pytest.approx(
        100 * program_trace.analyse(run.program_trace)["bound_s"] / 18e-6)
    assert program_trace.idle_ms(run, "score", "stage") is None
    for m in run.spec.per_layer():
        if m["name"] in ("device.idle_ms_other.train", "model.launches_forward.train",
                         "loop.launches_update.train", "kernels.roofline_by_span.train"):
            assert harness.read_metric(m["name"], run) is not None, m["name"]


def _snap(run):
    return copy.deepcopy(dict(spans=run.spans, window=run.window, profile=run.profile,
                              kernel_calls=run.kernel_calls, peak=run.peak_bytes))


@pytest.mark.parametrize("workload", ["pretrain-packed-b96", "score-b1024"])
def test_bench_traced_program_segment_leaves_the_other_readings(workload, monkeypatch):
    """A `--trace 1` run on the CPU (the existing traced steps' device sync
    made a no-op), then every per-layer metric of the cell read as the
    result line reads them: the first new reader runs the program segment,
    every new metric reads a number, and the spans, window, profile, kernel
    calls and peak stay as the entry left them."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    from benchmark.lib import harness
    run = tiny_run(workload, trace=True, traffic=dict(records=8, batch_size=4),
                   cell=dict(warmup_steps=1))
    driver = importlib.import_module(f"benchmark.drivers.{run.spec.traffic['driver']}")
    try:
        driver.run_cell(run, device="cpu")
        before = _snap(run)
        assert before["kernel_calls"]
        assert not hasattr(run, "program_trace")
        values = {m["name"]: harness.read_metric(m["name"], run)
                  for m in run.spec.per_layer()}
        assert _snap(run) == before
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    # the CPU trace has no device operations: only the host spans' metrics read
    host = [n for n in values if n.startswith(("data.wire", "data.pin", "data.h2d"))]
    assert len(host) == (0 if workload == "pretrain-packed-b96" else 3)
    for name in host:
        assert values[name] > 0, name
    reading = program_trace.analyse(run.program_trace)
    assert reading["kernels"] == 0
    assert reading["bound_s"] > 0
    if workload == "pretrain-packed-b96":
        assert run.program_trace["n_steps"] == 2          # one epoch of 8 records at B4
        for key in ("k3m.fit", "k3m.epoch", "k3m.step", "k3m.forward", "k3m.backward",
                    "k3m.update", "k3m.sync", "k3m.data_wait", "k3m.stage"):
            assert reading["host_ms"][key] > 0, key
    else:
        for key in ("k3m.stage.wire", "k3m.stage.pin", "k3m.stage.h2d"):
            assert reading["host_ms"][key] > 0
