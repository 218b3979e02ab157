"""The port's span recorder (k3m_tpu_torch/utils/trace.py) on the CPU, at
MICRO geometry, over a two-step `PretrainTrainer.fit`:

  * with recording off nothing is recorded and `record_function` is never
    entered;
  * the spans nest as k3m.fit > k3m.epoch > k3m.step > {k3m.forward,
    k3m.backward, k3m.update, k3m.sync}, beside k3m.data_wait, with
    k3m.stage and its three children on the producer thread;
  * each span is a `user_annotation` of a torch.profiler trace, nested
    alike, whose start lies within 1 ms of the span's entry on the trace's
    `baseTimeNanoseconds` clock: from the span's start (stamped before it
    enters `record_function`) to the moment `record_function` has been
    entered. The profiler stamps the annotation in between, and a thread
    switch or the OS may put milliseconds there on a loaded host;
  * the bound summed from the kernel spans' attributes equals the one
    the benchmark's call recorder (benchmark/lib/kernel_calls.py) sums
    over the same steps.
"""

import json
import threading
import time
from collections import Counter
from unittest import mock

import pytest
import torch

from k3m_tpu_torch.train.pretrain_loop import BATCH_KEYS, INJECT_KEYS, PretrainTrainer
from k3m_tpu_torch.train.trainer import allreduce_summary, wire_batch
from k3m_tpu_torch.train.wire import wire_bytes
from k3m_tpu_torch.utils import trace
from tests.conftest import MICRO, make_micro_batch
from tests.test_torch_modules import torch_config

STEP_CHILDREN = {"k3m.forward", "k3m.backward", "k3m.update", "k3m.sync"}
STAGE_CHILDREN = {"k3m.stage.wire", "k3m.stage.pin", "k3m.stage.h2d"}


def _trainer():
    return PretrainTrainer(torch_config(MICRO), device="cpu", seed=3, learning_rate=1e-3,
                           warmup_steps=0, total_steps=10)


def _batches():
    return [make_micro_batch(seed=i) for i in range(2)]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A two-step fit under torch.profiler (every thread), the recorder,
    the benchmark's call recorder, and when each `record_function` was
    entered, by thread and name in order."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from benchmark.lib import kernel_calls
    entered = {}

    class Stamped(torch.profiler.record_function):
        def __enter__(self):
            out = super().__enter__()
            entered.setdefault((threading.get_native_id(), self.name), []).append(
                time.time_ns())
            return out

    trainer = _trainer()
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        with mock.patch.object(torch.profiler, "record_function", Stamped), \
                kernel_calls.record() as calls, trace.recording() as rec:
            history = trainer.fit(_batches(), num_epochs=1, log_steps=0)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return dict(rec=rec, calls=calls, history=history, trainer=trainer, entered=entered,
                raw=json.loads(path.read_text()))


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    return kids


def test_recording_off_records_nothing_and_enters_no_record_function(traced, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    trainer, batch = traced["trainer"], _batches()[0]
    assert not trace.on() and trace.span("k3m.step") is trace.OFF
    trainer.train_step(batch)
    assert entered == []
    with trace.recording() as rec:
        trainer.train_step(batch)
    assert entered and rec.spans and not trace.on()


def test_fit_spans_nest_on_their_threads(traced):
    rec, spans = traced["rec"], traced["rec"].spans
    by_id = {s["id"]: s for s in spans}
    kids = _children(spans)
    (fit,) = [s for s in spans if s["parent"] is None and s["tid"] == rec.thread]
    assert fit["name"] == "k3m.fit"
    (epoch,) = kids[fit["id"]]
    assert epoch["name"] == "k3m.epoch" and epoch["attrs"] == {"epoch": 0}
    under_epoch = Counter(s["name"] for s in kids[epoch["id"]])
    # the third wait is the one that finds the loader done
    assert under_epoch == {"k3m.step": 2, "k3m.data_wait": 3}
    for step in (s for s in kids[epoch["id"]] if s["name"] == "k3m.step"):
        assert step["attrs"] == {"samples": 8}
        assert {s["name"] for s in kids[step["id"]]} == STEP_CHILDREN
        assert step["start_ns"] <= min(s["start_ns"] for s in kids[step["id"]])
        assert step["end_ns"] >= max(s["end_ns"] for s in kids[step["id"]])
    assert not any(s["name"].startswith("k3m.kernel.") for s in kids.get(None, [])
                   if s["tid"] == rec.thread)
    forward_kernels = [s for s in spans if s["name"] == "k3m.kernel.fused_attention"]
    assert forward_kernels and all(by_id[s["parent"]]["name"] == "k3m.forward"
                                   for s in forward_kernels)
    stages = [s for s in spans if s["name"] == "k3m.stage"]
    assert len(stages) == 2
    for stage in stages:
        assert stage["tid"] != rec.thread and stage["parent"] is None
        # one span a phase, over every array of the batch
        assert Counter(s["name"] for s in kids[stage["id"]]) \
            == Counter(sorted(STAGE_CHILDREN))
        wire, pin, h2d = sorted(kids[stage["id"]], key=lambda s: s["start_ns"])
        assert (wire["name"], pin["name"], h2d["name"]) \
            == ("k3m.stage.wire", "k3m.stage.pin", "k3m.stage.h2d")
    trainer = traced["trainer"]
    wired = wire_batch(_batches()[0], BATCH_KEYS + INJECT_KEYS, trainer.config, trainer.wire)
    assert {s["attrs"]["bytes"] for s in stages} == {wire_bytes(wired)}


def test_spans_are_annotations_of_the_profiler_trace(traced):
    rec, raw = traced["rec"], traced["raw"]
    base = raw["baseTimeNanoseconds"]
    notes = {}
    for e in raw["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("k3m."):
            notes.setdefault((e["tid"], e["name"]), []).append(e)
    mine = {}
    for s in rec.spans:
        mine.setdefault((s["tid"], s["name"]), []).append(s)
    assert set(mine) == set(notes)
    note_of = {}
    for key, spans in mine.items():
        spans = sorted(spans, key=lambda s: s["start_ns"])
        theirs = sorted(notes[key], key=lambda e: e["ts"])
        entered = sorted(traced["entered"][key])
        assert len(spans) == len(theirs) == len(entered), key
        for s, e, t_in in zip(spans, theirs, entered):
            # within 1 ms of the span's entry, [start, record_function entered]
            assert (s["start_ns"] - base) * 1e-3 - 1000.0 < e["ts"] \
                < (t_in - base) * 1e-3 + 1000.0, key
            note_of[s["id"]] = e
    for s in rec.spans:
        if s["parent"] is not None:
            inner, outer = note_of[s["id"]], note_of[s["parent"]]
            assert outer["ts"] <= inner["ts"]
            assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_kernel_span_bounds_equal_the_call_recorder(traced):
    from benchmark.lib import program_trace
    calls = traced["calls"]
    assert not calls.missing
    kernel_spans = [s for s in traced["rec"].spans if s["name"].startswith("k3m.kernel.")]
    assert Counter(s["name"].removeprefix("k3m.kernel.") for s in kernel_spans) \
        == Counter(f for f, _ in calls.calls)
    by_span = program_trace.bound_seconds(traced["rec"])
    assert by_span > 0
    assert by_span == pytest.approx(sum(b for _, b in calls.calls), rel=1e-12)


def test_spanned_binds_arguments_only_while_recording():
    seen = []

    @trace.spanned("k3m.kernel.example", arguments=True)
    def example(x, rate, dtype=torch.float32, *, for_backward=False):
        """doc"""
        seen.append(trace.on())
        return x * rate

    assert example.__doc__ == "doc" and example.__name__ == "example"
    x = torch.ones(2, 3, dtype=torch.bfloat16)
    assert example(x, 2.0).sum() == 12 and seen == [False]
    with trace.recording() as rec:
        example(x, 0.5, for_backward=True)
    (span,) = rec.spans
    assert span["name"] == "k3m.kernel.example" and span["parent"] is None
    assert span["attrs"] == dict(x=dict(shape=[2, 3], dtype="bfloat16"), rate=0.5,
                                 for_backward=True)

    @trace.spanned("k3m.step")
    def step(n):
        return n + 1

    with trace.recording() as rec:
        assert step(1) == 2
    assert [(s["name"], s["attrs"]) for s in rec.spans] == [("k3m.step", {})]


def test_allreduce_summary():
    assert allreduce_summary([(8, None), (8, None)]) == {"allreduce_bytes": [8, 8]}
    assert allreduce_summary([(8, 0.5), (0, 0.0)]) == {"allreduce_bytes": [8, 0],
                                                       "allreduce_seconds": [0.5, 0.0]}
