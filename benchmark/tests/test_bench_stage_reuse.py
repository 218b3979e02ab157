"""The readers of the slot pool's reuse share on a hand-made program
segment whose `k3m.stage` spans carry `slot_reused`, and their silence
where no span carries it."""

from __future__ import annotations

import pytest

from benchmark.lib import harness


class _Recorder:
    def __init__(self, spans):
        self.spans = spans


def _stage(i, **attrs):
    return dict(id=i, name="k3m.stage", tid=2, parent=None, start_ns=i, end_ns=i + 1,
                attrs=dict(bytes=1024, **attrs))


def _segment(reused):
    spans = [_stage(i, **({} if r is None else dict(slot_reused=r)))
             for i, r in enumerate(reused)]
    spans.append(dict(id=99, name="k3m.stage.pin", tid=2, parent=0, start_ns=0, end_ns=1,
                      attrs={}))
    return dict(result=None, n_steps=len(reused), recorder=_Recorder(spans), base_ns=0,
                events=[])


@pytest.mark.parametrize("workload, metric, other", [
    ("score-b1024", "data.stage_reuse_share.score", "data.stage_reuse_share.train"),
    ("pretrain-packed-b96", "data.stage_reuse_share.train", "data.stage_reuse_share.score")])
def test_bench_stage_reuse_share_reads_the_stage_spans(workload, metric, other):
    run = harness.Run(harness.Spec(workload), 1, 30.0, True)
    assert metric in {m["name"] for m in run.spec.per_layer()}
    run.program_trace = _segment([False, True, True, True])
    assert harness.read_metric(metric, run) == pytest.approx(75.0)
    assert harness.read_metric(other, run) is None          # the other entry kind
    run.program_trace = _segment([True] * 10)
    assert harness.read_metric(metric, run) == 100.0
    run.program_trace = _segment([None, None])              # a program without the pool
    assert harness.read_metric(metric, run) is None
    run.program_trace = None                                # no recorder at all
    assert harness.read_metric(metric, run) is None
