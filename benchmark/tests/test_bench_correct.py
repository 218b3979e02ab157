"""`correct` on the CPU at a tiny width: a sound run of each cell comes out
correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have. The control (the
reference in the program's place, one precision below) comes out not
correct against the cell's limits."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark.tests.helpers import run_on_cpu, tiny_run

# a dozen warm-up steps, so that the step after the window follows AdamW's
# first steps, as it does in the cell (after some 80 steps): in the first
# few, one step's gradient sets the update nearly alone
PRETRAIN = dict(traffic=dict(records=8, batch_size=4), cell=dict(warmup_steps=12))
SCORE = dict(traffic=dict(records=8, batch_size=4), cell=dict(check_pairs=6))


def _pretrain(**kw):
    return run_on_cpu(tiny_run("pretrain-packed-b96", **PRETRAIN, **kw))


def _score(**kw):
    return run_on_cpu(tiny_run("score-b1024", **SCORE, **kw))


def test_bench_sound_pretrain_run_is_correct():
    run = _pretrain()
    assert run.correct, run.checks
    assert run.window["attempted"] >= 1 and run.window["failed"] == 0


def test_bench_sound_score_run_is_correct():
    run = _score()
    assert run.correct, run.checks
    assert run.window["work"] >= 4


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _state_unchanged():
    from k3m_tpu_torch.train.trainer import Trainer
    orig = Trainer.update

    def update(self):
        saved = [p.detach().clone() for p in self.model.parameters()]
        out = orig(self)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return out
    return patched(Trainer, "update", update)


def _half_batch():
    from k3m_tpu_torch.train import pretrain_loop

    def rows(tree, sl):
        n = tree["input_ids"].shape[0] // 2
        return {k: v[:n] for k, v in tree.items()}
    return patched(pretrain_loop, "batch_rows", rows)


def _token_altered():
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    orig = PretrainTrainer.stage

    def stage(self, batch):
        out = dict(orig(self, batch))
        ids = out["input_ids"].clone()
        ids[0, 1] = (ids[0, 1] + 1) % 21128
        out["input_ids"] = ids
        return out
    return patched(PretrainTrainer, "stage", stage)


def _attention_backward(name):
    """The program's attention backward (#4, which the co-attention's
    backward calls too) with dq doubled or dk negated."""
    from k3m_tpu_torch.kernels import attention, coattn
    orig = attention.attention_bwd

    def attention_bwd(*args, **kwargs):
        dq, dk, dv = orig(*args, **kwargs)
        return (2 * dq, dk, dv) if name == "dq_doubled" else (dq, -dk, dv)
    stack = contextlib.ExitStack()
    stack.enter_context(patched(attention, "attention_bwd", attention_bwd))
    stack.enter_context(patched(coattn, "attention_bwd", attention_bwd))
    return stack


def _ln_dx_doubled():
    """The program's LayerNorm backward (#2) with dx doubled."""
    from k3m_tpu_torch.kernels import layernorm
    orig = layernorm.layernorm_bwd

    def layernorm_bwd(*args, **kwargs):
        dx, dscale, dbias = orig(*args, **kwargs)
        return 2 * dx, dscale, dbias
    return patched(layernorm, "layernorm_bwd", layernorm_bwd)


def _state_unchanged_after_set_up():
    """Updates that stop once the set-up's steps are done: the window's
    steps and the one after it leave the parameters as they are."""
    from k3m_tpu_torch.train.trainer import Trainer
    orig = Trainer.update
    set_up_steps = 3 + PRETRAIN["cell"]["warmup_steps"]

    def update(self):
        if self.step < set_up_steps:
            return orig(self)
        self.step += 1
        self.opt.zero_grad(set_to_none=True)
        return None
    return patched(Trainer, "update", update)


PRETRAIN_FAULTS = {"state_unchanged": _state_unchanged,
                   "state_unchanged_after_set_up": _state_unchanged_after_set_up,
                   "half_batch": _half_batch,
                   "token_altered": _token_altered,
                   "dq_doubled": lambda: _attention_backward("dq_doubled"),
                   "dk_negated": lambda: _attention_backward("dk_negated"),
                   "ln_dx_doubled": _ln_dx_doubled}


@pytest.mark.parametrize("fault", list(PRETRAIN_FAULTS))
def test_bench_pretrain_fault_is_not_correct(fault):
    with PRETRAIN_FAULTS[fault]():
        run = _pretrain()
    assert not run.correct, run.checks


def _answer_altered():
    from k3m_tpu_torch.train import alignment_loop
    orig = alignment_loop.forward

    def forward(model, batch, world=None):
        e1, e2, p, loss = orig(model, batch, world)
        e1 = e1.clone()
        e1[0, 0] += 0.5 * float(e1.abs().max())
        return e1, e2, p, loss
    return patched(alignment_loop, "forward", forward)


def _half_answered():
    from k3m_tpu_torch.train import alignment_loop
    orig = alignment_loop.forward

    def forward(model, batch, world=None):
        n = batch["label"].shape[0] // 2
        half = dict(label=batch["label"][:n],
                    item1={k: v[:n] for k, v in batch["item1"].items()},
                    item2={k: v[:n] for k, v in batch["item2"].items()})
        return orig(model, half, world)
    return patched(alignment_loop, "forward", forward)


@pytest.mark.parametrize("fault", ["answer_altered", "half_answered"])
def test_bench_score_fault_is_not_correct(fault):
    with {"answer_altered": _answer_altered, "half_answered": _half_answered}[fault]():
        run = _score()
    assert not run.correct, run.checks


# the full widths at two layers a stack: the control's distance from the
# reference grows with the width of its products, so the tiny width does
# not show it
WIDE_SHALLOW = dict(num_hidden_layers=2, v_num_hidden_layers=2, v_biattention_id=[1],
                    t_biattention_id=[1])


def _wide_shallow(workload, traffic, cell=None):
    from benchmark.lib import harness
    spec = harness.Spec(workload)
    spec.config = dict(spec.config, **WIDE_SHALLOW)
    spec.traffic = dict(spec.traffic, **traffic)
    spec.cell = dict(spec.cell, **(cell or {}))
    return spec


def test_bench_pretrain_control_reads_far_from_the_reference():
    """The control reads the separating number (the least leaf's first
    gradient distance) at least three times as far from the reference as
    the program; at the cell's own size on the card it reads 7x and fails
    the cell's limit (PERF.md). Each backward fault planted in the
    reference fails the trunk's number, which the program passes."""
    from benchmark.readings import FAULTS, pretrain_readings
    spec = _wide_shallow("pretrain-packed-b96", dict(records=4, batch_size=2))
    got = pretrain_readings(spec, 2 ** 31 + 5, torch.device("cpu"))
    limits = spec.cell["limits"]
    program, control = got["program"], got["control"]
    assert program["grad1_distance"]["least"] <= limits["grad_distance"]
    assert control["grad1_distance"]["least"] >= 3 * program["grad1_distance"]["least"]
    assert got["half_batch"]["grad1_distance"]["least"] > limits["grad_distance"]
    assert program["grad1_distance"]["trunk"] <= limits["trunk_distance"]
    for fault in FAULTS:
        assert got[fault]["grad1_distance"]["trunk"] > limits["trunk_distance"], fault


def test_bench_score_control_is_not_correct():
    from benchmark.readings import score_readings
    spec = _wide_shallow("score-b1024", dict(records=4, batch_size=4), dict(check_pairs=2))
    got = score_readings(spec, 2 ** 31 + 5, torch.device("cpu"))
    limit = spec.cell["limits"]["emb_l2_gap"]
    assert got["program"]["emb_l2_gap"] <= limit < got["control"]["emb_l2_gap"]


@pytest.mark.cuda
def test_bench_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "score-b1024",
                          "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
