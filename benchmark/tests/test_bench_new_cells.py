"""The DeepSeek-V2 cell and the four-card cell on the CPU at a tiny width:
a sound run of each comes out correct; a held expert's output dropped in
the program reads on `expert_gap`; the four-card cell's ranks (gloo
processes) keep equal parameters; and its blocked reference equals one
process's reference on the whole batch."""

from __future__ import annotations

import contextlib

import torch

from benchmark.tests.helpers import run_on_cpu, tiny_run

DSV2 = dict(hidden_size=64, num_attention_heads=4, intermediate_size=96, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=24,
            n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
            experts_held=[0, 4])
# a dozen warm-up steps, as test_bench_correct.py takes them
MOE = dict(traffic=dict(records=8, batch_size=4), cell=dict(warmup_steps=12))


def _moe(**kw):
    run = tiny_run("pretrain-dsv2lite-ep8-b16", **MOE, **kw)
    run.spec.config = dict(run.spec.config, **DSV2)
    return run_on_cpu(run)


def test_bench_sound_dsv2_run_is_correct():
    """Every number within its limit but `after_change_gap`, whose limit is
    the cell's at hidden 2048 (sound 0.007-0.017 there): at hidden 64 one
    bf16 step moves a leaf's update by up to ~0.09 of it, which the test
    holds to 0.15."""
    run = _moe()
    checks = {c["name"]: c for c in run.checks}
    assert len(checks) == 10
    late = checks.pop("after_change_gap")
    assert late["value"] <= 0.15
    assert all(c["value"] <= c["limit"] for c in checks.values()), run.checks


@contextlib.contextmanager
def dropped_expert():
    """The program's first held expert's rows left out of its GEMMs."""
    from k3m_tpu_torch.model import deepseek
    saved = deepseek.route

    def route(idx, e0, e1):
        tok, inv, offs, valid, counts = saved(idx, e0, e1)
        return tok, inv, offs, valid & (torch.arange(valid.numel()) >= offs[0]), counts

    deepseek.route = route
    try:
        yield
    finally:
        deepseek.route = saved


def test_bench_dsv2_dropped_expert_reads_on_expert_gap():
    with dropped_expert():
        run = _moe()
    checks = {c["name"]: c["value"] for c in run.checks}
    assert checks["expert_gap"] > 0.9 and not run.correct


def test_bench_dp4_ranks_run_correct_on_gloo():
    """Four gloo processes of two rows each, the reference in blocks."""
    run = run_on_cpu(tiny_run("pretrain-packed-dp4", traffic=dict(records=32, batch_size=2),
                              seconds=0.3))
    assert run.correct, run.checks
    assert run.window["work"] % 4 == 0 and run.window["failed"] == 0


def test_bench_blocked_reference_is_one_process():
    """reference/check_pretrain_dp.py's blocks give one process's losses and
    gradients on the whole batch (fp32 sums in another order)."""
    from benchmark.lib import synthetic, weights
    from benchmark.drivers import pretrain
    from benchmark.reference import check_pretrain, check_pretrain_dp, inputs
    from benchmark.reference.k3m_plain import rand
    from k3m_tpu_torch.train.pretrain_loop import BATCH_KEYS
    from k3m_tpu_torch.train.trainer import stage_arrays
    run = tiny_run("pretrain-packed-dp4", traffic=dict(records=16, batch_size=8))
    cfg = pretrain.program_config(run.spec.config)
    path = f"{run.tmp}/r.k3mr"
    synthetic.write_pretrain_records(path, run.seed, 16)
    arrays = next(iter(pretrain.make_loader(run, cfg, path, run.spec.traffic)))
    staged = stage_arrays(arrays, BATCH_KEYS, torch.device("cpu"), cfg, "fp")
    _, (ref_arrays,) = inputs.pretrain_inputs(run.seed, 16, [staged], run.spec.traffic)
    got = []
    for blocks in (1, 4):
        model = check_pretrain_dp._model(run.spec.config, "cpu", False)
        weights.fill_weights(model, run.seed, 0.02)
        batch = inputs.to_device(ref_arrays, "cpu")
        if blocks == 1:
            out = model(batch, deterministic=False, rng=rand.StepRandom(run.seed, 0, "cpu"))
            loss, metrics = check_pretrain.total_loss(out)
            loss.backward()
        else:
            metrics = check_pretrain_dp.blocked_step(model, batch, run.seed, 0, blocks, "cpu")
        got.append(({k: float(v) for k, v in metrics.items()},
                    {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
    (l1, g1), (l4, g4) = got
    assert all(abs(l1[k] - l4[k]) <= 1e-5 * abs(l1[k]) for k in l1)
    assert set(g1) == set(g4)
    for n in g1:
        assert float((g1[n] - g4[n]).abs().max()) <= 1e-5 * float(g1[n].abs().max()) + 1e-6, n


def test_bench_dp4_after_readings_read_the_control_and_a_lost_rank():
    """readings_dp.after_readings at a tiny width: the state of the blocked
    reference, then the control's and rank_lost's after_... numbers against
    the sound step from it; a lost rank moves the trunk's gradients."""
    from benchmark import readings_dp
    run = tiny_run("pretrain-packed-dp4", traffic=dict(records=64, batch_size=2),
                   cell=dict(check_steps=2))
    out = readings_dp.after_readings(run.spec, run.seed, torch.device("cpu"))
    assert out["after_batch_mismatch"] == 0 and out["state_updates"] == 2
    for side in ("control", "rank_lost"):
        assert {"after_grad_distance", "after_trunk_distance",
                "after_change_gap"} <= set(out[side])
    assert out["rank_lost"]["after_trunk_distance"] > out["control"]["after_grad_distance"]
