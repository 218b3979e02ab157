"""The readings that a cell's limits are set from, apart from the
benchmark's own runs: the control (the reference in fp8 in the program's
place, reference/control.py) and the faults planted in the reference put
in the program's place, each against the fp32 reference, at the cell's
own size, on the given seeds.

    python3 -m benchmark.readings --workload <name> --seeds 1 2 3 [--full N]
        [--after SECONDS]

from the root of a checkout, on a card. Prints one JSON line a seed. For a
pretraining cell the inputs are the first staged batches of the program's
own loader for that seed, as a run's set-up sees them, or with `--after`
the step after a window of that length, from the state it left; the
control and the faults are read on the first N seeds (`--full`). For a
scoring cell, the run's sample of pairs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.lib import harness  # noqa: E402
from benchmark.reference import check_pretrain, check_score, inputs  # noqa: E402


def half_batch(arrays):
    """The fault 'half of the batch left out, the mean taken over the
    rest': the batch's first half of rows."""
    n = arrays["input_ids"].shape[0] // 2
    return {k: v[:n] for k, v in arrays.items()}


def leaf_distances(got: dict, ref: dict, moved) -> dict:
    """||got - ref|| / ||ref|| of each leaf in `moved`."""
    return {n: float((got[n].float() - ref[n].float()).norm()
                     / ref[n].float().norm().clamp(min=1e-30)) for n in moved}


def vector_gaps(got: dict, ref: dict, moved) -> dict:
    """Per-leaf distances ||got - ref|| / ||ref|| of the leaves `moved`:
    their median, their largest, their least, and the trunk's least leaf
    of each role (reference/check_pretrain.py `trunk_distance`)."""
    import statistics
    d = leaf_distances(got, ref, moved)
    q = statistics.quantiles(d.values(), n=10)
    best = sorted(d, key=d.get)[:5]
    roles = check_pretrain.role_least(d, moved)
    return dict(median=statistics.median(d.values()), worst=max(d.values()),
                worst_leaf=max(d, key=d.get), p10=q[0], p30=q[2], least=min(d.values()),
                least_leaves={n: d[n] for n in best}, trunk=max(roles.values()),
                trunk_role=max(roles, key=roles.get), roles=roles)


@contextlib.contextmanager
def backward_fault(name: str):
    """A backward kernel's fault planted in the reference: the attention
    backward's dq doubled or dk negated (self- and co-attention), or the
    LayerNorm backward's dx doubled."""
    from benchmark.reference.k3m_plain import attention, layernorm
    if name == "ln_dx_doubled":
        saved, mod, attr = layernorm.layernorm_bwd_plain, layernorm, "layernorm_bwd_plain"

        def broken(*a, **kw):
            dx, ds, db = saved(*a, **kw)
            return 2 * dx, ds, db
    else:
        saved, mod, attr = attention.attention_bwd_plain, attention, "attention_bwd_plain"

        def broken(*a, **kw):
            dq, dk, dv = saved(*a, **kw)
            return (2 * dq, dk, dv) if name == "dq_doubled" else (dq, -dk, dv)
    setattr(mod, attr, broken)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


FAULTS = ("dq_doubled", "dk_negated", "ln_dx_doubled")


def pretrain_readings(spec, seed: int, device, full: bool = True) -> dict:
    """The program's checked steps and the reference's on the same
    batches, and with `full` the control's, the half-batch fault's and
    the backward faults' first step: the gaps of each, and the per-leaf
    distances of the first gradients (and of the program's changes)."""
    from benchmark.drivers import pretrain
    run = harness.Run(spec, seed, 0.0, False)
    try:
        cfg = pretrain.program_config(spec.config)
        trainer, loader, prog, _ = pretrain.set_up(run, device, cfg, spec.traffic,
                                                   keep_vectors=True)
        del trainer, loader
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return _compare(spec, seed, prog, device, full)
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def _compare(spec, seed: int, prog: dict, device, full: bool = True) -> dict:
    import statistics
    traffic = spec.traffic
    bad, batches = inputs.pretrain_inputs(seed, traffic["records"], prog["batches"], traffic)
    out = dict(seed=seed, batch_mismatch=bad)
    ref = check_pretrain.reference_steps(spec.config, seed, traffic, batches, device,
                                         keep_vectors=True)
    med = statistics.median(ref["grad1"].values())
    moved = [n for n, r in ref["grad1"].items() if r >= check_pretrain.MOVED * med]
    out["program"] = dict(check_pretrain.gaps(prog, ref),
                          grad1_distance=vector_gaps(prog["grad1_vectors"],
                                                     ref["grad1_vectors"], moved),
                          change_distance=vector_gaps(prog["change_vectors"],
                                                      ref["change_vectors"], moved))
    if not full:
        return out
    first = batches[:1]
    sides = [("control", first, dict(control=True), contextlib.nullcontext()),
             ("half_batch", [half_batch(b) for b in first], {}, contextlib.nullcontext())]
    sides += [(f, first, {}, backward_fault(f)) for f in FAULTS]
    for name, bs, kw, ctx in sides:
        with ctx:
            got = check_pretrain.reference_steps(spec.config, seed, traffic, bs, device,
                                                 keep_vectors=True, **kw)
        out[name] = dict(grad1_distance=vector_gaps(got["grad1_vectors"],
                                                    ref["grad1_vectors"], moved))
        del got
    return out


def after_readings(spec, seed: int, device, seconds: float, full: bool = True) -> dict:
    """The step after a window of `seconds` (drivers/pretrain.py
    `after_window_step`) followed from the program's state by the
    reference, and with `full` by the control, the half-batch fault and
    the backward faults from the same state: the `after_...` numbers of
    each against the reference (a state left unchanged reads 1 on
    `after_change_gap` by its definition, and needs no run)."""
    from benchmark.drivers import pretrain
    run = harness.Run(spec, seed, seconds, False)
    try:
        traffic = spec.traffic
        cfg = pretrain.program_config(spec.config)
        trainer, loader, _, epoch = pretrain.set_up(run, device, cfg, traffic)
        got = pretrain.fit_steps(run, trainer, loader, epoch, seconds=seconds)
        after = pretrain.after_window_step(run, trainer, loader, epoch + got["epochs"])
        del trainer, loader
        if device.type == "cuda":
            torch.cuda.empty_cache()
        bad, (arrays,) = inputs.pretrain_inputs(seed, traffic["records"], [after["batch"]],
                                                traffic)
        out = dict(seed=seed, window_steps=got["steps"], step=after["step"],
                   after_batch_mismatch=bad)
        ref = check_pretrain.reference_after(spec.config, seed, traffic, arrays, after, device)
        out["program"] = check_pretrain.after_gaps(after, ref)
        if not full:
            return out
        sides = [("control", arrays, dict(control=True)),
                 ("half_batch", half_batch(arrays), {})]
        sides += [(f, arrays, dict(with_grad=lambda f=f: backward_fault(f))) for f in FAULTS]
        for name, a, kw in sides:
            side = check_pretrain.reference_after(spec.config, seed, traffic, a, after, device,
                                                  **kw)
            out[name] = check_pretrain.after_gaps(side, ref)
            del side
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def program_scores(spec, seed: int, arrays: dict, device):
    """The program's answers to the pairs of `arrays` (host arrays, as its
    loader makes them), through the timed path's staging and forward."""
    from benchmark.drivers import score
    from k3m_tpu_torch.train.alignment_loop import batch_to_device, forward
    run = harness.Run(spec, seed, 0.0, False)
    shutil.rmtree(run.tmp, ignore_errors=True)
    cfg = score.program_config(spec.config)
    model = score.make_model(run, cfg, device)
    e1, e2, p, _ = forward(model, batch_to_device(arrays, device, cfg, spec.traffic["wire"]))
    out = e1.float().cpu(), e2.float().cpu(), p.float().cpu()
    del model
    torch.cuda.empty_cache()
    return out


def score_readings(spec, seed: int, device) -> dict:
    traffic = spec.traffic
    sample = check_score.sample_pairs(seed, traffic["records"], spec.cell["check_pairs"])
    arrays = inputs.pair_inputs(seed, sample, traffic)
    ref = check_score.reference_scores(spec.config, seed, arrays, device)[:3]
    ctl = check_score.reference_scores(spec.config, seed, arrays, device, control=True)[:3]
    prog = program_scores(spec, seed, arrays, device)
    return dict(seed=seed, program=check_score.all_gaps(prog, ref),
                control=check_score.all_gaps(ctl, ref))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--full", type=int, default=None,
                   help="pretraining: read the control and the faults on the first FULL "
                        "seeds only (default: every seed)")
    p.add_argument("--after", type=float, default=None,
                   help="pretraining: read the step after a window of AFTER seconds "
                        "(after_readings) in place of the checked steps")
    args = p.parse_args(argv)
    harness.set_cache_dirs(Path.cwd())
    spec = harness.Spec(args.workload, Path.cwd())
    device = torch.device("cuda")
    read = dict(pretrain=pretrain_readings, score=score_readings)[spec.traffic["driver"]]
    for i, seed in enumerate(args.seeds):
        kw = {} if args.full is None or read is score_readings else dict(full=i < args.full)
        if args.after is not None:
            print(json.dumps(after_readings(spec, seed, device, args.after, **kw)), flush=True)
        else:
            print(json.dumps(read(spec, seed, device, **kw)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
