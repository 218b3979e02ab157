"""The readings that a data-parallel pretraining cell's limits are set from
beside its own runs (which read the program): on one card, the reference
of reference/check_pretrain_dp.py on the global batches that the ranks'
shard loaders stage for the seed, against

  * control     the same blocked reference one precision below the
                configuration (reference/control.py), all the checked
                steps;
  * rank_lost   one rank's gradient left out of the sum (the last block's
                trunk gradient missing), its first gradient.

With `--after`, the `after_...` numbers of both, at the cell's size: from
the state the fp32 blocked reference reaches after a step on each of the
first `check_steps` global batches (parameters, AdamW moments and step
count, in the shape of the program's state after its window), the sound
reference's step on the next global batch against the control's and
rank_lost's steps from the same state. The program's own `after_...`
numbers come from the cell's runs, on four cards.

    python3 -m benchmark.readings_dp --workload pretrain-packed-dp4 --seeds 1 2 [--after]

from the root of a checkout, on a card. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.lib import harness, synthetic  # noqa: E402
from benchmark.reference import check_pretrain, check_pretrain_dp as check  # noqa: E402
from benchmark.reference import inputs  # noqa: E402


def global_batches(run, n: int):
    """The first `n` global batches, as the ranks' loaders stage them (the
    `fp` wire on the host), the ranks' rows in rank order."""
    from k3m_tpu_torch import dist
    from k3m_tpu_torch.train.pretrain_loop import BATCH_KEYS
    from k3m_tpu_torch.train.trainer import stage_arrays
    from benchmark.drivers import pretrain, pretrain_dp
    spec, size = run.spec, run.spec.chips
    cfg = pretrain.program_config(spec.config)
    path = f"{run.tmp}/train_feat.k3mr"
    synthetic.write_pretrain_records(path, run.seed, spec.traffic["records"])
    cpu = torch.device("cpu")
    per_rank = []
    for r in range(size):
        loader = pretrain_dp.make_loader(run, cfg, path, spec.traffic,
                                         dist.World(rank=r, size=size, device=cpu))
        it = iter(loader)
        per_rank.append([stage_arrays(next(it), BATCH_KEYS, cpu, cfg, spec.traffic["wire"])
                         for _ in range(n)])
    return [{k: torch.cat([rank[i][k] for rank in per_rank]) for k in per_rank[0][i]}
            for i in range(n)]


def numbers(side: dict, ref: dict) -> dict:
    out = check.first_numbers(side)
    if "change" in side:
        out["change_gap"] = check_pretrain.gaps(side, ref)["change_gap"]
    return out


def readings(spec, seed: int, device) -> dict:
    import shutil
    run = harness.Run(spec, seed, 0.0, False)
    try:
        traffic, blocks = spec.traffic, spec.chips
        staged = global_batches(run, spec.cell["check_steps"])
        bad, batches = inputs.pretrain_inputs(seed, traffic["records"], staged, traffic)
        vectors = {}
        ref = check.reference_steps(spec.config, seed, traffic, batches, blocks, device,
                                    keep=vectors)
        out = dict(seed=seed, batch_mismatch=bad)
        ctl = check.reference_steps(spec.config, seed, traffic, batches, blocks, device,
                                    control=True, against=vectors)
        out["control"] = numbers(ctl, ref)
        lost = check.reference_steps(spec.config, seed, traffic, batches, blocks, device,
                                     against=vectors, steps=1, drop_block=blocks - 1)
        out["rank_lost"] = numbers(lost, ref)
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def reference_state(config: dict, seed: int, traffic: dict, batches, blocks: int,
                    device) -> dict:
    """The fp32 blocked reference's state after a step on each of
    `batches`, as drivers/pretrain.py `after_window_step` keeps the
    program's: each leaf's parameter and AdamW moments on the host, the
    step count that keys the next step's draws, the updates made."""
    from benchmark.lib import weights
    from benchmark.reference import inputs as ref_inputs
    from benchmark.reference.k3m_plain import optim
    model = check._model(config, device, False)
    weights.fill_weights(model, seed, config["initializer_range"])
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    named = list(model.named_parameters())
    for step, arrays in enumerate(batches):
        model.train()
        check.blocked_step(model, ref_inputs.to_device(arrays, device), seed, step, blocks,
                           device)
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)

    def host(t):
        return t.detach().to("cpu", torch.float32, copy=True)

    out = dict(step=len(batches), updates=len(batches),
               before={n: dict(param=host(p), exp_avg=host(opt.state[p]["exp_avg"]),
                               exp_avg_sq=host(opt.state[p]["exp_avg_sq"]))
                       for n, p in named})
    del opt, model, named
    check._free(device)
    return out


def after_readings(spec, seed: int, device) -> dict:
    """The `after_...` numbers of the control and of rank_lost (module
    docstring) on `seed`."""
    import shutil
    run = harness.Run(spec, seed, 0.0, False)
    try:
        traffic, blocks, n = spec.traffic, spec.chips, spec.cell["check_steps"]
        staged = global_batches(run, n + 1)
        bad, batches = inputs.pretrain_inputs(seed, traffic["records"], staged, traffic)
        state = reference_state(spec.config, seed, traffic, batches[:n], blocks, device)
        ref = check.reference_after(spec.config, seed, traffic, batches[n], state, blocks,
                                    device)
        out = dict(seed=seed, after_batch_mismatch=bad, state_updates=n)
        ctl = check.reference_after(spec.config, seed, traffic, batches[n], state, blocks,
                                    device, control=True)
        out["control"] = check_pretrain.after_gaps(ctl, ref)
        del ctl
        lost = check.reference_after(spec.config, seed, traffic, batches[n], state, blocks,
                                     device, drop_block=blocks - 1)
        out["rank_lost"] = check_pretrain.after_gaps(lost, ref)
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings_dp")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--after", action="store_true",
                   help="the after_... numbers of the control and rank_lost")
    args = p.parse_args(argv)
    harness.set_cache_dirs(Path.cwd())
    spec = harness.Spec(args.workload, Path.cwd())
    for seed in args.seeds:
        line = (after_readings if args.after else readings)(spec, seed, torch.device("cuda"))
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
