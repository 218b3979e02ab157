"""The readings that the DeepSeek-V2 text block's cell's limits are set
from, apart from the benchmark's own runs (benchmark/readings.py for this
cell): at the cell's own size, on the given seeds, each against the fp32
reference (reference/check_pretrain_moe.py) on the first staged batches of
the program's own loader for that seed,

  * program   the program's checked steps, as a run's set-up takes them;
  * control   the reference computed one precision below the configuration
              (reference/k3m_deepseek.py `lower_precision`) in the
              program's place;
  * faults    planted in the reference put in the program's place, its
              first gradient: `drop_expert` (the first held expert's output
              left out), `top5` (five experts a token, not six),
              `no_rope_k` (k_pe not rotated), `no_m2` (the softmax scale
              without YaRN's m^2).

    python3 -m benchmark.readings_moe --workload pretrain-dsv2lite-ep8-b16 \\
        --seeds 1 2 3 [--full N] [--after SECONDS]

from the root of a checkout, on a card. Prints one JSON line a seed. With
`--after`, the step after a window of that length is read instead (the
program's `after_...` numbers); the control and the faults on the first N
seeds (`--full`).
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
from benchmark.reference import check_pretrain_moe as check  # noqa: E402
from benchmark.reference import deepseek_plain as dsp  # noqa: E402
from benchmark.reference import inputs  # noqa: E402


@contextlib.contextmanager
def fault(name: str):
    """One of the module docstring's faults, planted in the plain layers."""
    saved = dict(expert=dsp.Experts.expert, route=dsp.MoE.route, rotate=dsp.rotate,
                 yarn=dsp.yarn)
    if name == "drop_expert":
        dsp.Experts.expert = lambda self, e, x: (0 * saved["expert"](self, e, x) if e == 0
                                                 else saved["expert"](self, e, x))
    elif name == "top5":
        def route(self, u):
            s = torch.softmax(self.gate(u.float()), dim=-1)
            w, idx = torch.topk(s, self.cfg.num_experts_per_tok - 1, dim=-1)
            return s, w, idx
        dsp.MoE.route = route
    elif name == "no_rope_k":
        def rotate(x, positions, inv_freq):
            return x if x.dim() == 3 else saved["rotate"](x, positions, inv_freq)
        dsp.rotate = rotate
    elif name == "no_m2":
        def yarn(cfg):
            inv_freq, _ = saved["yarn"](cfg)
            return inv_freq, (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
        dsp.yarn = yarn
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        dsp.Experts.expert, dsp.MoE.route = saved["expert"], saved["route"]
        dsp.rotate, dsp.yarn = saved["rotate"], saved["yarn"]


FAULTS = ("drop_expert", "top5", "no_rope_k", "no_m2")


def side_numbers(side: dict, ref: dict) -> dict:
    """grad_distance, trunk_distance, expert_gap, route_mismatch and the
    first step's largest relative loss gap of a side's first step against
    the reference's; with all the checked steps, change_gap too."""
    out = check.first_numbers(side)
    if "change" in side:
        out["change_gap"] = check.gaps(side, ref)["change_gap"]
    out["route_mismatch"] = check.route_mismatch(side["routes"], ref["routes"])
    out["loss_gap"] = max(abs(side["losses"][0][k] - ref["losses"][0][k])
                          / max(abs(ref["losses"][0][k]), 1e-12) for k in check.LOSS_KEYS)
    return out


def readings(spec, seed: int, device, full: bool = True) -> dict:
    from benchmark.drivers import pretrain, pretrain_moe
    run = harness.Run(spec, seed, 0.0, False)
    traffic = spec.traffic
    try:
        cfg = pretrain.program_config(spec.config)
        trainer, loader, prog, _ = pretrain_moe.set_up(run, device, cfg, traffic)
        del trainer, loader
        check._free(device)
        bad, batches = inputs.pretrain_inputs(seed, traffic["records"], prog["batches"],
                                              traffic)
        out = dict(seed=seed, batch_mismatch=bad)
        ref_vectors = {}
        ref = check.reference_steps(spec.config, seed, traffic, batches, device,
                                    against=prog.pop("grad1_vectors"), keep=ref_vectors)
        g = check.gaps(prog, ref)
        out["program"] = dict(check.first_numbers(ref), change_gap=g["change_gap"],
                              loss_gap=g["loss_gap"], grad_gap=g["grad_gap"],
                              route_mismatch=check.route_mismatch(prog["routes"], ref["routes"]))
        if not full:
            return out
        sides = [("control", dict(control=True))] + [(f, dict(fault=lambda f=f: fault(f),
                                                              steps=1)) for f in FAULTS]
        for name, kw in sides:
            side = check.reference_steps(spec.config, seed, traffic, batches, device,
                                         against=ref_vectors, **kw)
            out[name] = side_numbers(side, ref)
            del side
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def after_readings(spec, seed: int, device, seconds: float, full: bool = True) -> dict:
    """The program's step after a window of `seconds`, followed from its
    state by the reference: its `after_...` numbers; with `full` the
    control's from the same state too."""
    from benchmark.drivers import pretrain, pretrain_moe
    run = harness.Run(spec, seed, seconds, False)
    traffic = spec.traffic
    try:
        cfg = pretrain.program_config(spec.config)
        trainer, loader, _, epoch = pretrain_moe.set_up(run, device, cfg, traffic)
        got = pretrain.fit_steps(run, trainer, loader, epoch, seconds=seconds)
        after = pretrain_moe.after_window_step(run, trainer, loader, epoch + got["epochs"])
        del trainer, loader
        check._free(device)
        bad, (arrays,) = inputs.pretrain_inputs(seed, traffic["records"], [after["batch"]],
                                                traffic)
        ref_vectors = {}
        ref = check.reference_after(spec.config, seed, traffic, arrays, after, device,
                                    keep_state=full, keep=ref_vectors if full else None)
        out = dict(seed=seed, window_steps=got["steps"], after_batch_mismatch=bad,
                   program=check.after_gaps(after, ref))
        if full:
            ctl = check.reference_after(spec.config, seed, traffic, arrays, after, device,
                                        control=True, keep_state=True, against=ref_vectors)
            out["control"] = check.after_gaps(
                ctl, dict(ref, distance=ctl["distance"]))
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings_moe")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--full", type=int, default=None)
    p.add_argument("--after", type=float, default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs(Path.cwd())
    spec = harness.Spec(args.workload, Path.cwd())
    device = torch.device("cuda")
    for i, seed in enumerate(args.seeds):
        full = args.full is None or i < args.full
        if args.after is not None:
            line = after_readings(spec, seed, device, args.after, full=full)
        else:
            line = readings(spec, seed, device, full=full)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
