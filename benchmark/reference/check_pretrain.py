"""`correct` for a pretraining cell: the program's first steps, which
`fit` took in set-up, against the reference's steps from the same seed on
the same batches; then the step after the window (below).

Numbers compared, each against its limit from the cell file; one that the
cell file gives no limit is printed among the notes instead:
  batch_mismatch   elements of the staged batches that disagree with the
                   records (reference/inputs.py); limit 0
  loss_gap         the largest relative gap of a step's loss or of one of
                   its four terms
  grad_gap         the worst leaf's gap between the norms of its first
                   gradient, the program's read from AdamW's first moment,
                   over the larger of the reference's norm of that leaf
                   and of the median leaf
  change_gap       the same for each leaf's change over the steps, among
                   the leaves whose first reference gradient is at least a
                   thousandth of the median leaf's (below that a leaf moves
                   by round-off alone)
  grad_distance    the least, over those leaves, of the distance between
                   the program's first gradient and the reference's over
                   the reference's norm: the leaf that the model's discrete
                   choices (the hard Gumbel selection of the fusion, the
                   hinges of the structure loss) disturb least, so that
                   what is left is the precision of the arithmetic; the one
                   number that the control (reference/control.py) fails
                   by a wide margin, since a gap of norms cannot see
                   rounding, which moves a norm by its square
  trunk_distance   the same distance taken leaf by leaf in the trunk, whose
                   gradients pass through the backward kernels: for each
                   role of a leaf in the embeddings and the layer stacks
                   (its name with the layer number left out, as
                   `encoder.layer.*.attention.self.key.weight`), the
                   least distance over the layers that hold it; the
                   largest over the roles. A backward that returns a
                   gradient doubled or negated moves every layer's leaf
                   of some role, where the least leaf of the whole model
                   (the MLM decoder's bias, above every backward kernel)
                   would not see it

The step after the window (drivers/pretrain.py `after_window_step`) is
followed from the state the window left, the program's own: the reference
loads its parameters and AdamW moments, takes the step on the same staged
batch with the same draws, and the step is judged by the same kinds of
number, named `after_...`: `after_batch_mismatch`, `after_loss_gap`,
`after_grad_distance`, `after_trunk_distance` and `after_change_gap` (each
leaf's gap of change norms over the larger of the reference's and the
median leaf's, among the leaves that step's reference gradient moves).
"""

from __future__ import annotations

import contextlib
import gc
import re
import statistics
from typing import Dict, List

import torch

from benchmark.lib import weights
from benchmark.reference import inputs as ref_inputs

LOSS_KEYS = ("loss", "masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc")
MOVED = 1e-3
TRUNK = ("embeddings.", "v_embeddings.", "encoder.")


def role(name: str) -> str:
    """A leaf's role: its name with the layer number left out."""
    return re.sub(r"\.\d+\.", ".*.", name)


def role_least(distance: Dict[str, float], moved) -> Dict[str, float]:
    """For each role of the trunk's leaves among `moved`, the least
    distance over the layers that hold it."""
    out: Dict[str, float] = {}
    for n in moved:
        if n.startswith(TRUNK):
            r = role(n)
            out[r] = min(out.get(r, float("inf")), distance[n])
    return out


def reference_config(config: dict, control: bool = False):
    """The reference's configuration: float32, or for the control the
    configuration's own dtype (reference/control.py)."""
    from benchmark.reference.k3m_plain.config import K3MConfig
    cfg = K3MConfig.from_dict(config)
    return cfg if control else cfg.replace(dtype="float32")


def total_loss(out, loss_img_weight: float = 1.0):
    img = out["masked_img_loss"] * loss_img_weight
    loss = out["masked_lm_loss"] + img + out["masked_lm_loss_pv"] + out["loss_struc"]
    return loss, dict(loss=loss, masked_lm_loss=out["masked_lm_loss"], masked_img_loss=img,
                      masked_lm_loss_pv=out["masked_lm_loss_pv"],
                      loss_struc=out["loss_struc"])


def reference_steps(config: dict, seed: int, traffic: dict, batches: List[Dict], device,
                    control: bool = False, count_flops: bool = False,
                    keep_vectors: bool = False, against: Dict = None) -> Dict:
    """Losses, first gradient norms and changes of the reference's steps
    (fp32, TF32 off; the control in bf16 with fp8 products). `against`:
    first gradients (host tensors by name) whose distance to the
    reference's first gradient each leaf gives (`distance`)."""
    from benchmark.reference import control as ctl
    from benchmark.reference.k3m_plain import optim, pretrain, rand
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(config, control)
    with torch.device(device):
        model = pretrain.K3MForPretraining(cfg)
    weights.fill_weights(model, seed, cfg.initializer_range)
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    losses, grad1, flops, distance = [], None, None, None
    for step, arrays in enumerate(batches):
        batch = ref_inputs.to_device(arrays, device)
        model.train()
        with (ctl.lower_precision() if control else contextlib.nullcontext()):
            if count_flops and step == 0:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    out = model(batch, deterministic=False,
                                rng=rand.StepRandom(seed, step, device))
                flops = fc.get_total_flops() / batch["input_ids"].shape[0]
            else:
                out = model(batch, deterministic=False, rng=rand.StepRandom(seed, step, device))
            loss, metrics = total_loss(out)
            loss.backward()
        step_losses = torch.stack([metrics[k].detach().float() for k in LOSS_KEYS])
        del out, loss, metrics, batch
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses.append({k: float(v) for k, v in zip(LOSS_KEYS, step_losses)})
        if step == 0:
            grad1 = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
            if keep_vectors:
                grad1_vectors = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            if against is not None:
                distance = {n: float((against[n].to(p.grad.device, torch.float32) - p.grad).norm()
                                     / p.grad.norm().clamp(min=1e-30))
                            for n, p in model.named_parameters()}
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
    del opt
    names = [n for n, _ in model.named_parameters()]
    start = weights.initial_leaf(seed, cfg.initializer_range, model, names)
    params = dict(model.named_parameters())
    change = {n: float((params[n].detach() - start[n]).norm()) for n in names}
    vectors = {}
    if keep_vectors:
        vectors = dict(grad1_vectors=grad1_vectors,
                       change_vectors={n: (params[n].detach() - start[n]).cpu() for n in names})
    del start, params, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, grad1=grad1, change=change, flops_fwd_per_sample=flops,
                distance=distance, **vectors)


def reference_after(config: dict, seed: int, traffic: dict, arrays: Dict, after: Dict,
                    device, control: bool = False, with_grad=None) -> Dict:
    """The reference's step from the program's state `after["before"]`
    (parameters and AdamW moments by leaf) after `after["updates"]`
    updates, on the batch `arrays`, with the draws of step `after["step"]`:
    its losses, each leaf's gradient (host) and change (host). The
    control as in `reference_steps`; `with_grad` a context around the
    forward and backward (a planted fault)."""
    from benchmark.reference import control as ctl
    from benchmark.reference.k3m_plain import optim, pretrain, rand
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(config, control)
    with torch.device(device):
        model = pretrain.K3MForPretraining(cfg)
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    n = after["updates"]
    named = list(model.named_parameters())
    with torch.no_grad():
        for name, p in named:
            st = after["before"][name]
            p.copy_(st["param"])
            opt.state[p] = dict(step=torch.tensor(float(n)),
                                exp_avg=st["exp_avg"].to(device),
                                exp_avg_sq=st["exp_avg_sq"].to(device))
    sched.last_epoch = n
    for group, base, factor in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * factor(n)
    batch = ref_inputs.to_device(arrays, device)
    model.train()
    with (ctl.lower_precision() if control else contextlib.nullcontext()), \
            (with_grad() if with_grad is not None else contextlib.nullcontext()):
        out = model(batch, deterministic=False, rng=rand.StepRandom(seed, after["step"], device))
        loss, metrics = total_loss(out)
        loss.backward()
    losses = {k: float(metrics[k].detach()) for k in LOSS_KEYS}
    del out, loss, metrics, batch
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad = {name: p.grad.detach().float().cpu() for name, p in named}
    opt.step()
    change = {name: p.detach().float().cpu() - after["before"][name]["param"]
              for name, p in named}
    del opt, model, named
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, grad=grad, change=change)


def after_gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The `after_...` numbers of `got` (the program's step after the
    window, or the control's) against the reference's step `ref`
    (module docstring), with the leaf or role that sets each."""
    norm = {n: float(g.norm()) for n, g in ref["grad"].items()}
    med = statistics.median(norm.values())
    moved = [n for n, r in norm.items() if r >= MOVED * med]
    dist = {n: float((got["grad"][n] - ref["grad"][n]).norm()) / norm[n] for n in moved}
    roles = role_least(dist, moved)
    ref_c = {n: float(ref["change"][n].norm()) for n in moved}
    medc = statistics.median(ref_c.values())
    chg = {n: abs(float(got["change"][n].norm()) - ref_c[n]) / max(ref_c[n], medc)
           for n in moved}
    return dict(after_loss_gap=max(abs(got["losses"][k] - ref["losses"][k])
                                   / max(abs(ref["losses"][k]), 1e-12) for k in LOSS_KEYS),
                after_grad_distance=min(dist.values()),
                after_trunk_distance=max(roles.values()),
                after_change_gap=max(chg.values()),
                after_least_leaf=min(dist, key=dist.get),
                after_trunk_role=max(roles, key=roles.get),
                after_change_leaf=max(chg, key=chg.get))


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The three gaps of `got` (the program's, or the control's) against
    the reference `ref` (module docstring)."""
    loss_gap = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
                   for g, r in zip(got["losses"], ref["losses"]) for k in LOSS_KEYS)
    med = statistics.median(ref["grad1"].values())
    grad_gap = max(abs(got["grad1"][n] - r) / max(r, med) for n, r in ref["grad1"].items())
    moved = [n for n, r in ref["grad1"].items() if r >= MOVED * med]
    medc = statistics.median(ref["change"][n] for n in moved)
    change_gap = max(abs(got["change"][n] - ref["change"][n]) / max(ref["change"][n], medc)
                     for n in moved)
    worst = lambda d: max(d, key=d.get)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap,
                worst_grad_leaf=worst({n: abs(got["grad1"][n] - r) / max(r, med)
                                       for n, r in ref["grad1"].items()}),
                worst_change_leaf=worst({n: abs(got["change"][n] - ref["change"][n])
                                         / max(ref["change"][n], medc) for n in moved}),
                unmoved=len(ref["grad1"]) - len(moved),
                loss_terms={k: max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
                                   for g, r in zip(got["losses"], ref["losses"]))
                            for k in LOSS_KEYS},
                first_step_loss_gap=max(abs(got["losses"][0][k] - ref["losses"][0][k])
                                        / max(abs(ref["losses"][0][k]), 1e-12)
                                        for k in LOSS_KEYS))


def check(run, kept: Dict, device) -> None:
    """The cell's numbers (module docstring)."""
    limits = run.spec.cell["limits"]
    traffic = run.spec.traffic
    bad, batches = ref_inputs.pretrain_inputs(run.seed, traffic["records"], kept["batches"],
                                              traffic)
    run.check("batch_mismatch", bad, limits["batch_mismatch"])
    if bad:
        return
    ref = reference_steps(run.spec.config, run.seed, traffic, batches, device,
                          count_flops=run.trace, against=kept["grad1_vectors"])
    del kept["grad1_vectors"]
    if ref["flops_fwd_per_sample"] is not None:
        run.flops_per_item = 3.0 * ref["flops_fwd_per_sample"]
    g = gaps(kept, ref)
    run.notes = dict(worst_grad_leaf=g["worst_grad_leaf"],
                     worst_change_leaf=g["worst_change_leaf"], unmoved_leaves=g["unmoved"])
    # a number the cell gives no limit is printed, not compared (PERF.md:
    # neither the control nor a planted fault reads it far enough above
    # sound runs to set one)
    for name in ("loss_gap", "grad_gap", "change_gap"):
        if name in limits:
            run.check(name, g[name], limits[name])
        else:
            run.notes[name] = g[name]
    med = statistics.median(ref["grad1"].values())
    moved = [n for n, r in ref["grad1"].items() if r >= MOVED * med]
    run.check("grad_distance", min(ref["distance"][n] for n in moved),
              limits["grad_distance"])
    run.notes["least_distance_leaf"] = min(moved, key=lambda n: ref["distance"][n])
    roles = role_least(ref["distance"], moved)
    run.check("trunk_distance", max(roles.values()), limits["trunk_distance"])
    run.notes["trunk_role"] = max(roles, key=roles.get)
    del ref, batches
    check_after(run, kept.pop("after"), device)


def check_after(run, after: Dict, device) -> None:
    """The step after the window (module docstring): its staged batch
    against the records, then the `after_...` numbers that the cell file
    gives limits; the others are printed among the notes."""
    limits = run.spec.cell["limits"]
    traffic = run.spec.traffic
    bad, (arrays,) = ref_inputs.pretrain_inputs(run.seed, traffic["records"],
                                                [after["batch"]], traffic)
    run.check("after_batch_mismatch", bad, limits["after_batch_mismatch"])
    if bad:
        return
    ref = reference_after(run.spec.config, run.seed, traffic, arrays, after, device)
    for name, value in after_gaps(after, ref).items():
        if name in limits:
            run.check(name, value, limits[name])
        else:
            run.notes[name] = value
