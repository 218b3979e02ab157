"""`correct` for the DeepSeek-V2 text block's pretraining cell: the numbers
of reference/check_pretrain.py (`batch_mismatch`, `grad_distance`,
`trunk_distance`, `change_gap` and their `after_...` forms, each as defined
there), with the reference of reference/k3m_deepseek.py (k3m_plain with the
frozen plain DeepSeek-V2 layers, fp32, TF32 off, its DeepSeek-V2 layers
recomputed in the backward so that it fits beside its AdamW state; their
forward is deterministic, so the recomputation changes no number) and the
weights of lib/weights_moe.py; plus

  route_mismatch   the share of the first step's (row, expert) choices of
                   the MoE layers that differ between the program and the
                   reference: bf16 moves a near tie of the router's scores,
                   as it moves the hard Gumbel choices of the fusion
  expert_gap       the largest, over the MoE layers' held experts, of the
                   gap between the norms of an expert's first gradient (its
                   slice of `mlp.experts.w13` and of `.w2`), the program's
                   against the reference's, over the larger of the
                   reference's and the layer's median expert's (an expert
                   that few rows chose moves by its routing flips alone):
                   an expert's part lost reads 1 where it is as busy as the
                   median, where the distances of the whole bank barely
                   move

Everything the check compares is on the host or compared leaf by leaf on
the card, so that the 2.8 billion parameters' vectors are held once.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
from typing import Dict, List

import torch

from benchmark.lib import weights_moe
from benchmark.reference import check_pretrain, k3m_deepseek
from benchmark.reference import deepseek_plain as dsp
from benchmark.reference import inputs as ref_inputs

LOSS_KEYS = k3m_deepseek.LOSS_KEYS
MOVED = check_pretrain.MOVED


def route_mismatch(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """The share of (row, expert) choices in `got` that `want` lacks, over
    the layers' [rows, k] choices."""
    if len(got) != len(want) or not got:
        return 1.0
    missed = total = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return 1.0
        n = int(max(a.max(), b.max())) + 1
        hot = lambda t: torch.zeros(t.shape[0], n, dtype=torch.bool).scatter_(1, t.long(), True)
        missed += int((hot(a) & ~hot(b)).sum())
        total += a.numel()
    return missed / total


def _model(config: dict, seed: int, device, control: bool):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dsp.DeepSeekV2Layer.checkpoint = True
    with torch.device(device):
        model = k3m_deepseek.build(config, dtype=config["dtype"] if control else "float32")
    return model


def reference_steps(config: dict, seed: int, traffic: dict, batches: List[Dict], device,
                    control: bool = False, count_flops: bool = False, against: Dict = None,
                    fault=None, steps: int = None, keep: Dict = None) -> Dict:
    """The reference's steps on `batches` (check_pretrain.reference_steps):
    losses, first gradient norms, changes' norms after them, the first
    step's routes, and with `against` (host vectors by name) each leaf's
    distance to the first gradient. `fault`: a context around the forward
    and backward (readings_moe.py), whose distance is then taken over the
    norm of `against` (the sound reference's); `steps`: take only the first
    ones (the faults' and the control's first gradient: no update); `keep`:
    a dict that receives the first gradient's host vectors."""
    from benchmark.reference.k3m_plain import optim, rand
    model = _model(config, seed, device, control)
    std = config["initializer_range"]
    weights_moe.fill_weights(model, seed, std)
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    out = dict(losses=[], grad1=None, distance=None, routes=None, flops_fwd_per_sample=None)
    for step, arrays in enumerate(batches[:steps]):
        batch = ref_inputs.to_device(arrays, device)
        model.train()
        lower = k3m_deepseek.lower_precision() if control else contextlib.nullcontext()
        with lower, (fault() if fault else contextlib.nullcontext()):
            with (k3m_deepseek.routes() if step == 0 else contextlib.nullcontext()) as routes:
                counter = contextlib.nullcontext()
                if count_flops and step == 0:
                    from torch.utils.flop_counter import FlopCounterMode
                    counter = FlopCounterMode(display=False)
                with counter:
                    res = model(batch, deterministic=False,
                                rng=rand.StepRandom(seed, step, device))
                if count_flops and step == 0:
                    out["flops_fwd_per_sample"] = (counter.get_total_flops()
                                                   / batch["input_ids"].shape[0])
            loss, metrics = k3m_deepseek.total_loss(res)
            loss.backward()
        if step == 0:
            out["routes"] = routes
        out["losses"].append({k: float(metrics[k].detach()) for k in LOSS_KEYS})
        del res, loss, metrics, batch
        named = list(model.named_parameters())
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if step == 0:
            out["grad1"] = {n: float(p.grad.norm()) for n, p in named}
            if keep is not None:
                keep.update((n, p.grad.detach().cpu()) for n, p in named)
            if against is not None:
                out["distance"], out["experts"] = {}, {}
                for n, p in named:
                    a = against[n].to(p.grad.device, torch.float32)
                    base = a if (fault or control) else p.grad
                    out["distance"][n] = float((a - p.grad).norm() / base.norm().clamp(min=1e-30))
                    if n.endswith(weights_moe.BANKS):
                        ref_e, got_e = (t.flatten(1).norm(dim=1) for t in (base, p.grad if
                                                                          base is a else a))
                        floor = ref_e.median().clamp(min=1e-30)
                        out["experts"][n] = float(((got_e - ref_e).abs()
                                                   / torch.maximum(ref_e, floor)).max())
        if steps is not None and step + 1 >= steps:
            break
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
    if steps is None:
        names = [n for n, _ in model.named_parameters()]
        start = weights_moe.initial_leaf(seed, std, model, names)
        params = dict(model.named_parameters())
        out["change"] = {n: float((params[n].detach() - start[n]).norm()) for n in names}
        del start, params
    del opt, model
    _free(device)
    return out


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_after(config: dict, seed: int, traffic: dict, arrays: Dict, after: Dict,
                    device, control: bool = False, keep_state: bool = False,
                    against: Dict = None, keep: Dict = None) -> Dict:
    """The reference's step from the program's state after the window
    (check_pretrain.reference_after), compared leaf by leaf as it goes:
    its losses, each leaf's gradient norm, the distance of the program's
    gradient (or of `against`'s, host vectors by name) to it, and its
    change's norm. The state is released as it is loaded unless
    `keep_state`; `keep` receives the gradient's host vectors; `control`:
    the control in the reference's place (the distances then over the norm
    of `against`)."""
    from benchmark.reference.k3m_plain import optim, rand
    model = _model(config, seed, device, control)
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    n = after["updates"]
    named = list(model.named_parameters())
    with torch.no_grad():
        for name, p in named:
            st = after["before"][name]
            take = st.get if keep_state else st.pop
            p.copy_(take("param"))
            opt.state[p] = dict(step=torch.tensor(float(n)),
                                exp_avg=take("exp_avg").to(device, copy=True),
                                exp_avg_sq=take("exp_avg_sq").to(device, copy=True))
            st["param"] = p.detach().to("cpu", copy=True)
    sched.last_epoch = n
    for group, base, factor in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * factor(n)
    batch = ref_inputs.to_device(arrays, device)
    model.train()
    with k3m_deepseek.lower_precision() if control else contextlib.nullcontext():
        res = model(batch, deterministic=False,
                    rng=rand.StepRandom(seed, after["step"], device))
        loss, metrics = k3m_deepseek.total_loss(res)
        loss.backward()
    losses = {k: float(metrics[k].detach()) for k in LOSS_KEYS}
    del res, loss, metrics, batch
    grad, dist = {}, {}
    other = after["grad"] if against is None else against
    for name, p in named:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        a = other[name].to(g.device)
        grad[name] = float((a if control else g).norm())
        dist[name] = float((a - g).norm() / (a if control else g).norm().clamp(min=1e-30))
        if keep is not None:
            keep[name] = g.detach().cpu()
    opt.step()
    change = {name: float((p.detach().cpu() - after["before"][name]["param"]).norm())
              for name, p in named}
    del opt, model, named
    _free(device)
    return dict(losses=losses, grad=grad, distance=dist, change=change)


def after_gaps(after: Dict, ref: Dict) -> Dict[str, float]:
    """check_pretrain.after_gaps from the leaf-by-leaf numbers."""
    norm = ref["grad"]
    med = statistics.median(norm.values())
    moved = [n for n, r in norm.items() if r >= MOVED * med]
    dist = {n: ref["distance"][n] for n in moved}
    roles = check_pretrain.role_least(dist, moved)
    medc = statistics.median(ref["change"][n] for n in moved)
    chg = {n: abs(after["change"][n] - ref["change"][n]) / max(ref["change"][n], medc)
           for n in moved}
    return dict(after_loss_gap=max(abs(after["losses"][k] - ref["losses"][k])
                                   / max(abs(ref["losses"][k]), 1e-12) for k in LOSS_KEYS),
                after_grad_distance=min(dist.values()),
                after_trunk_distance=max(roles.values()),
                after_change_gap=max(chg.values()),
                after_least_leaf=min(dist, key=dist.get),
                after_trunk_role=max(roles, key=roles.get),
                after_change_leaf=max(chg, key=chg.get))


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """check_pretrain.gaps with the balance loss among the losses."""
    saved = check_pretrain.LOSS_KEYS
    check_pretrain.LOSS_KEYS = LOSS_KEYS
    try:
        return check_pretrain.gaps(got, ref)
    finally:
        check_pretrain.LOSS_KEYS = saved


def first_numbers(ref: Dict) -> Dict[str, float]:
    """grad_distance, trunk_distance and expert_gap of the distances in
    `ref`."""
    med = statistics.median(ref["grad1"].values())
    moved = [n for n, r in ref["grad1"].items() if r >= MOVED * med]
    roles = check_pretrain.role_least(ref["distance"], moved)
    return dict(grad_distance=min(ref["distance"][n] for n in moved),
                trunk_distance=max(roles.values()),
                expert_gap=max(ref["experts"].values()),
                expert_leaf=max(ref["experts"], key=ref["experts"].get),
                least_distance_leaf=min(moved, key=lambda n: ref["distance"][n]),
                trunk_role=max(roles, key=roles.get))


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
                          count_flops=run.trace, against=kept.pop("grad1_vectors"))
    if ref["flops_fwd_per_sample"] is not None:
        run.flops_per_item = 3.0 * ref["flops_fwd_per_sample"]
    g = gaps(kept, ref)
    run.notes = dict(worst_grad_leaf=g["worst_grad_leaf"],
                     worst_change_leaf=g["worst_change_leaf"], unmoved_leaves=g["unmoved"],
                     loss_gap=g["loss_gap"], grad_gap=g["grad_gap"])
    run.check("change_gap", g["change_gap"], limits["change_gap"])
    first = first_numbers(ref)
    run.check("grad_distance", first["grad_distance"], limits["grad_distance"])
    run.check("trunk_distance", first["trunk_distance"], limits["trunk_distance"])
    run.notes.update(least_distance_leaf=first["least_distance_leaf"],
                     trunk_role=first["trunk_role"])
    run.check("expert_gap", first["expert_gap"], limits["expert_gap"])
    run.notes["expert_leaf"] = first["expert_leaf"]
    run.check("route_mismatch", route_mismatch(kept["routes"], ref["routes"]),
              limits["route_mismatch"])
    del ref, batches
    _free(device)
    check_after(run, kept.pop("after"), device)


def check_after(run, after: Dict, device) -> None:
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
