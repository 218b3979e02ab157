"""`correct` for a data-parallel pretraining cell (drivers/pretrain_dp.py):
the numbers of reference/check_pretrain.py, with the reference computed by
one process on the global batch (every rank's staged rows in rank order),
in blocks of one rank's rows so that it fits, its gradients accumulated;
plus

  rank_param_mismatch   the leaves whose parameters differ in any bit
                        between a rank and rank 0, after the window and
                        after the step that follows it; limit 0

The blocks (`blocked_step`). K3M's trunk (embeddings, encoder, fusion)
reads no row but its own, and draws every random number of a batch at the
global batch's shape, sliced to the rows at hand (reference/k3m_plain
rand.py, dist.py): block b of B runs the trunk under a world of one
process that presents its rows as rows b n .. (b + 1) n - 1 of the
global batch (rank b of B, no collective), from a fresh StepRandom of the
step, and draws what one process draws for those rows. The heads, the
structure aggregator and the losses read across rows (LPM negatives, the
zero-pair carry, the global counts): they run once, on the whole batch,
over the trunk's outputs as leaves, with the StepRandom as a block's trunk
left it (every trunk draws the global shapes, so its generators stand
where one process's would). Then each block's trunk runs again with its
gradient, and its outputs' gradients are the leaves'. The trunk runs
deterministically given its draws, so the second run is the first.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List

import torch

from benchmark.lib import weights
from benchmark.reference import check_pretrain
from benchmark.reference import inputs as ref_inputs

LOSS_KEYS = check_pretrain.LOSS_KEYS


def _trunk(model, batch, det=False):
    return model.trunk(
        batch["input_ids"], batch.get("image_feat"), batch.get("image_loc"),
        batch.get("segment_ids"), batch.get("input_mask"), batch.get("image_mask"),
        batch["input_ids_pv"], batch.get("segment_ids_pv"), batch.get("input_mask_pv"),
        deterministic=det)


def blocked_step(model, batch: Dict, seed: int, step: int, blocks: int, device,
                 drop_block: int = None) -> Dict:
    """One training step's forward and backward of the k3m_plain model on
    the global `batch` (device tensors), in `blocks` blocks (module
    docstring); the gradients accumulate in the parameters. Returns the
    step's loss terms (check_pretrain.total_loss). `drop_block`: that
    block's trunk gradient left out (a planted fault: a rank's gradient
    missing from the all-reduce)."""
    from benchmark.reference.k3m_plain import dist, rand
    rows = batch["input_ids"].shape[0]
    if rows % blocks:
        raise ValueError(f"{rows} rows do not split into {blocks} blocks")
    n = rows // blocks

    def part(b):
        return {k: v[b * n:(b + 1) * n] for k, v in batch.items()}

    def trunk(b, rng):
        world = dist.World(rank=b, size=blocks)
        with rand.use(rng), dist.use(world, n):
            return _trunk(model, part(b))

    outs, rng = [], None
    with torch.no_grad():
        for b in range(blocks):
            rng = rand.StepRandom(seed, step, device)
            outs.append(trunk(b, rng))
    keys = [k for k, v in outs[0].items() if isinstance(v, torch.Tensor)
            and k != "word_embedding_table"]
    leaves = {k: torch.cat([o[k] for o in outs]).requires_grad_(True) for k in keys}
    whole = dict(outs[0], **leaves, word_embedding_table=model.embeddings.word_embeddings.weight)
    del outs
    real = model.trunk
    object.__setattr__(model, "trunk", lambda *a, **kw: whole)
    try:
        out = model(batch, deterministic=False, rng=rng)
    finally:
        object.__setattr__(model, "trunk", real)
    loss, metrics = check_pretrain.total_loss(out)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    del out, loss
    used = [k for k in keys if leaves[k].grad is not None]
    for b in range(blocks):
        if b == drop_block:
            continue
        got = trunk(b, rand.StepRandom(seed, step, device))
        torch.autograd.backward([got[k] for k in used],
                                [leaves[k].grad[b * n:(b + 1) * n] for k in used])
        del got
    return metrics


def _model(config: dict, device, control: bool):
    from benchmark.reference.k3m_plain import pretrain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = check_pretrain.reference_config(config, control)
    with torch.device(device):
        return pretrain.K3MForPretraining(cfg)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(config: dict, seed: int, traffic: dict, batches: List[Dict], blocks: int,
                    device, control: bool = False, count_flops: bool = False,
                    against: Dict = None, steps: int = None, drop_block: int = None,
                    keep: Dict = None) -> Dict:
    """check_pretrain.reference_steps on the global batches, in blocks; the
    distances to `against` are over the norm of `against` for the control
    and the fault (theirs to the sound reference), else over the
    reference's. `steps`: the first ones only, without an update; `keep`:
    receives the first gradient's host vectors."""
    from benchmark.reference import control as ctl
    from benchmark.reference.k3m_plain import optim
    model = _model(config, device, control)
    weights.fill_weights(model, seed, config["initializer_range"])
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    out = dict(losses=[], grad1=None, distance=None, flops_fwd_per_sample=None)
    for step, arrays in enumerate(batches[:steps]):
        batch = ref_inputs.to_device(arrays, device)
        model.train()
        if count_flops and step == 0:
            from torch.utils.flop_counter import FlopCounterMode
            from benchmark.reference.k3m_plain import rand
            with FlopCounterMode(display=False) as fc, torch.no_grad():
                n = batch["input_ids"].shape[0] // blocks
                model({k: v[:n] for k, v in batch.items()}, deterministic=False,
                      rng=rand.StepRandom(seed, step, device))
            out["flops_fwd_per_sample"] = fc.get_total_flops() / n
        with ctl.lower_precision() if control else contextlib.nullcontext():
            metrics = blocked_step(model, batch, seed, step, blocks, device, drop_block)
        out["losses"].append({k: float(metrics[k]) for k in LOSS_KEYS})
        del batch, metrics
        named = list(model.named_parameters())
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if step == 0:
            out["grad1"] = {n: float(p.grad.norm()) for n, p in named}
            if keep is not None:
                keep.update((n, p.grad.detach().cpu()) for n, p in named)
            if against is not None:
                out["distance"] = {}
                for n, p in named:
                    a = against[n].to(p.grad.device, torch.float32)
                    base = a if (control or drop_block is not None) else p.grad
                    out["distance"][n] = float((a - p.grad).norm()
                                               / base.norm().clamp(min=1e-30))
        if steps is not None and step + 1 >= steps:
            break
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
    if steps is None:
        names = [n for n, _ in model.named_parameters()]
        start = weights.initial_leaf(seed, config["initializer_range"], model, names)
        params = dict(model.named_parameters())
        out["change"] = {n: float((params[n].detach() - start[n]).norm()) for n in names}
        del start, params
    del opt, model
    _free(device)
    return out


def reference_after(config: dict, seed: int, traffic: dict, arrays: Dict, after: Dict,
                    blocks: int, device, control: bool = False,
                    drop_block: int = None) -> Dict:
    """check_pretrain.reference_after on the global batch of the step after
    the window, in blocks: its losses, gradients and changes (host). The
    control and `drop_block` as in `reference_steps`."""
    from benchmark.reference import control as ctl
    from benchmark.reference.k3m_plain import optim
    model = _model(config, device, control)
    total = traffic["schedule_steps"]
    opt, sched = optim.make_optimizer(model, traffic["learning_rate"],
                                      int(traffic["warmup_proportion"] * total), total)
    n = after["updates"]
    named = list(model.named_parameters())
    with torch.no_grad():
        for name, p in named:
            st = after["before"][name]
            p.copy_(st["param"])
            opt.state[p] = dict(step=torch.tensor(float(n)), exp_avg=st["exp_avg"].to(device),
                                exp_avg_sq=st["exp_avg_sq"].to(device))
    sched.last_epoch = n
    for group, base, factor in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * factor(n)
    model.train()
    with ctl.lower_precision() if control else contextlib.nullcontext():
        metrics = blocked_step(model, ref_inputs.to_device(arrays, device), seed,
                               after["step"], blocks, device, drop_block)
    losses = {k: float(metrics[k]) for k in LOSS_KEYS}
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad = {name: p.grad.detach().float().cpu() for name, p in named}
    opt.step()
    change = {name: p.detach().float().cpu() - after["before"][name]["param"]
              for name, p in named}
    del opt, model, named
    _free(device)
    return dict(losses=losses, grad=grad, change=change)


def first_numbers(ref: Dict) -> Dict:
    import statistics
    med = statistics.median(ref["grad1"].values())
    moved = [n for n, r in ref["grad1"].items() if r >= check_pretrain.MOVED * med]
    roles = check_pretrain.role_least(ref["distance"], moved)
    return dict(grad_distance=min(ref["distance"][n] for n in moved),
                trunk_distance=max(roles.values()),
                least_distance_leaf=min(moved, key=lambda n: ref["distance"][n]),
                trunk_role=max(roles, key=roles.get))


def check(run, kept: Dict, device) -> None:
    """The cell's numbers (module docstring); `kept` holds the program's
    global batches, rank 0's first gradient, losses and changes, the ranks'
    checksums and the step after the window."""
    limits = run.spec.cell["limits"]
    traffic = run.spec.traffic
    blocks = run.spec.chips
    run.check("rank_param_mismatch", kept["rank_param_mismatch"], limits["rank_param_mismatch"])
    bad, batches = ref_inputs.pretrain_inputs(run.seed, traffic["records"], kept["batches"],
                                              traffic)
    run.check("batch_mismatch", bad, limits["batch_mismatch"])
    if bad:
        return
    ref = reference_steps(run.spec.config, run.seed, traffic, batches, blocks, device,
                          count_flops=run.trace, against=kept.pop("grad1_vectors"))
    if ref["flops_fwd_per_sample"] is not None:
        run.flops_per_item = 3.0 * ref["flops_fwd_per_sample"]
    g = check_pretrain.gaps(kept, ref)
    run.notes = dict(worst_grad_leaf=g["worst_grad_leaf"],
                     worst_change_leaf=g["worst_change_leaf"], unmoved_leaves=g["unmoved"],
                     loss_gap=g["loss_gap"], grad_gap=g["grad_gap"])
    run.check("change_gap", g["change_gap"], limits["change_gap"])
    first = first_numbers(ref)
    run.check("grad_distance", first["grad_distance"], limits["grad_distance"])
    run.check("trunk_distance", first["trunk_distance"], limits["trunk_distance"])
    run.notes.update(least_distance_leaf=first["least_distance_leaf"],
                     trunk_role=first["trunk_role"])
    del ref, batches
    _free(device)
    after = kept.pop("after")
    bad, (arrays,) = ref_inputs.pretrain_inputs(run.seed, traffic["records"], [after["batch"]],
                                                traffic)
    run.check("after_batch_mismatch", bad, limits["after_batch_mismatch"])
    if bad:
        return
    ref = reference_after(run.spec.config, run.seed, traffic, arrays, after, blocks, device)
    for name, value in check_pretrain.after_gaps(after, ref).items():
        if name in limits:
            run.check(name, value, limits[name])
        else:
            run.notes[name] = value
