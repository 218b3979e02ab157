"""The pretraining entry of the DeepSeek-V2 text block's cell: the
pretraining entry (drivers/pretrain.py: `PretrainTrainer.fit`, ended
through its preemption path, the same set-up, window, traced steps and
step after the window), with

  * the weights of lib/weights_moe.py (the expert banks drawn too);
  * the check of reference/check_pretrain_moe.py, whose reference also
    routes: the experts the program's MoE layers chose in the first
    checked step are kept (`deepseek.route` wrapped for that step alone);
  * what it keeps held once: each leaf's first gradient on the host, the
    changes' norms, and after the window the state (parameter and AdamW
    moments) on the host, the step's gradient, and its changes' norms;
  * with `--trace 1`, after the traced steps, one more traced segment of
    the same trainer with the program's recorder on
    (lib/program_trace.py `segment`): its `k3m.moe.*` spans' device time
    and its counters, which the `.dsv2` metrics read (`run.moe_trace`),
    and the calls of the latent attention's kernel instance with their
    bound (lib/mla_bounds.py), which `mla_attention_roofline.dsv2` reads
    (`run.mla_calls`).
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

import torch

from benchmark.drivers import pretrain
from benchmark.lib import mla_bounds, synthetic, trace, weights_moe
from benchmark.lib.harness import Run
from benchmark.reference import check_pretrain_moe

BETA1 = pretrain.BETA1
LOSS_KEYS = check_pretrain_moe.LOSS_KEYS


def make_trainer(run: Run, cfg, traffic: dict, device):
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    with torch.device(device):
        model = K3MForPretraining(cfg)
    weights_moe.fill_weights(model, run.seed, cfg.initializer_range)
    total = traffic["schedule_steps"]
    return PretrainTrainer(cfg, learning_rate=traffic["learning_rate"],
                           warmup_steps=int(traffic["warmup_proportion"] * total),
                           total_steps=total, objective=cfg.objective, seed=run.seed,
                           wire=traffic["wire"], device_cache=False, model=model)


@contextlib.contextmanager
def program_routes(keep: list):
    """The experts each of the program's MoE layers chose (host [rows, k]),
    in call order, while the block is open."""
    from k3m_tpu_torch.model import deepseek
    saved = deepseek.route

    def route(idx, e0, e1):
        keep.append(idx.detach().cpu())
        return saved(idx, e0, e1)

    deepseek.route = route
    try:
        yield keep
    finally:
        deepseek.route = saved


def set_up(run: Run, device, cfg, traffic):
    """Records, loader, trainer and its checked and warm-up steps
    (drivers/pretrain.py `set_up`): returns (trainer, loader, kept, next
    epoch)."""
    path = os.path.join(run.tmp, "train_feat.k3mr")
    synthetic.write_pretrain_records(path, run.seed, traffic["records"])
    loader = pretrain.make_loader(run, cfg, path, traffic)
    trainer = make_trainer(run, cfg, traffic, device)
    names = [n for n, _ in trainer.model.named_parameters()]
    n_check = run.spec.cell["check_steps"]
    kept = dict(batches=[], losses=[], routes=[])
    routes = contextlib.ExitStack()
    routes.enter_context(program_routes(kept["routes"]))

    def keep(i, batch, metrics):
        if i == 0:
            routes.close()
        if i >= n_check:
            return
        kept["batches"].append({k: v.detach().cpu() for k, v in batch.items()})
        kept["losses"].append({k: float(metrics[k]) for k in LOSS_KEYS})
        named = list(trainer.model.named_parameters())
        if i == 0:
            state = trainer.opt.state
            kept["grad1"] = {n: float(state[p]["exp_avg"].norm()) / (1.0 - BETA1)
                             for n, p in named}
            kept["grad1_vectors"] = {n: state[p]["exp_avg"].detach().cpu() / (1.0 - BETA1)
                                     for n, p in named}
        if i == n_check - 1:
            start = weights_moe.initial_leaf(run.seed, cfg.initializer_range, trainer.model,
                                             names)
            kept["change"] = {n: float((p.detach().float() - start[n]).norm())
                              for n, p in named}
            del start

    warmup = run.spec.cell.get("warmup_steps", 0)
    try:
        done = pretrain.fit_steps(run, trainer, loader, 0, steps=n_check + warmup,
                                  on_step=keep)
    finally:
        routes.close()
    return trainer, loader, kept, done["epochs"]


def after_window_step(run: Run, trainer, loader, epoch: int) -> dict:
    """drivers/pretrain.py `after_window_step`, keeping of the step's change
    only each leaf's norm."""
    opt = trainer.opt
    named = list(trainer.model.named_parameters())

    def host(t):
        return t.detach().to("cpu", torch.float32, copy=True)

    out = dict(step=int(trainer.step), updates=int(opt.state[named[0][1]]["step"]),
               before={n: dict(param=host(p), exp_avg=host(opt.state[p]["exp_avg"]),
                               exp_avg_sq=host(opt.state[p]["exp_avg_sq"]))
                       for n, p in named})

    def keep(i, batch, metrics):
        out["batch"] = {k: v.detach().cpu() for k, v in batch.items()}
        out["losses"] = {k: float(metrics[k]) for k in LOSS_KEYS}

    pretrain.fit_steps(run, trainer, loader, epoch, steps=1, on_step=keep)
    out["grad"], out["change"] = {}, {}
    for n, p in named:
        before = out["before"][n]
        out["grad"][n] = ((host(opt.state[p]["exp_avg"]) - BETA1 * before["exp_avg"])
                          / (1.0 - BETA1))
        out["change"][n] = float((host(p) - before["param"]).norm())
    return out


def traced(run: Run, trainer, loader, epoch: int) -> int:
    """The traced steps (drivers/pretrain.py) with the calls of the latent
    attention's kernels recorded, then the program's own segment; returns
    the next epoch."""
    from benchmark.lib import kernel_calls, program_trace
    n = run.spec.cell["traced_steps"]
    got = {}
    with kernel_calls.record() as rec, mla_bounds.record() as mla:
        run.profile = trace.profile(
            lambda: got.update(pretrain.fit_steps(run, trainer, loader, epoch, steps=n)), 1,
            run.tmp)
    epoch += got["epochs"]
    run.profile["n_steps"] = n
    run.kernel_calls = rec.calls if not rec.missing else None
    run.mla_calls = mla.calls if not mla.missing else None
    seg = program_trace.segment(
        lambda: pretrain.fit_steps(run, trainer, loader, epoch, steps=n), n, run.tmp)
    if seg is not None:
        epoch += seg["result"]["epochs"]
        run.moe_trace = dict(n_steps=n, events=seg["events"],
                             counts=dict(getattr(seg["recorder"], "counts", {})))
    return epoch


def run_cell(run: Run, device="cuda"):
    """Set-up, window, traced steps and check of one run."""
    traffic = run.spec.traffic
    cfg = pretrain.program_config(run.spec.config)
    device = torch.device(device)
    trainer, loader, kept, epoch = set_up(run, device, cfg, traffic)
    run.spans.clear()

    run.setup_s = time.time() - run.t_process
    marks = [time.perf_counter()]
    got = pretrain.fit_steps(run, trainer, loader, epoch, seconds=run.seconds,
                             on_step=lambda *_: marks.append(time.perf_counter()))
    losses = got["losses"]
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    run.window = dict(work=got["samples"], seconds=got["seconds"], attempted=got["steps"],
                      failed=failed, steps=got["steps"])
    # fit keeps the step times of whole epochs alone, and a window of this
    # cell ends inside its first: each step's host time is taken here from
    # one step's return to the next's (the staged batch's wait, the step and
    # the previous step's sync), the window's start before the first
    run.spans["loop.step"] = [b - a for a, b in zip(marks, marks[1:])]
    window_spans = {k: list(v) for k, v in run.spans.items()}
    epoch += got["epochs"]
    if run.trace:
        epoch = traced(run, trainer, loader, epoch)
    if device.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    kept["after"] = after_window_step(run, trainer, loader, epoch)
    run.spans = window_spans
    del trainer, loader, got, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_pretrain_moe.check(run, kept, device)
