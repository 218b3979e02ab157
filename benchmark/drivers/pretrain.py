"""The pretraining entry: K3MForPretraining under PretrainTrainer, driven
through the program's own loop, `PretrainTrainer.fit` (epochs back to
back, each step a batch staged by `prefetch`, then `train_step`, then a
device sync), from records the benchmark writes from the seed.

`fit` has no bound of its own on steps or time. After each step's sync it
asks its world whether any rank was preempted (`World.any_flag`, its
preemption path), and returns if so; the harness ends each of its calls
there: a wrapper around the trainer's `train_step` (an attribute of the
instance, which `fit` calls) marks the call's last step once it has
returned, and a wrapper around the trainer's world's `any_flag` answers
yes after it. The wrappers around `train_step` and `prefetch` also count
the samples, keep the losses and time each wait for a staged batch
(`data.wait`); each step's host time (`loop.step`) is `fit`'s own
`step_seconds`, from one step's sync to the next.

Set-up builds the one trainer and drives it through one `fit` call for the
cell's first steps (`check_steps`, then `warmup_steps`), keeping what the
check compares: each checked step's staged batch (on the host) and
losses, each leaf's gradient as AdamW got it in the first step (its first
moment over 1 - beta1; on the host) and its norm, and each leaf's change
after the last of them. The window is the next `fit` call, from the next
epoch, until its seconds are up. After it (and the traced steps), the
state the window left (parameters and AdamW's moments) is copied to the
host and one more `fit` call takes one step from it; its staged batch,
losses, gradient as AdamW got it and each leaf's change are kept, and
the check follows that step from the kept state.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from benchmark.lib import synthetic, trace, weights
from benchmark.lib.harness import Run

BETA1 = 0.9
LOSS_KEYS = ("loss", "masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc")
NO_END = 1 << 30


def program_config(spec_config: dict):
    from k3m_tpu_torch.config import K3MConfig
    return K3MConfig.from_dict(spec_config)


def make_loader(run: Run, cfg, path: str, traffic: dict):
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    shapes = ShapeSpec(max_seq_len=traffic["max_seq_length"],
                       max_seq_len_pv=traffic["max_seq_length_pv"],
                       max_num_pv=traffic["max_num_pv"],
                       max_region_len=traffic["max_region_length"],
                       v_feature_size=cfg.v_feature_size, v_target_size=cfg.v_target_size)
    return PretrainLoader(path, get_tokenizer(None, cfg.vocab_size), shapes,
                          batch_size=traffic["batch_size"], shuffle=True, seed=run.seed,
                          visual_target=cfg.visual_target)


def make_trainer(run: Run, cfg, traffic: dict, device):
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    with torch.device(device):
        model = K3MForPretraining(cfg)
    weights.fill_weights(model, run.seed, cfg.initializer_range)
    total = traffic["schedule_steps"]
    return PretrainTrainer(cfg, learning_rate=traffic["learning_rate"],
                           warmup_steps=int(traffic["warmup_proportion"] * total),
                           total_steps=total, objective=cfg.objective, seed=run.seed,
                           wire=traffic["wire"], device_cache=False, model=model)


class _Timed:
    """The staged batches of `prefetch`, each wait for one timed as the
    span `data.wait`."""

    def __init__(self, staged, run: Run):
        self.staged, self.run = staged, run

    def __iter__(self):
        return self

    def __next__(self):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("bench.data_wait"):
            batch = next(self.staged)
        self.run.span("data.wait", time.perf_counter() - t0)
        return batch

    def close(self):
        close = getattr(self.staged, "close", None)
        if close is not None:
            close()


def fit_steps(run: Run, trainer, loader, epoch: int, *, steps: int = NO_END,
              seconds: float = float("inf"), on_step=None) -> dict:
    """One `fit` call from `epoch` (module docstring) that ends after the
    step that returns once `steps` steps have run or `seconds` have gone
    by; `on_step(i, batch, metrics)` sees each step as it returns. Returns
    the call's steps, samples, seconds, losses (device scalars) and host
    step times."""
    from torch.profiler import record_function
    program_step = trainer.train_step
    program_flag = trainer.world.any_flag
    got = dict(steps=0, samples=0, losses=[], last=False)

    def train_step(batch):
        with record_function("bench.train_step"):
            metrics = program_step(batch)
        if on_step is not None:
            on_step(got["steps"], batch, metrics)
        got["steps"] += 1
        got["samples"] += int(batch["input_ids"].shape[0])
        got["losses"].append(metrics["loss"])
        got["last"] = got["steps"] >= steps or time.perf_counter() - t0 >= seconds
        return metrics

    trainer.train_step = train_step
    trainer.prefetch = lambda batches, depth=None: _Timed(
        type(trainer).prefetch(trainer, batches, depth), run)
    trainer.world.any_flag = lambda flag: program_flag(flag or got["last"])
    t0 = time.perf_counter()
    try:
        history = trainer.fit(loader, num_epochs=NO_END, start_epoch=epoch, log_steps=0,
                              handle_preemption=False)
    finally:
        del trainer.train_step, trainer.prefetch, trainer.world.any_flag
    got["seconds"] = time.perf_counter() - t0
    got["epochs"] = len(history)
    got["step_seconds"] = [s for h in history for s in h.get("step_seconds", [])]
    return got


def set_up(run: Run, device, cfg, traffic, keep_vectors: bool = False):
    """Records, loader, the one trainer, and its checked and warm-up steps:
    returns (trainer, loader, kept, next epoch). kept holds each leaf's
    first gradient itself (on the host) and, with `keep_vectors`, its
    change too."""
    path = os.path.join(run.tmp, "train_feat.k3mr")
    synthetic.write_pretrain_records(path, run.seed, traffic["records"])
    loader = make_loader(run, cfg, path, traffic)
    trainer = make_trainer(run, cfg, traffic, device)
    names = [n for n, _ in trainer.model.named_parameters()]
    n_check = run.spec.cell["check_steps"]
    kept = dict(batches=[], losses=[])

    def keep(i, batch, metrics):
        if i >= n_check:
            return
        kept["batches"].append({k: v.detach().cpu() for k, v in batch.items()})
        kept["losses"].append({k: float(metrics[k]) for k in LOSS_KEYS})
        if i == 0:
            state = trainer.opt.state
            named = list(trainer.model.named_parameters())
            kept["grad1"] = {n: float(state[p]["exp_avg"].norm()) / (1.0 - BETA1)
                             for n, p in named}
            kept["grad1_vectors"] = {n: state[p]["exp_avg"].detach().cpu() / (1.0 - BETA1)
                                     for n, p in named}
        if i == n_check - 1:
            start = weights.initial_leaf(run.seed, cfg.initializer_range, trainer.model,
                                         names)
            params = dict(trainer.model.named_parameters())
            kept["change"] = {n: float((params[n].detach().float() - start[n]).norm())
                              for n in names}
            if keep_vectors:
                kept["change_vectors"] = {n: (params[n].detach().float() - start[n]).cpu()
                                          for n in names}
            del start, params

    warmup = run.spec.cell.get("warmup_steps", 0)
    done = fit_steps(run, trainer, loader, 0, steps=n_check + warmup, on_step=keep)
    return trainer, loader, kept, done["epochs"]


def after_window_step(run: Run, trainer, loader, epoch: int) -> dict:
    """The state the trainer holds (each leaf's parameter and AdamW moments,
    on the host, as `before`; the trainer's step count, which keys the
    next step's draws; AdamW's count of updates), then one step of `fit`
    from `epoch`: its staged batch and losses, each leaf's gradient as
    AdamW got it (from the first moment before and after) and change."""
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

    fit_steps(run, trainer, loader, epoch, steps=1, on_step=keep)
    out["grad"] = {n: (host(opt.state[p]["exp_avg"]) - BETA1 * out["before"][n]["exp_avg"])
                   / (1.0 - BETA1) for n, p in named}
    out["change"] = {n: host(p) - out["before"][n]["param"] for n, p in named}
    return out


def run_cell(run: Run, device="cuda", cfg=None, traffic=None):
    """Set-up, window, traced steps and check of one run (module docstring)."""
    traffic = traffic or run.spec.traffic
    cfg = cfg or program_config(run.spec.config)
    device = torch.device(device)
    trainer, loader, kept, epoch = set_up(run, device, cfg, traffic)
    run.spans.clear()

    # the window: fit, from the next epoch, until its seconds are up
    run.setup_s = time.time() - run.t_process
    got = fit_steps(run, trainer, loader, epoch, seconds=run.seconds)
    losses = got["losses"]
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    run.window = dict(work=got["samples"], seconds=got["seconds"], attempted=got["steps"],
                      failed=failed, steps=got["steps"])
    run.spans["loop.step"] = got["step_seconds"]
    window_spans = {k: list(v) for k, v in run.spans.items()}
    epoch += got["epochs"]

    if run.trace:
        from benchmark.lib import kernel_calls
        n = run.spec.cell["traced_steps"]
        traced = {}
        with kernel_calls.record() as rec:
            run.profile = trace.profile(
                lambda: traced.update(fit_steps(run, trainer, loader, epoch, steps=n)), 1,
                run.tmp)
        epoch += traced["epochs"]
        run.profile["n_steps"] = n
        run.kernel_calls = rec.calls if not rec.missing else None

    if device.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    kept["after"] = after_window_step(run, trainer, loader, epoch)
    run.spans = window_spans      # the metrics read the window's spans alone
    del trainer, loader, got, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from benchmark.reference import check_pretrain
    check_pretrain.check(run, kept, device)
