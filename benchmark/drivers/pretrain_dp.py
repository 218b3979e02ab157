"""The data-parallel pretraining entry: one rank a card, as `torchrun
--nproc_per_node N -m k3m_tpu_torch.pretrain` launches them, each rank
running the pretraining entry's loop (drivers/pretrain.py: its own
`PretrainTrainer.fit` over its shard of the records, the gradients summed
over the ranks by NCCL every step) on its rows of the global batch. Rank 0
reports.

The entry spawns N processes (the cell's chips); rank r takes card r and
joins a process group at a free localhost port. The records are written
once, before the spawn. Each rank reads shard r of N (PretrainLoader
`num_shards`, `shard_index`) at the traffic's per-rank batch. Every rank
runs the same calls of `fit` (the checked and warm-up steps, the window,
the traced steps, the step after the window); `fit` ends each call through
its preemption path on every rank at once (its world's `any_flag`). Rank 0
keeps what the check needs: its first gradient as AdamW got it (the
all-reduced one, which every rank holds), its losses (the global ones,
`global_metrics`), each leaf's change, and for the step after the window
its state, gradient and change; every rank keeps its staged batches, and
each leaf's checksum (the sum of its bits read as integers) after the
window and after that step. After the ranks leave their group, rank 0
frees its trainer and runs the check (reference/check_pretrain_dp.py) on
its card: the reference on the global batches (the ranks' rows in rank
order).

The window's work is the samples of every rank; its host step times,
waits, device trace and call bounds are rank 0's, and so is the peak of
device memory.
"""

from __future__ import annotations

import gc
import os
import socket
import sys
import time
from pathlib import Path

import torch

from benchmark.drivers import pretrain
from benchmark.lib import harness, synthetic, trace, weights
from benchmark.lib.harness import Run

JOIN_S = 3000         # a rank that takes longer has hung
GROUP_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_loader(run: Run, cfg, path: str, traffic: dict, world):
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
                          visual_target=cfg.visual_target, num_shards=world.data_size,
                          shard_index=world.data_rank)


def make_trainer(run: Run, cfg, traffic: dict, world):
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    with torch.device(world.device):
        model = K3MForPretraining(cfg)
    weights.fill_weights(model, run.seed, cfg.initializer_range)
    total = traffic["schedule_steps"]
    return PretrainTrainer(cfg, learning_rate=traffic["learning_rate"],
                           warmup_steps=int(traffic["warmup_proportion"] * total),
                           total_steps=total, objective=cfg.objective, seed=run.seed,
                           device=world.device, wire=traffic["wire"], device_cache=False,
                           model=model, world=world)


def checksums(model) -> torch.Tensor:
    """Each leaf's sum of its bits read as int32, in int64 (on the host)."""
    return torch.stack([p.detach().contiguous().view(torch.int32).long().sum().cpu()
                        for p in model.parameters()])


def _host(t):
    return t.detach().to("cpu", torch.float32, copy=True)


def rank_steps(run: Run, world, records: str) -> dict:
    """One rank's part (module docstring): returns what it keeps, with the
    trainer freed."""
    traffic = run.spec.traffic
    cfg = pretrain.program_config(run.spec.config)
    lead = world.rank == 0
    loader = make_loader(run, cfg, records, traffic, world)
    trainer = make_trainer(run, cfg, traffic, world)
    names = [n for n, _ in trainer.model.named_parameters()]
    n_check = run.spec.cell["check_steps"]
    kept = dict(batches=[], losses=[])

    def keep(i, batch, metrics):
        if i >= n_check:
            return
        kept["batches"].append({k: v.detach().cpu() for k, v in batch.items()})
        if not lead:
            return
        kept["losses"].append({k: float(metrics[k]) for k in pretrain.LOSS_KEYS})
        named = list(trainer.model.named_parameters())
        if i == 0:
            state = trainer.opt.state
            kept["grad1"] = {n: float(state[p]["exp_avg"].norm()) / (1.0 - pretrain.BETA1)
                             for n, p in named}
            kept["grad1_vectors"] = {n: _host(state[p]["exp_avg"]) / (1.0 - pretrain.BETA1)
                                     for n, p in named}
        if i == n_check - 1:
            start = weights.initial_leaf(run.seed, cfg.initializer_range, trainer.model, names)
            kept["change"] = {n: float((p.detach().float() - start[n]).norm()) for n, p in named}
            del start

    warmup = run.spec.cell.get("warmup_steps", 0)
    epoch = pretrain.fit_steps(run, trainer, loader, 0, steps=n_check + warmup,
                               on_step=keep)["epochs"]
    run.spans.clear()
    world.barrier()
    setup_s = time.time() - run.t_process
    got = pretrain.fit_steps(run, trainer, loader, epoch, seconds=run.seconds)
    losses = got["losses"]
    kept["window"] = dict(work=got["samples"] * world.data_size, seconds=got["seconds"],
                          attempted=got["steps"],
                          failed=int((~torch.isfinite(torch.stack(losses))).sum())
                          if losses else 0, steps=got["steps"])
    kept["setup_s"] = setup_s
    kept["spans"] = dict(run.spans, **{"loop.step": got["step_seconds"]})
    epoch += got["epochs"]
    if run.trace:
        from benchmark.lib import kernel_calls
        n = run.spec.cell["traced_steps"]
        done = {}
        step = lambda: done.update(pretrain.fit_steps(run, trainer, loader, epoch, steps=n))
        if lead:
            with kernel_calls.record() as rec:
                kept["profile"] = trace.profile(step, 1, run.tmp)
            kept["profile"]["n_steps"] = n
            kept["kernel_calls"] = rec.calls if not rec.missing else None
        else:
            step()
        epoch += done["epochs"]
    cuda = world.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(world.device)
    kept["peak_bytes"] = torch.cuda.max_memory_allocated(world.device) if cuda else 0
    kept["sums"] = [checksums(trainer.model)]

    # the step after the window
    opt = trainer.opt
    named = list(trainer.model.named_parameters())
    after = dict(step=int(trainer.step), updates=int(opt.state[named[0][1]]["step"]))
    if lead:
        after["before"] = {n: dict(param=_host(p), exp_avg=_host(opt.state[p]["exp_avg"]),
                                   exp_avg_sq=_host(opt.state[p]["exp_avg_sq"]))
                           for n, p in named}

    def keep_after(i, batch, metrics):
        after["batch"] = {k: v.detach().cpu() for k, v in batch.items()}
        after["losses"] = {k: float(metrics[k]) for k in pretrain.LOSS_KEYS}

    pretrain.fit_steps(run, trainer, loader, epoch, steps=1, on_step=keep_after)
    if lead:
        after["grad"] = {n: (_host(opt.state[p]["exp_avg"]) - pretrain.BETA1
                             * after["before"][n]["exp_avg"]) / (1.0 - pretrain.BETA1)
                         for n, p in named}
        after["change"] = {n: _host(p) - after["before"][n]["param"] for n, p in named}
    kept["sums"].append(checksums(trainer.model))
    kept["after"] = after
    del trainer, loader, opt, named
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return kept


def _rank_main(rank: int, size: int, port: int, spec_parts: dict, seed: int, seconds: float,
               trace_on: bool, t_process: float, records: str, out_dir: str, device: str):
    """Rank `rank`'s process: the run's spec (its files as the parent read
    them), the group, `rank_steps`, then its keep saved for the parent."""
    import traceback
    try:
        from k3m_tpu_torch.train import dist as train_dist
        harness.set_cache_dirs(Path.cwd())
        spec = harness.Spec(spec_parts["name"], Path.cwd())
        spec.config, spec.traffic, spec.cell = (spec_parts[k] for k in ("config", "traffic", "cell"))
        run = Run(spec, seed, seconds, trace_on)
        run.t_process = t_process
        if device == "cpu":
            torch.set_num_threads(1)
        world = train_dist.init_world(rank, size, f"tcp://localhost:{port}",
                                      f"cuda:{rank}" if device == "cuda" else device,
                                      timeout_s=GROUP_TIMEOUT_S)
        try:
            kept = rank_steps(run, world, records)
            world.barrier()
        finally:
            world.close()
        torch.save(kept, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    # the keep is saved: leave without the interpreter's teardown, in which
    # a loader thread still running (the native producer's, ended by the
    # preemption path mid-epoch) can abort the process
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def gather(out_dir: str, size: int) -> dict:
    """Rank 0's keep, with every rank's staged batches joined in rank order
    and the count of leaves whose checksum differs from rank 0's."""
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(size)]
    lead = ranks[0]
    join = lambda bs: {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
    lead["batches"] = [join([r["batches"][i] for r in ranks])
                       for i in range(len(lead["batches"]))]
    lead["after"]["batch"] = join([r["after"]["batch"] for r in ranks])
    lead["rank_param_mismatch"] = sum(int((r["sums"][i] != lead["sums"][i]).sum())
                                      for r in ranks[1:] for i in range(len(lead["sums"])))
    return lead


def run_cell(run: Run, device="cuda"):
    """Spawn the ranks, then fill the run from rank 0's keep and check it."""
    import torch.multiprocessing as mp
    size = run.spec.chips
    records = os.path.join(run.tmp, "train_feat.k3mr")
    synthetic.write_pretrain_records(records, run.seed, run.spec.traffic["records"])
    ctx = mp.get_context("spawn")
    spec = dict(name=run.spec.name, config=run.spec.config, traffic=run.spec.traffic,
                cell=run.spec.cell)
    args = (size, free_port(), spec, run.seed, run.seconds, run.trace, run.t_process,
            records, run.tmp, str(device))
    procs = [ctx.Process(target=_rank_main, args=(r,) + args) for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [Path(run.tmp, f"rank{r}.err").read_text() for r in range(size)
              if Path(run.tmp, f"rank{r}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks failed ({[p.exitcode for p in procs]}): {errors[:1]}")
    kept = gather(run.tmp, size)
    run.window = kept.pop("window")
    run.setup_s = kept.pop("setup_s")
    run.spans = kept.pop("spans")
    run.peak_bytes = kept.pop("peak_bytes")
    if run.trace:
        run.profile = kept.pop("profile")
        run.kernel_calls = kept.pop("kernel_calls")
    from benchmark.reference import check_pretrain_dp
    check_pretrain_dp.check(run, kept, torch.device(device))
