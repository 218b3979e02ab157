"""The scoring entry: K3MForItemAlignment for serving (Linear weights cast
to the compute dtype once, eval mode), each batch as `alignment_loop.
predict` takes it: `batch_to_device`, then `alignment_loop.forward`, then
both embeddings and the probabilities copied to the host. The jsonl
formatting and write are left out.

The records are re-read pass after pass. A real test file holds many
batches, so its loader runs ahead of the forward; here a feeder thread
iterates the loader pass after pass into a queue of `feed_depth` batches,
so the next pass's batch is being made while the current one is scored.

Every answer of the window is kept on the host; after the window the
check compares a sample of the pairs, drawn from the seed, in every pass
that scored them (reference/check_score.py).
"""

from __future__ import annotations

import gc
import os
import queue
import threading
import time

import torch

from benchmark.lib import synthetic, trace, weights
from benchmark.lib.harness import Run


def program_config(spec_config: dict):
    from k3m_tpu_torch.config import K3MConfig
    return K3MConfig.from_dict(spec_config)


def make_loader(run: Run, cfg, path: str, traffic: dict):
    from k3m_tpu_torch.data.pipeline import AlignmentLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    shapes = ShapeSpec(max_seq_len=traffic["max_seq_length"],
                       max_seq_len_pv=traffic["max_seq_length_pv"],
                       max_num_pv=traffic["max_num_pv"],
                       max_region_len=traffic["max_region_length"],
                       v_feature_size=cfg.v_feature_size, v_target_size=cfg.v_target_size)
    return AlignmentLoader(path, get_tokenizer(None, cfg.vocab_size), shapes,
                           batch_size=traffic["batch_size"], shuffle=False, seed=run.seed,
                           drop_last=False, prefetch=traffic["loader_prefetch"])


def make_model(run: Run, cfg, device):
    from k3m_tpu_torch.model.alignment import K3MForItemAlignment
    from k3m_tpu_torch.model.layers import cast_linears, compute_dtype
    with torch.device(device):
        model = K3MForItemAlignment(cfg)
    weights.fill_weights(model, run.seed, cfg.initializer_range)
    cast_linears(model, compute_dtype(cfg))
    return model.eval()


class Feeder:
    """Batches of the loader, pass after pass, made ahead on a thread."""

    def __init__(self, loader, depth: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(loader,), daemon=True)
        self.thread.start()

    def _run(self, loader):
        try:
            while not self.stop.is_set():
                for batch in loader:
                    while not self.stop.is_set():
                        try:
                            self.q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self.stop.is_set():
                        return
        except BaseException as e:      # noqa: BLE001 -- raised in the consumer
            self.q.put(e)

    def get(self):
        item = self.q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self.stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        self.thread.join()


def score_batches(run: Run, model, feeder: Feeder, cfg, device, traffic):
    """Yield (host batch, host results) of each batch (module docstring),
    with the spans `data.stage` (loader wait and staging) and
    `loop.batch` (the whole batch, to its results on the host)."""
    from torch.profiler import record_function
    from k3m_tpu_torch.train.alignment_loop import batch_to_device, forward
    while True:
        t0 = time.perf_counter()
        with record_function("bench.data_wait"):
            batch = feeder.get()
        with record_function("bench.stage"):
            staged = batch_to_device(batch, device, cfg, traffic["wire"])
        t1 = time.perf_counter()
        with record_function("bench.forward"):
            e1, e2, probs, _ = forward(model, staged)
        with record_function("bench.to_host"):
            out = dict(emb1=e1.float().cpu(), emb2=e2.float().cpu(), probs=probs.float().cpu())
        t2 = time.perf_counter()
        run.span("data.stage", t1 - t0)
        run.span("loop.batch", t2 - t0)
        yield batch, out


def run_cell(run: Run, device="cuda", cfg=None, traffic=None):
    traffic = traffic or run.spec.traffic
    cfg = cfg or program_config(run.spec.config)
    device = torch.device(device)
    path = os.path.join(run.tmp, "test_item_alignment.k3mr")
    synthetic.write_pair_records(path, run.seed, traffic["records"])
    loader = make_loader(run, cfg, path, traffic)
    model = make_model(run, cfg, device)
    feeder = Feeder(loader, traffic["feed_depth"])
    gen = score_batches(run, model, feeder, cfg, device, traffic)

    kept = dict(answers=[])
    for _ in range(run.spec.cell["warmup_batches"]):
        batch, _ = next(gen)
    # one batch's staged inputs, kept for the check's judgement of the loader
    kept["staged"] = batch
    per_pass = -(-traffic["records"] // traffic["batch_size"])
    kept["staged_first"] = ((run.spec.cell["warmup_batches"] - 1) % per_pass) \
        * traffic["batch_size"]
    kept["window_offset"] = run.spec.cell["warmup_batches"]
    run.spans.clear()

    t0 = time.perf_counter()
    run.setup_s = time.time() - run.t_process
    pairs = batches = 0
    while time.perf_counter() - t0 < run.seconds:
        batch, out = next(gen)
        kept["answers"].append(out)
        pairs += out["probs"].shape[0]
        batches += 1
    elapsed = time.perf_counter() - t0
    run.window = dict(work=pairs, seconds=elapsed, attempted=pairs, failed=0, steps=batches)
    window_spans = {k: list(v) for k, v in run.spans.items()}

    if run.trace:
        from benchmark.lib import kernel_calls
        with kernel_calls.record() as rec:
            run.profile = trace.profile(lambda: next(gen), run.spec.cell["traced_batches"],
                                        run.tmp)
        run.kernel_calls = rec.calls if not rec.missing else None
        run.spans = window_spans      # the traced steps' spans are the profiler's too

    gen.close()
    feeder.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    del gen, feeder, loader, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from benchmark.reference import check_score
    check_score.check(run, kept, device)
