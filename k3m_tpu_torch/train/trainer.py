"""What the port's two trainers share (PretrainTrainer, AlignmentTrainer).

  * staging (`stage_arrays`): a host batch's arrays written in their wire
    form (`wire_plan`, train/wire.py) in one pass into a reused pinned slot
    (train/slots.py) and copied to the device from there;
    `staged_prefetch` runs it ahead on a producer thread, and with the
    device cache (train/device_cache.py) the first epoch's staged batches
    are kept on the card;
  * in-step microbatching (`micro_steps`, k3m_tpu/train/pretrain_loop.py:
    116-132, alignment_loop.py:152-202): the batch cut into M slices, each
    backpropagated with its own generators (`StepRandom(seed, step,
    micro=i)`) at 1/M of its loss, so the gradients and losses are the
    slices' means;
  * the update: AdamW once every `grad_accum_steps` train steps (the k
    gradients averaged, as optax.MultiSteps does), skipped under
    `skip_nonfinite` when a gradient is not finite;
  * the state a checkpoint holds;
  * data parallelism over a `world` of processes (k3m_tpu_torch/dist.py,
    train/dist.py): the
    parameters broadcast from rank 0 at construction and after a restore;
    before the update the gradients summed over the ranks (each rank's loss
    is already its share of the global batch's), so the non-finite skip is
    the same on every rank; the step's losses summed likewise; checkpoints
    written by rank 0 between two barriers. Micro slice i of an N-rank step
    is the union of the ranks' slices i: the one-process micro step on the
    micro-major reordering of the global batch;
  * tensor parallelism (`world.n_model` > 1, train/mesh.py): the model is
    split over the model ranks at construction, after every load; the
    broadcast, the gradient sum and the losses run over the data group
    (each model rank its own shard; the replicated parameters' gradients
    then averaged over the model group, train/dist.py), the non-finite
    skip is agreed over the whole world, and a checkpoint holds the full
    tensors, gathered over the model group (every rank takes part; rank 0
    writes), which a restore cuts back to this rank's slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Optional, Set

import numpy as np
import torch

from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.dist import World
from k3m_tpu_torch.train import mesh, slots
from k3m_tpu_torch.train.dist import all_reduce_grads
from k3m_tpu_torch.train.device_cache import DeviceEpochCache, cache_enabled
from k3m_tpu_torch.train.optim import make_optimizer
from k3m_tpu_torch.train.prefetch import staged_prefetch
from k3m_tpu_torch.train.wire import (
    FEAT_Q, TGT_Q, encode_pretrain, exact_targets, wire_mode,
)
from k3m_tpu_torch.utils import trace


def batch_rows(tree, rows: slice):
    """The rows `rows` of every tensor of a (nested) staged batch."""
    if isinstance(tree, dict):
        return {k: batch_rows(v, rows) for k, v in tree.items()}
    return tree[rows]


def wire_dtype(key: str, dtype: torch.dtype, config=None, wire: str = "exact") -> torch.dtype:
    """The dtype in which array `key`, held in `dtype`, crosses to the
    device. Under the `fp` wire and a bf16 `config` the two largest tensors
    are halved: image_feat goes to the compute dtype (its first use casts it
    anyway), the soft labels in [0, 1] to fp16 unless K3M_EXACT_TARGETS is
    set (k3m_tpu/train/pretrain_loop.py:336-353)."""
    if wire == "fp" and config is not None and config.dtype == "bfloat16":
        if key == "image_feat":
            return torch.bfloat16
        if key == "image_target" and config.visual_target == 0 and not exact_targets():
            return torch.float16
    return dtype


def host_array(key: str, value, config=None, wire: str = "exact"):
    """One host array of a batch as (a tensor over its memory, the dtype it
    crosses in, `wire_dtype`)."""
    t = torch.from_numpy(np.ascontiguousarray(value)) \
        if isinstance(value, np.ndarray) else torch.as_tensor(value)
    return t, wire_dtype(key, t.dtype, config, wire)


def _tree_map(fn, tree: Dict) -> Dict:
    """`fn(key, array)` over a batch's arrays, each under the key it has in
    its innermost dict (a pair batch's items, the Gumbel draws by stream)."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def _leaves(tree: Dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _on_device(key: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One wired array on `device` (non-blocking from pinned memory to a
    CUDA device); integers as int64 (embedding and gather indices), the
    int8 wire's quantized arrays as they are."""
    t = t.to(device, non_blocking=device.type == "cuda")
    if t.is_floating_point() or key in (FEAT_Q, TGT_Q):
        return t
    return t.long()


def wire_plan(arrays: Dict, keys, config=None, wire: str = "exact") -> Dict:
    """The arrays of `keys` (those present) of one batch, or one item of a
    pair batch, as `host_array` pairs: under the `int8` wire image_feat
    (and, for visual_target 0 without K3M_EXACT_TARGETS, image_target) in
    their quantized forms, which `wire.decode` undoes in the step."""
    arrays = {k: arrays[k] for k in keys if k in arrays}
    if wire == "int8":
        quantize = (config is not None and config.visual_target == 0
                    and "image_target" in arrays and not exact_targets())
        arrays = encode_pretrain(arrays, quantize_target=quantize)
    return {k: ({n: host_array(k, x, config, wire) for n, x in v.items()}
                if isinstance(v, dict) else host_array(k, v, config, wire))
            for k, v in arrays.items()}


def _cast(plan: Dict) -> Dict:
    return _tree_map(lambda k, p: p[0].to(p[1]), plan)


def wire_batch(arrays: Dict, keys, config=None, wire: str = "exact") -> Dict:
    """`wire_plan`'s arrays cast to their wire dtypes: the batch as it
    crosses to the device; `wire.wire_bytes` of it is the batch's
    host->device bytes."""
    return _cast(wire_plan(arrays, keys, config, wire))


SLOT_ALIGN = 256     # bytes; where each array of a batch starts in its slot
# An array of at most SMALL_COPY bytes that needs no cast is copied on the
# calling thread: a torch copy_ of more than 32,768 elements is a parallel
# region of the intra-op threads, which ends with its slowest thread, and
# with the batch producer's threads busy beside it a region took ~5 ms (a
# B1024 pair batch's 21 small arrays 50-150 ms, against 2-6 ms on the
# calling thread; H100 host, 8 cores).
SMALL_COPY = 4 << 20


def _aligned(n: int) -> int:
    return -(-n // SLOT_ALIGN) * SLOT_ALIGN


def plan_bytes(plan: Dict, aligned: bool = False) -> int:
    """The wire bytes of a `wire_plan`; with `aligned`, the slot bytes it
    fills (`fill_slot`)."""
    sizes = (t.numel() * dtype.itemsize for t, dtype in _leaves(plan))
    return sum(_aligned(n) for n in sizes) if aligned else sum(sizes)


def fill_slot(buf: torch.Tensor, plan: Dict) -> Dict:
    """A plan's arrays written into the byte tensor `buf` in one pass each,
    at SLOT_ALIGN-aligned offsets: a cast or a large array by one `copy_`
    (the wire cast inside it, on the intra-op threads), a small one that
    needs no cast by one copy on the calling thread (SMALL_COPY). Returns
    the batch's wire form, as views of `buf`."""
    offset = 0

    def put(key, leaf):
        nonlocal offset
        t, dtype = leaf
        n = t.numel() * dtype.itemsize
        view = buf[offset:offset + n].view(dtype).view(t.shape)
        offset += _aligned(n)
        if t.dtype == dtype != torch.bfloat16 and n <= SMALL_COPY:
            np.copyto(view.numpy(), t.numpy())
            return view
        return view.copy_(t)

    return _tree_map(put, plan)


def stage_batch(plan: Callable[[], Dict], device: torch.device) -> Dict:
    """A batch on `device`, under the span `k3m.stage` (which records the
    wire bytes). `plan()` gives its host arrays and their wire dtypes
    (`wire_plan`, in `k3m.stage.wire`).

    On a CUDA device a slot of the device's pool (train/slots.py) is taken
    (`k3m.stage.pin`; `k3m.stage` records `slot_reused`, false where the
    pool allocated), every array is written into it in one pass, the cast
    included (a second `k3m.stage.wire`), and copied from it
    (`k3m.stage.h2d`, `_on_device`); then the slot's event is recorded on
    the current stream and the slot handed back. Elsewhere the wire form
    is made in new tensors, in the first `k3m.stage.wire`, and copied
    (`k3m.stage.h2d`; `k3m.stage.pin` is empty): a slot reused there would
    be the staged batch itself."""
    cuda = device.type == "cuda"
    with trace.span("k3m.stage") as sp:
        with trace.span("k3m.stage.wire"):
            arrays = plan()
            wired = None if cuda else _cast(arrays)
        if trace.on():
            sp.set(bytes=plan_bytes(arrays))
        if not cuda:
            with trace.span("k3m.stage.pin"):
                pass
            with trace.span("k3m.stage.h2d"):
                return _tree_map(lambda k, t: _on_device(k, t, device), wired)
        pool = slots.pool_for(device)
        with trace.span("k3m.stage.pin"):
            slot, reused = pool.acquire(plan_bytes(arrays, aligned=True))
        sp.set(slot_reused=reused)
        try:
            with trace.span("k3m.stage.wire"):
                wired = fill_slot(slot.buf, arrays)
            with trace.span("k3m.stage.h2d"):
                return _tree_map(lambda k, t: _on_device(k, t, device), wired)
        finally:
            pool.release(slot, torch.cuda.current_stream(device))


def stage_arrays(arrays: Dict, keys, device: torch.device, config=None,
                 wire: str = "exact") -> Dict[str, torch.Tensor]:
    """`wire_plan` of the arrays, on `device` (`stage_batch`)."""
    return stage_batch(lambda: wire_plan(arrays, keys, config, wire), device)


def allreduce_summary(allreduce) -> Dict:
    """An epoch summary's all-reduce entries from its steps' (bytes,
    seconds or None): `allreduce_bytes`, and `allreduce_seconds` where
    every step was timed (recording on, utils/trace.py)."""
    out = dict(allreduce_bytes=[b for b, _ in allreduce])
    if all(t is not None for _, t in allreduce):
        out["allreduce_seconds"] = [t for _, t in allreduce]
    return out


class Trainer:
    def __init__(self, config, model: torch.nn.Module, *, learning_rate: float,
                 warmup_steps: int, total_steps: int, weight_decay: float = 0.01,
                 grad_accum_steps: int = 1, micro_steps: int = 1, adam_eps: float = 1e-8,
                 seed: int = 42, wire: Optional[str] = None, device_cache: Optional[bool] = None,
                 skip_nonfinite: bool = False, pretrained: Optional[Set[str]] = None,
                 world: Optional[World] = None):
        if micro_steps < 1 or grad_accum_steps < 1:
            raise ValueError("micro_steps and grad_accum_steps must be at least 1")
        self.config = config
        self.device = next(model.parameters()).device
        self.world = world or World(device=self.device)
        self.model = mesh.shard_model(model, self.world)
        # bytes and host seconds (None unless recording) of the last
        # update's gradient all-reduce
        self.allreduce = (0, None)
        self.seed = seed
        self.wire = wire_mode(wire)                   # K3M_WIRE when not given
        self.device_cache = cache_enabled(device_cache)   # K3M_DEVICE_CACHE
        self.epoch_cache: Optional[DeviceEpochCache] = None
        self.grad_accum_steps = grad_accum_steps
        self.micro_steps = micro_steps
        self.skip_nonfinite = skip_nonfinite
        self.opt, self.sched = make_optimizer(
            model, learning_rate, warmup_steps, total_steps,
            weight_decay=weight_decay, adam_eps=adam_eps, pretrained=pretrained)
        self.step = 0        # train_step calls so far (the JAX state.step)
        self._micro = 0      # steps accumulated since the last update
        if self.world.group:
            if self.device.type == "cuda":
                # every rank loads the kernels before the first collective,
                # so that no rank waits in one while another compiles
                # (JAX's compile-then-barrier, pretrain_loop.py:438-441)
                from k3m_tpu_torch.kernels import build
                build.library()
            self.world.barrier()
            self.world.broadcast_module(self.model)

    # ------------------------------------------------------------ staging

    def stage(self, batch: Dict) -> Dict:
        raise NotImplementedError

    def prefetch(self, loader: Iterable, depth: Optional[int] = None) -> Iterator[Dict]:
        """The loader's batches staged on the device ahead of their use."""
        return staged_prefetch(loader, self.stage, depth, self.device)

    def epoch_source(self, loader: Iterable) -> Iterable:
        """What `fit` iterates: the loader, or with the device cache on, the
        loader behind one DeviceEpochCache (kept as `epoch_cache`) that
        stages the first epoch and replays it after."""
        if not self.device_cache:
            return loader
        if self.epoch_cache is None or self.epoch_cache._loader is not loader:
            self.epoch_cache = DeviceEpochCache(loader, self.stage, device=self.device)
        return self.epoch_cache

    # -------------------------------------------------------------- steps

    def micro_slices(self, batch_size: int):
        """(rows, StepRandom) of each slice of this step; one slice of all
        rows with the step's generators when micro_steps is 1."""
        m = self.micro_steps
        if batch_size % m:
            raise ValueError(f"batch {batch_size} not divisible by micro_steps {m}")
        if m == 1:
            yield slice(None), StepRandom(self.seed, self.step, self.device)
            return
        size = batch_size // m
        for i in range(m):
            yield (slice(i * size, (i + 1) * size),
                   StepRandom(self.seed, self.step, self.device, micro=i))

    @trace.spanned("k3m.update")
    def update(self) -> Optional[torch.Tensor]:
        """Count the step whose gradients were just accumulated and, once
        every grad_accum_steps steps, apply them (span `k3m.update`).
        Returns 1.0 (a device scalar) where skip_nonfinite skipped the
        update, else None."""
        self.step += 1
        self._micro += 1
        self.allreduce = (0, 0.0 if trace.on() else None)
        if self._micro < self.grad_accum_steps:
            return None
        self._micro = 0
        if self.world.group:
            self._all_reduce_grads()
        skipped = None
        if self.skip_nonfinite and self._nonfinite():
            skipped = torch.ones((), device=self.device)
        else:
            # optax decays a parameter whose gradient is zero; torch's AdamW
            # skips one without a gradient, so the parameters the loss does
            # not reach (the NSP head under objective 2, frozen layers) get
            # a zero gradient
            for p in self.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.opt.step()
            self.sched.step()
        self.opt.zero_grad(set_to_none=True)
        return skipped

    def _all_reduce_grads(self) -> None:
        """Sum the gradients over the ranks (train/dist.py). While recording
        (utils/trace.py), the span `k3m.allreduce` times it on the host
        between two device synchronisations; otherwise nothing waits for the
        device here. `allreduce`: (bytes, those seconds or None)."""
        if not trace.on():
            self.allreduce = (all_reduce_grads(self.world, self.model.parameters()), None)
            return
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        with trace.span("k3m.allreduce") as sp:
            nbytes = all_reduce_grads(self.world, self.model.parameters())
            sync()
            sp.set(bytes=nbytes)
        self.allreduce = (nbytes, sp.seconds)

    def global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's losses summed over the ranks (each rank's is its
        share of the global batch's), in one all-reduce; as they are in a
        world of one."""
        if not self.world.distributed:
            return metrics
        keys = [k for k in metrics if k != "nonfinite_skipped"]
        summed = self.world.all_reduce_sum(torch.stack([metrics[k].float() for k in keys]),
                                           "data")
        return dict(metrics, **{k: summed[i] for i, k in enumerate(keys)})

    def save_checkpoint(self, save) -> Optional[str]:
        """`save(state_dict)` on rank 0, between two barriers, so that no
        rank reads a checkpoint before it is whole; its result there, None
        on the other ranks. Under tensor parallelism every rank gathers the
        state, rank 0 alone writes it."""
        self.world.barrier()
        tp = self.world.n_model > 1
        state = self.state_dict() if tp or self.world.rank == 0 else None
        out = save(state) if self.world.rank == 0 else None
        self.world.barrier()
        return out

    def _nonfinite(self) -> bool:
        """Whether a gradient is not finite: on any rank under tensor
        parallelism, where each model rank holds other gradients."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        bad = not bool(torch.stack([g.isfinite().all() for g in grads]).all())
        return self.world.any_flag(bad) if self.world.n_model > 1 else bad

    # ---------------------------------------------------------- checkpoint

    def state_dict(self) -> dict:
        """The full state: under tensor parallelism the model and the AdamW
        moments gathered to full shape (every rank of the model group calls
        it)."""
        return dict(model=mesh.full_state_dict(self.model, self.world),
                    optimizer=mesh.full_optimizer_state(
                        self.opt.state_dict(), mesh.optimizer_names(self.model, self.opt),
                        self.world),
                    scheduler=self.sched.state_dict(), step=self.step,
                    micro=self._micro)

    def load_state_dict(self, state: dict) -> None:
        """A full state (`state_dict`), cut to this rank's slices under
        tensor parallelism."""
        self.model.load_state_dict(mesh.local_state_dict(state["model"], self.world))
        self.opt.load_state_dict(mesh.local_optimizer_state(
            state["optimizer"], mesh.optimizer_names(self.model, self.opt), self.world))
        self.sched.load_state_dict(state["scheduler"])
        self.step, self._micro = int(state["step"]), int(state["micro"])
        self.world.broadcast_module(self.model)
