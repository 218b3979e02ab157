"""Spans of the port's host phases, off unless recording.

`recording()` turns on one recorder for the whole process and returns it;
spans from every thread go into it (the step thread, the staging producer
thread, autograd's engine thread). While it is on, `span(name, **attrs)`
records the name, the thread (`threading.get_native_id()`, the `tid` of a
torch.profiler trace), start and end (`time.time_ns()`, the clock under a
torch.profiler Chrome trace's `baseTimeNanoseconds`), the enclosing span
of the same thread, and the attributes (a tensor as its shape and dtype
name, a dtype as its name). It also enters
`torch.profiler.record_function(name)`, so that the span shows as a
`user_annotation` in any torch.profiler trace, on the device trace's own
clock, for an operator reading the trace in TensorBoard or Perfetto.
While it is off, `span` checks one module-level name and returns a shared
no-op: no `record_function` (whose entry costs more than ten
microseconds even with no profiler running), nothing recorded.
`spanned(name)` makes a function's every call one span; with
`arguments=True` the span's attributes are the call's arguments by name,
bound only while recording.

| span | where | attributes |
| --- | --- | --- |
| `k3m.fit` | a trainer's `fit` | |
| `k3m.epoch` | one epoch of `fit` | `epoch` |
| `k3m.step` | one step of `fit`: `train_step` and the step's sync | `samples` |
| `k3m.sync` | the step's device synchronisation | |
| `k3m.forward` | `PretrainTrainer.losses` (decode, objective, model, loss); each micro slice's model call in `AlignmentTrainer.train_step`; `alignment_loop.forward` | |
| `k3m.backward` | each micro slice's `.backward()` | |
| `k3m.update` | `Trainer.update`: the all-reduce, the non-finite check, AdamW and its schedule, `zero_grad` | |
| `k3m.allreduce` | the data-parallel gradient sum, between two device syncs | `bytes` |
| `k3m.data_wait` | `staged_prefetch`'s consumer: the queue and the stream wait | |
| `k3m.stage` | staging of one batch (`stage_batch`) | `bytes` (the wire bytes); on a CUDA device `slot_reused` (false where the slot pool allocated) |
| `k3m.stage.wire` | the batch's host arrays and wire dtypes (`wire_plan`; the int8 wire's quantization); on a CUDA device a second span, the one-pass fill of the slot (casts included), elsewhere the casts into new tensors inside the first | |
| `k3m.stage.pin` | on a CUDA device the slot's acquisition from the pool (train/slots.py: the wait for its last copies, any allocation); empty elsewhere | |
| `k3m.stage.h2d` | every array's copy to the device (the enqueue, on a CUDA device) | |
| `k3m.kernel.<function>` | each call of the function that launches the kernel of `fused_layernorm` (`layernorm._forward`), `layernorm_bwd`, `fused_attention` (`attention._forward`), `attention_bwd`, `fused_biattention` (`coattn._forward`) | the call's arguments, defaults left out |
| `k3m.mla` | DeepSeek-V2's latent attention (model/deepseek.py): its projections, the latent RMSNorm and rope, up to the attention kernel | |
| `k3m.moe.route` | the MoE router, its fp32 softmax and top-k, the sort of the (row, expert) pairs by held expert and the gather of their rows; in the backward the sum of each row's pairs | |
| `k3m.moe.experts` | the held experts' grouped GEMMs and SwiGLU, forward and backward (the backward's gather of the pairs' rows too) | |
| `k3m.moe.combine` | the weighted sum of each row's held pairs; in the backward the pairs' gradients in sorted order and the weights' gradient | |
| `k3m.moe.shared` | the shared experts and the sum with the routed part | |

Counters (`count(name, value)`): while recording, each call adds `value`
(a device tensor) to the recording's running sum of `name` on the device,
with no sync, or (an int the host already knows) to a sum on the host,
launching nothing; `recording()` reads every sum to the host once, as it
ends, into the recorder's `counts` (lists). While recording is off a call
checks the one module-level name.

| counter | where | value |
| --- | --- | --- |
| `k3m.moe.expert_rows` | each MoE layer's forward | the rows routed to each held expert, [held experts] |
| `k3m.moe.rows` | each MoE layer's forward | the held (row, expert) pairs computed, [1] |
| `k3m.moe.pairs` | each MoE layer's forward | the sort's capacity: every (row, choice) pair of the layer, [1], on the host |
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

# the recorder while recording is on; None is the off switch `span` checks
_recorder: Optional["Recorder"] = None
_stacks = threading.local()


class Recorder:
    """What one recording holds: finished spans (dicts, in the order they
    closed), the recording thread and its start and end."""

    def __init__(self):
        self.spans: List[Dict] = []
        self.thread = threading.get_native_id()
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None
        self._ids = itertools.count(1)
        self.counters: Dict[str, torch.Tensor] = {}   # running sums, on the device
        self.counts: Dict[str, list] = {}             # their values, read at the end


def _attr(value):
    if isinstance(value, torch.Tensor):
        return dict(shape=list(value.shape), dtype=str(value.dtype).removeprefix("torch."))
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    return value


class _Span:
    __slots__ = ("rec", "record", "_rf")

    def __init__(self, rec: Recorder, name: str, attrs: Dict):
        self.rec = rec
        self.record = dict(id=next(rec._ids), name=name, tid=threading.get_native_id(),
                           parent=None, start_ns=0, end_ns=0,
                           attrs={k: _attr(v) for k, v in attrs.items()})

    def set(self, **attrs) -> None:
        self.record["attrs"].update((k, _attr(v)) for k, v in attrs.items())

    @property
    def seconds(self) -> float:
        return (self.record["end_ns"] - self.record["start_ns"]) * 1e-9

    def __enter__(self):
        stack = getattr(_stacks, "open", None)
        if stack is None:
            stack = _stacks.open = []
        if stack:
            self.record["parent"] = stack[-1].record["id"]
        self._rf = torch.profiler.record_function(self.record["name"])
        # the span holds the annotation's entry and exit: the profiler takes
        # the annotation's start as it is entered, before the entry's own
        # cost (a millisecond or more for the first in a process), and both
        # release the GIL, which another Python thread may then hold for
        # milliseconds before this one runs on
        self.record["start_ns"] = time.time_ns()
        self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stacks.open.pop()
        self._rf.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        self.rec.spans.append(self.record)
        return False


class _Off:
    """The span while recording is off: enters, sets and times nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def span(name: str, **attrs):
    """A context manager timing `name` (module docstring); the shared no-op
    while recording is off."""
    if _recorder is None:
        return OFF
    return _Span(_recorder, name, attrs)


def spanned(name: str, arguments: bool = False):
    """Decorate a function so that each call is the span `name`; with
    `arguments`, the span's attributes are the call's arguments by name.
    While recording is off a call costs one flag check more."""
    def wrap(fn):
        signature = inspect.signature(fn) if arguments else None

        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _recorder
            if rec is None:
                return fn(*args, **kwargs)
            attrs = signature.bind(*args, **kwargs).arguments if arguments else {}
            with _Span(rec, name, attrs):
                return fn(*args, **kwargs)
        return call
    return wrap


def on() -> bool:
    return _recorder is not None


def count(name: str, value) -> None:
    """Add `value` to the recording's sum of `name` (module docstring): a
    tensor, summed on its device, or an int the host already knows, summed
    on the host; nothing while recording is off."""
    rec = _recorder
    if rec is None:
        return
    value = torch.tensor([value]) if isinstance(value, int) else value.detach()
    held = rec.counters.get(name)
    rec.counters[name] = value.clone() if held is None else held + value


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every thread's spans into one new Recorder until the block
    ends; one recording at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("trace: a recording is already on")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None
        rec.end_ns = time.time_ns()
        rec.counts = {k: v.tolist() for k, v in rec.counters.items()}
        rec.counters.clear()
