"""Background batch staging: host-to-device copies on a producer thread.

Port of k3m_tpu/train/prefetch.py:28-76. A daemon thread stages up to
`depth` batches ahead into a bounded queue, so the copy of batch N+1
overlaps the compute of batch N, as the reference's pinned-memory
`.cuda(non_blocking=True)` feed does (train_concap_struc.py:472-475).

On a CUDA device the producer stages on a side stream of its own (the
trainers' `stage` copies from pinned memory, non-blocking) and records an
event after each batch; the consumer makes its current stream wait on that
event before it hands the batch out, and records every staged tensor on
that stream, so that the caching allocator does not reuse a tensor's
memory while the compute stream may still read it. On the CPU it stages
with no stream. The consumer's wait for a staged batch is the span
`k3m.data_wait` (utils/trace.py).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

from k3m_tpu_torch.utils import trace

_DONE = object()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def staged_prefetch(loader: Iterable, stage: Callable, depth: Optional[int] = None,
                    device=None) -> Iterator:
    """Yield `stage(batch)` for each batch of `loader`, staging up to
    `depth` batches ahead on a background thread (default 2;
    K3M_PREFETCH_DEPTH overrides). `device`: where `stage` puts the batch;
    a CUDA device stages on a side stream (module docstring).

    Exceptions raised by the loader or by `stage` surface in the consumer;
    closing the generator (or dropping it) stops the producer instead of
    leaving it blocked on a full queue holding staged batches.
    """
    if depth is None:
        # depth < 1 would deadlock a zero-capacity queue
        depth = max(1, int(os.environ.get("K3M_PREFETCH_DEPTH", "2")))
    device = torch.device(device) if device is not None else torch.device("cpu")
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _stage(batch):
        if side is None:
            return stage(batch), None
        with torch.cuda.stream(side):
            staged = stage(batch)
            event = torch.cuda.Event()
            event.record(side)
        return staged, event

    def produce():
        try:
            for batch in loader:
                if not _put(_stage(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            err.append(e)
        finally:
            _put(_DONE)

    t = threading.Thread(target=produce, daemon=True, name="k3m-stage")
    t.start()
    try:
        while True:
            # the wait is closed before the yield: the consumer's step runs
            # outside it
            with trace.span("k3m.data_wait"):
                item = q.get()
                if item is _DONE:
                    if err:
                        raise err[0]
                    return
                staged, event = item
                if event is not None:
                    compute = torch.cuda.current_stream(device)
                    compute.wait_event(event)
                    for x in _tensors(staged):
                        if x.is_cuda:
                            x.record_stream(compute)
            yield staged
    finally:
        stop.set()
