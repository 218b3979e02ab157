"""Pinned host slots that batches cross to a CUDA device through, reused
batch after batch.

Staging a batch (trainer.stage_batch) writes its wire form in one pass into
a slot, one pinned byte buffer, and copies it to the card from there: no
new host tensor is made and nothing is pinned array by array. A slot
carries a CUDA event, recorded on the staging stream once the batch's
copies are enqueued; a slot is handed out again only once that event has
completed, so a later batch never overwrites bytes that a copy may still
read.

`SlotPool.acquire(nbytes)` takes a free slot that is big enough and whose
copies are done. Otherwise it grows a free slot that is done but too small
(a new buffer of `nbytes`), else adds a slot while the pool holds fewer
than `MAX_SLOTS`, else waits on the event of a free slot. One lock guards
the pool, so the staging producer thread (a new one every epoch) and the
main thread's evaluate or predict share the same slots.

One pool per CUDA device and process (`pool_for`). Pinned host memory it
holds: in steady state one or two slots of a batch's wire bytes each, as
PyTorch's pinned allocator rounds them up: about 2 x 310 MB for a B1024
pair batch and about 2 x 60 MB for a B96 pretraining batch under the `fp`
wire; never more than `MAX_SLOTS` slots.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_SLOTS = 4


class Slot:
    """A pinned byte buffer (`buf`, None until first sized), the event
    recorded after the last copies from it, and whether a stager holds it."""

    __slots__ = ("buf", "event", "busy")

    def __init__(self, event):
        self.buf: Optional[torch.Tensor] = None
        self.event = event
        self.busy = True

    @property
    def nbytes(self) -> int:
        return 0 if self.buf is None else self.buf.numel()


class SlotPool:
    """Slots of one device (module docstring). `pin=False` and an event
    class of the caller's (`query`, `synchronize`, `record(stream)`) make a
    pool that runs without a card."""

    def __init__(self, pin: bool = True, new_event: Callable = torch.cuda.Event,
                 max_slots: int = MAX_SLOTS):
        self.pin = pin
        self.max_slots = max_slots
        self.slots: List[Slot] = []
        self._new_event = new_event
        self._cond = threading.Condition()

    def _choose(self, nbytes: int) -> Tuple[Slot, bool]:
        """(slot, grow) under the lock, or (None, False) where every slot
        is held."""
        free = sorted((s for s in self.slots if not s.busy), key=lambda s: s.nbytes)
        fits = [s for s in free if s.nbytes >= nbytes]
        done = [s for s in fits if s.event.query()]
        if done:
            return done[0], False
        small = [s for s in free if s.nbytes < nbytes and s.event.query()]
        if small:
            return small[-1], True
        if len(self.slots) < self.max_slots:
            slot = Slot(self._new_event())
            self.slots.append(slot)
            return slot, True
        if fits:
            return fits[0], False
        return (free[-1], True) if free else (None, False)

    def acquire(self, nbytes: int) -> Tuple[Slot, bool]:
        """A slot of at least `nbytes` with no copy from it in flight, held
        until `release`; and whether it was reused (no allocation)."""
        with self._cond:
            slot, grow = self._choose(nbytes)
            while slot is None:
                self._cond.wait()
                slot, grow = self._choose(nbytes)
            slot.busy = True
        try:
            slot.event.synchronize()
            if grow:
                slot.buf = None
                slot.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
        except BaseException:
            self.release(slot)
            raise
        return slot, not grow

    def release(self, slot: Slot, stream=None) -> None:
        """Record the slot's event on `stream` (after the copies from it
        were enqueued there; the current stream where None) and hand the
        slot back."""
        with self._cond:
            slot.event.record(stream)
            slot.busy = False
            self._cond.notify()


_pools: Dict[torch.device, SlotPool] = {}
_pools_lock = threading.Lock()


def pool_for(device: torch.device) -> SlotPool:
    """The process's slot pool of the CUDA device `device`."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = torch.device(device.type, index)
    with _pools_lock:
        if key not in _pools:
            _pools[key] = SlotPool()
        return _pools[key]
