"""The pinned slot pool that staging fills batches into on a CUDA device
(k3m_tpu_torch/train/slots.py, `trainer.fill_slot`), on the CPU with
pinning off and an event of the test's own:

  * every array filled into a slot equals `wire_batch`'s bit for bit, in
    dtype and shape, under each wire, for a pair batch and a pretraining
    batch, at SLOT_ALIGN-aligned offsets of the slot, whether the small
    arrays are copied on the calling thread or by `copy_`;
  * the pool allocates once for a shape and reuses after; a larger batch
    grows a slot, a smaller one reuses it; a new thread reuses the slots of
    one that ended;
  * a slot whose event is not done is never handed out: the pool takes
    another slot or waits on the event, also under many threads.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.train.alignment_loop import ITEM_KEYS
from k3m_tpu_torch.train import trainer
from k3m_tpu_torch.train.pretrain_loop import BATCH_KEYS, INJECT_KEYS
from k3m_tpu_torch.train.slots import SlotPool
from k3m_tpu_torch.train.trainer import (
    SLOT_ALIGN, fill_slot, host_array, plan_bytes, wire_batch, wire_plan,
)
from tests.conftest import NANO, make_nano_batch

CFG = K3MConfig.from_dict(dict(NANO.to_dict(), dtype="bfloat16"))


class Event:
    """A CUDA event's part the pool uses: in flight from `record` until
    `synchronize` (or the test) completes it."""

    def __init__(self):
        self.done, self.waits = True, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += not self.done
        self.done = True

    def record(self, stream=None):
        self.done = False


def _pool(max_slots=4):
    return SlotPool(pin=False, new_event=Event, max_slots=max_slots)


def _plans(kind, wire):
    """(plan, wire form) of a NANO batch as its stager makes them."""
    if kind == "pretrain":
        batch, keys = make_nano_batch(B=4, seed=1), BATCH_KEYS + INJECT_KEYS
        return wire_plan(batch, keys, CFG, wire), wire_batch(batch, keys, CFG, wire)
    items = {side: make_nano_batch(B=4, seed=s) for s, side in ((2, "item1"), (3, "item2"))}
    label = np.arange(4, dtype=np.float32) % 2
    plan = dict(label=host_array("label", label),
                **{k: wire_plan(v, ITEM_KEYS, CFG, wire) for k, v in items.items()})
    wired = dict(label=torch.from_numpy(label),
                 **{k: wire_batch(v, ITEM_KEYS, CFG, wire) for k, v in items.items()})
    return plan, wired


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("small_copy", [trainer.SMALL_COPY, 0])
@pytest.mark.parametrize("kind", ["pair", "pretrain"])
@pytest.mark.parametrize("wire", ["exact", "fp", "int8"])
def test_slot_fill_equals_the_wire_form_bit_for_bit(kind, wire, small_copy, monkeypatch):
    monkeypatch.setattr(trainer, "SMALL_COPY", small_copy)   # 0: every array by copy_
    plan, wired = _plans(kind, wire)
    pool = _pool()
    slot, reused = pool.acquire(plan_bytes(plan, aligned=True))
    filled = _flat(fill_slot(slot.buf, plan))
    pool.release(slot)
    want = _flat(wired)
    assert filled.keys() == want.keys()
    base = slot.buf.data_ptr()
    for key, t in filled.items():
        w = want[key]
        assert (t.dtype, t.shape) == (w.dtype, w.shape), key
        assert torch.equal(t.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), key
        assert t.untyped_storage().data_ptr() == slot.buf.untyped_storage().data_ptr()
        assert (t.data_ptr() - base) % SLOT_ALIGN == 0
    assert plan_bytes(plan) == sum(t.numel() * t.element_size() for t in want.values())
    feat = "item1.image_feat" if kind == "pair" else "image_feat"
    assert filled.get(feat, filled.get(feat + "_q")).dtype == dict(
        exact=torch.float32, fp=torch.bfloat16, int8=torch.int8)[wire]


def test_slot_pool_allocates_once_then_reuses_and_grows():
    pool = _pool()

    def take(n):
        slot, reused = pool.acquire(n)
        pool.release(slot)
        slot.event.done = True          # its copies completed
        return slot, reused

    first, reused = take(1000)
    assert not reused and first.nbytes == 1000
    assert take(1000) == (first, True)
    assert take(5000) == (first, False) and first.nbytes == 5000
    assert take(3000) == (first, True) and first.nbytes == 5000
    got = []
    for _ in range(2):          # each thread starts after the last ended
        t = threading.Thread(target=lambda: got.append(take(5000)))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert got == [(first, True)] * 2 and pool.slots == [first]


def test_slot_pool_never_hands_out_a_slot_in_flight():
    pool = _pool(max_slots=2)
    a, _ = pool.acquire(100)
    pool.release(a)                     # its copies in flight
    b, reused = pool.acquire(100)       # room for another: a is left alone
    assert b is not a and not reused and (a.event.waits, a.event.done) == (0, False)
    pool.release(b)
    c, reused = pool.acquire(100)       # the pool is full: wait on the first
    assert c.event.waits == 1 and reused and c.event.done
    pool.release(c)

    # many threads, two slots: a slot is held by one thread at a time and
    # only once its copies are done
    pool, holders, errors = _pool(max_slots=2), {}, []
    lock = threading.Lock()

    def work():
        for i in range(300):
            n = 64 * (1 + i % 3)
            slot, _ = pool.acquire(n)
            with lock:
                if holders.get(id(slot)) or not slot.event.query() or slot.nbytes < n:
                    errors.append(id(slot))
                holders[id(slot)] = True
            slot.buf[:n].fill_(i % 256)         # the stager's fill
            with lock:
                holders[id(slot)] = False
            pool.release(slot)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(pool.slots) == 2
