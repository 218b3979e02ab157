"""The random streams of one forward in training.

The JAX package draws its dropout bits, attention-kernel seeds, Gumbel
noise and LPM negatives from `fold_in(base_rng, step)` (k3m_tpu/train/
pretrain_loop.py:202-209), so a resumed run redraws the same noise. Here
one `StepRandom` per step holds a `torch.Generator` for each stream, all
keyed by (seed, step) through numpy's SeedSequence. The model's modules
take them from the `StepRandom` made active by `use(...)` for the span of
one forward; `deterministic=False` without one raises. The bits are not
the JAX package's: the tests inject noise where they compare the two.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("k3m_step_random", default=None)


class StepRandom:
    """Generators of one step on `device`: `dropout` (hidden dropout bits),
    `gumbel`, `lpm` (negative sampling) on the device, and a CPU generator
    for the attention kernels' Philox seeds, so that drawing a seed never
    waits for the card."""

    def __init__(self, seed: int, step: int, device="cpu"):
        dev = torch.device(device)
        states = np.random.SeedSequence([int(seed), int(step)]).generate_state(4, np.uint64)
        seeds = [int(s) & (2 ** 63 - 1) for s in states]
        self.dropout = torch.Generator(device=dev).manual_seed(seeds[0])
        self.gumbel = torch.Generator(device=dev).manual_seed(seeds[1])
        self.lpm = torch.Generator(device=dev).manual_seed(seeds[2])
        self._seeds = torch.Generator().manual_seed(seeds[3])

    def kernel_seed(self) -> int:
        """A fresh Philox seed in [0, 2^31 - 1) for one attention call."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self._seeds))


@contextlib.contextmanager
def use(rng: Optional[StepRandom]):
    """Make `rng` the active StepRandom for the enclosed forward."""
    token = _ACTIVE.set(rng)
    try:
        yield rng
    finally:
        _ACTIVE.reset(token)


def active() -> StepRandom:
    rng = _ACTIVE.get()
    if rng is None:
        raise RuntimeError("deterministic=False needs an active StepRandom "
                           "(k3m_tpu_torch.model.random.use)")
    return rng
