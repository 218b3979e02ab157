"""The random streams of one forward in training.

The JAX package draws its dropout bits, attention-kernel seeds, Gumbel
noise and LPM negatives from `fold_in(base_rng, step)` (k3m_tpu/train/
pretrain_loop.py:202-209), so a resumed run redraws the same noise. Here
one `StepRandom` per step holds a `torch.Generator` for each stream, all
keyed by (seed, step) through numpy's SeedSequence, or by (seed, step,
3 + i) for microbatch i of an in-step microbatched step (the JAX trainers'
fold_in(rng, 3 + i); SeedSequence pads its entropy with zeros, so a third
word of 0 would repeat the whole step's draws). The model's modules
take them from the `StepRandom` made active by `use(...)` for the span of
one forward; `deterministic=False` without one raises. The bits are not
the JAX package's: the tests inject noise where they compare the two.

Under data parallelism (k3m_tpu_torch/dist.py) every rank's StepRandom is the same,
and a draw that spans the batch (`rows_rand`, `rows_randint`: hidden
dropout bits, Gumbel noise, LPM and NCE indices) is made at the shape of
the global batch and sliced to this rank's rows, so that N ranks draw what
one process draws for their concatenated batch. That costs N times the
random bytes of the rank's own rows (a counter-based draw per row would
not). The attention kernels' seeds come from the CPU generator, the same
on every rank; the kernels key their masks by the global row.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch

from . import dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("k3m_step_random", default=None)


class StepRandom:
    """Generators of one step on `device`: `dropout` (hidden dropout bits),
    `gumbel`, `lpm` (negative sampling) on the device, and a CPU generator
    for the attention kernels' Philox seeds, so that drawing a seed never
    waits for the card."""

    def __init__(self, seed: int, step: int, device="cpu", micro: Optional[int] = None):
        dev = torch.device(device)
        key = [int(seed), int(step)] + ([] if micro is None else [3 + int(micro)])
        states = np.random.SeedSequence(key).generate_state(4, np.uint64)
        seeds = [int(s) & (2 ** 63 - 1) for s in states]
        self.dropout = torch.Generator(device=dev).manual_seed(seeds[0])
        self.gumbel = torch.Generator(device=dev).manual_seed(seeds[1])
        self.lpm = torch.Generator(device=dev).manual_seed(seeds[2])
        self._seeds = torch.Generator().manual_seed(seeds[3])

    def kernel_seed(self) -> int:
        """A fresh Philox seed in [0, 2^31 - 1) for one attention call."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self._seeds))


def _rows(full: torch.Tensor, spans) -> torch.Tensor:
    if len(spans) == 1:
        row0, n = spans[0]
        return full[row0:row0 + n]
    return torch.cat([full[row0:row0 + n] for row0, n in spans])


def rows_rand(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform [0, 1) noise of `shape` [B, ...] for this rank's B rows of
    the active world's global batch: drawn for every row, then sliced (for
    the copies of the batch that `dist.stacked` names, one slice a copy)."""
    spans, total = dist.windows(shape[0])
    return _rows(torch.rand((total,) + tuple(shape[1:]), device=device,
                            generator=generator), spans)


def rows_randint(generator: torch.Generator, high: int, shape, device,
                 dtype=torch.int64) -> torch.Tensor:
    """Integers in [0, high) of `shape` [B, ...], drawn as `rows_rand`."""
    spans, total = dist.windows(shape[0])
    return _rows(torch.randint(0, high, (total,) + tuple(shape[1:]), dtype=dtype,
                               device=device, generator=generator), spans)


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
