"""Device-resident epoch cache: the first epoch's staged batches kept on the
card, later epochs replayed from there with no host->card traffic.

Port of k3m_tpu/train/device_cache.py. What it trades, as there: the host
loader draws fresh MLM, pv and RoI masks each epoch; a cached epoch replays
the first epoch's draws (the batch order is still permuted per epoch), the
static masking of BERT's original pretraining data. Hence opt-in:
`--device_cache` or K3M_DEVICE_CACHE=1.

Budget: the staged bytes are counted against K3M_DEVICE_CACHE_MB (MB of
1e6 bytes) if set, else 70% of the card's free memory. An epoch that does
not fit makes the cache drop what it held, log a warning, and stream every
epoch through the loader from then on (the JAX package's documented
fallback, device_cache.py:23-29), never run the card out of memory.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from k3m_tpu_torch.train.wire import wire_bytes

logger = logging.getLogger(__name__)


def budget_bytes(device: torch.device) -> int:
    """K3M_DEVICE_CACHE_MB if set, else 70% of the CUDA device's free memory
    (2 GB on the CPU, as the JAX package takes where the device reports no
    memory)."""
    env = os.environ.get("K3M_DEVICE_CACHE_MB")
    if env:
        return int(float(env) * 1e6)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(0.7 * free)
    return 2_000_000_000


def cache_enabled(explicit: Optional[bool]) -> bool:
    """`explicit`, else K3M_DEVICE_CACHE=1."""
    if explicit is not None:
        return bool(explicit)
    return bool(int(os.environ.get("K3M_DEVICE_CACHE", "0")))


class DeviceEpochCache:
    """Iterable: the first whole pass stages the loader's batches with
    `stage` and keeps them; later passes yield the kept batches in an order
    permuted by (seed, epoch). Set `.epoch` before each pass, as the
    trainers' fit does. A pass that stops early keeps nothing."""

    def __init__(self, loader: Iterable, stage: Callable, *,
                 max_bytes: Optional[int] = None, seed: int = 0, device=None):
        self._loader = loader
        self._stage = stage
        self.max_bytes = max_bytes
        self._seed = seed
        self._device = torch.device(device) if device is not None else torch.device("cpu")
        self._cache = None          # the staged batches, once a pass completed
        self._disabled = False      # over budget: stream from then on
        self.bytes = 0
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self._epoch = int(value)
        if hasattr(self._loader, "epoch"):
            # the build pass and a fallback stream draw as the loader's epoch
            self._loader.epoch = value

    @property
    def cached(self) -> bool:
        return self._cache is not None

    def __iter__(self):
        if self._cache is not None:
            order = np.random.default_rng([self._seed, self._epoch]).permutation(
                len(self._cache))
            for i in order:
                yield self._cache[i]
            return
        if self.max_bytes is None:
            self.max_bytes = budget_bytes(self._device)
        building = None if self._disabled else []
        n = 0
        for batch in self._loader:
            staged = self._stage(batch)
            n += 1
            if building is not None:
                building.append(staged)
                self.bytes += wire_bytes(staged)
                if self.bytes > self.max_bytes:
                    logger.warning(
                        "device_cache: the epoch exceeds the budget after %d batches "
                        "(%.0f MB > %.0f MB); falling back to streaming every epoch",
                        n, self.bytes / 1e6, self.max_bytes / 1e6)
                    building, self._disabled, self.bytes = None, True, 0
            yield staged
        if building is not None and n > 0:
            self._cache = building
            logger.info("device_cache: %d batches resident (%.0f MB of a %.0f MB budget); "
                        "later epochs replay them", n, self.bytes / 1e6, self.max_bytes / 1e6)
