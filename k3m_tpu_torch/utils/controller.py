"""Stop-on-plateau training controller.

Port of k3m_tpu/utils/controller.py (reference MultiTaskStopOnPlateau,
vilbert_k3m/utils.py:39-150): a ReduceLROnPlateau-shaped controller whose
output is an `in_stop` flag instead of an LR change. After `patience`
epochs without improvement the task pauses; it resumes when the metric
improves past `continue_threshold` relative to the best seen (a comparison
the reference always makes in mode "min"). Host-side Python, run between
epochs.
"""

from __future__ import annotations

from math import inf


class StopOnPlateau:
    def __init__(self, mode: str = "min", patience: int = 10,
                 continue_threshold: float = 0.005, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0, eps: float = 1e-8):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.continue_threshold = continue_threshold
        self.cooldown = cooldown
        self.eps = eps
        self.last_epoch = -1
        self.mode_worse = inf if mode == "min" else -inf
        self.best = self.mode_worse
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.in_stop = False

    def _is_better(self, a: float, best: float, mode: str, threshold: float) -> bool:
        """The reference's comparison (utils.py:120-131)."""
        if mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - threshold)
        if mode == "min":
            return a < best - threshold
        if self.threshold_mode == "rel":
            return a > best * (threshold + 1.0)
        return a > best + threshold

    @property
    def in_cooldown(self) -> bool:
        return self.cooldown_counter > 0

    def step(self, metric, epoch=None) -> bool:
        """Feed one (eval) metric; returns the updated in_stop flag."""
        current = float(metric)
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        if self._is_better(current, self.best, self.mode, self.threshold):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.in_cooldown:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.in_stop = True
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        elif self.in_stop and self._is_better(current, self.best, "min",
                                              self.continue_threshold):
            # the metric keeps improving while paused: resume (utils.py:105-109)
            self.in_stop = False
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.in_stop
