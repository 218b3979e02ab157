"""Training metrics log: `metrics.jsonl`, and tensorboardX event files where
that package imports.

Port of k3m_tpu/utils/metrics.py (the reference's tbLogger,
vilbert_k3m/utils.py:151-536): one JSON row per call, {"step", "wall_s",
"prefix", <metric>: float, ...}. Callers pass floats they already hold, so
logging adds no device synchronisation of its own.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

try:
    from tensorboardX import SummaryWriter
except ImportError:          # optional: event files only where tensorboardX is installed
    SummaryWriter = None


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = SummaryWriter(log_dir) if SummaryWriter is not None else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train") -> None:
        row = {"step": int(step), "wall_s": round(time.time() - self._t0, 3),
               "prefix": prefix}
        for k, v in metrics.items():
            row[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))
        self._jsonl.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
