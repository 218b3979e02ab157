"""Checkpoints of the training state.

Port of the per-epoch half of k3m_tpu/train/state.py:99-167
(`CheckpointManager`): `save` writes model, optimizer, scheduler and step
with torch.save into `<dir>/epoch_<e>/state.pt` (overwriting, as the
reference's per-epoch torch.save does) and records it in `latest.json`;
`latest` reads that record; `restore` loads the latest (or a given)
epoch's state. The Orbax layout of the JAX package is not reproduced.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, config=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config.to_json_string())

    def save(self, state: dict, epoch: int) -> str:
        """`state`: a dict of state dicts and scalars (PretrainTrainer.state_dict)."""
        name = f"epoch_{epoch}"
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        self._write_latest({"epoch": epoch, "dir": name})
        return path

    def _write_latest(self, meta: dict) -> None:
        tmp = os.path.join(self.directory, "latest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.directory, "latest.json"))

    def latest(self) -> Optional[dict]:
        meta = os.path.join(self.directory, "latest.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)

    def restore(self, epoch: Optional[int] = None, map_location="cpu") -> Optional[dict]:
        if epoch is None:
            meta = self.latest()
            if meta is None:
                return None
            name = meta.get("dir", f"epoch_{meta['epoch']}")
        else:
            name = f"epoch_{epoch}"
        return torch.load(os.path.join(self.directory, name, "state.pt"),
                          map_location=map_location, weights_only=False)
