"""Checkpoints of the training state.

Port of k3m_tpu/train/state.py:99-167 (`CheckpointManager`):
  * `save` writes the full state (model, optimizer, scheduler, step,
    micro) with torch.save into `<dir>/epoch_<e>/state.pt`, overwriting
    as the reference's per-epoch torch.save does, and beside it the model
    alone in reference torch names, `epoch_<e>/pytorch_model.bin` (the
    counterpart of the JAX package's `params.msgpack`, state.py:116),
    which `convert.load_model_file` loads into another model;
  * `save_step` writes a mid-epoch full state into
    `<dir>/step_e<e>_s<k>/state.pt` (periodic `save_steps` or preemption;
    `k` batches of epoch `e` consumed, state.py:121-138);
  * each records itself in `latest.json`; `restore` loads the latest (or a
    given epoch's) state.
The Orbax layout of the JAX package is not reproduced.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

STATE_FILE = "state.pt"
MODEL_FILE = "pytorch_model.bin"


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, config=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config.to_json_string())

    def _save(self, state: dict, name: str, meta: dict, model_file: bool) -> str:
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        _save_atomic(state, os.path.join(path, STATE_FILE))
        if model_file:
            _save_atomic(state["model"], os.path.join(path, MODEL_FILE))
        self._write_latest(dict(meta, dir=name))
        return path

    def save(self, state: dict, epoch: int) -> str:
        """`state`: a dict of state dicts and scalars (Trainer.state_dict)."""
        return self._save(state, f"epoch_{epoch}", {"epoch": epoch}, model_file=True)

    def save_step(self, state: dict, epoch: int, in_epoch_step: int) -> str:
        """Mid-epoch full state after `in_epoch_step` batches of `epoch`;
        resuming is restore() + fit(start_epoch=epoch,
        start_step=in_epoch_step), exact because the loaders key their
        draws by (seed, epoch, index) and the trainer by its step."""
        return self._save(state, f"step_e{epoch}_s{in_epoch_step}",
                          {"epoch": epoch, "in_epoch_step": in_epoch_step},
                          model_file=False)

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
        """The state of epoch `epoch`, else of the directory `latest.json`
        names (an epoch's or a step checkpoint's); None without either."""
        if epoch is None:
            meta = self.latest()
            if meta is None:
                return None
            name = meta.get("dir", f"epoch_{meta['epoch']}")
        else:
            name = f"epoch_{epoch}"
        return torch.load(os.path.join(self.directory, name, STATE_FILE),
                          map_location=map_location, weights_only=False)
