"""The host->card wire: the two largest tensors of a batch quantized on the
host, dequantized on the card at the start of the step.

Port of k3m_tpu/train/wire.py. Per pretraining batch of 96 at the
reference shapes:

  image_feat    [96, 37, 2048] fp32 = 29.1 MB   (bf16 under `fp`: 14.5 MB)
  image_target  [96, 36, 1601] fp32 = 22.1 MB   (fp16 under `fp`: 11.1 MB)

`int8` cuts them to

  image_feat   -> per-row (per region) symmetric int8, q = round(x / s),
                  s = max|row| / 127: an error of at most 1/254 of the row's
                  largest value, the order of the bf16 rounding the model
                  applies to the features first;
  image_target -> the detector's 1601-way probability rows (visual_target
                  0): per-row uint8, q = round(p / s), s = rowmax / 255;
                  on the card the row is renormalized to sum 1.

Modes (`wire=` of the trainers, else the K3M_WIRE environment variable):
  "fp"    (default) image_feat in the compute dtype, the soft labels in
          fp16 under bf16 (trainer.wire_dtype); K3M_EXACT_TARGETS=1 keeps
          the labels fp32;
  "int8"  the scheme above (the labels stay fp32 under K3M_EXACT_TARGETS=1);
  "exact" fp32 everything.

`encode_*` run on the host, in numpy, on the staging thread; `decode` is
plain torch ops on the card inside the step, so the quantized form is what
crosses the wire and what a device cache keeps.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

FEAT_Q = "image_feat_q"
FEAT_S = "image_feat_s"
TGT_Q = "image_target_q"
TGT_S = "image_target_s"
MODES = ("fp", "int8", "exact")


def wire_mode(explicit: Optional[str] = None) -> str:
    """`explicit`, else K3M_WIRE, else "fp" (k3m_tpu/train/wire.py:53-57)."""
    mode = explicit or os.environ.get("K3M_WIRE", "fp")
    if mode not in MODES:
        raise ValueError(f"unknown wire mode {mode!r} (fp | int8 | exact)")
    return mode


def exact_targets() -> bool:
    """K3M_EXACT_TARGETS set (to anything but empty): the soft labels cross
    in fp32 under every wire (k3m_tpu/train/pretrain_loop.py:339-341)."""
    return bool(os.environ.get("K3M_EXACT_TARGETS"))


def encode_feat(feat: np.ndarray):
    """fp32 [..., D] -> (int8 [..., D], fp32 scale [...])."""
    feat = np.asarray(feat, np.float32)
    s = np.abs(feat).max(axis=-1) / 127.0
    s = np.maximum(s, 1e-12).astype(np.float32)
    q = np.clip(np.rint(feat / s[..., None]), -127, 127).astype(np.int8)
    return q, s


def encode_probs(p: np.ndarray):
    """fp32 probability rows [..., K] -> (uint8 [..., K], fp32 scale [...])."""
    p = np.asarray(p, np.float32)
    s = p.max(axis=-1) / 255.0
    s = np.maximum(s, 1e-12).astype(np.float32)
    q = np.clip(np.rint(p / s[..., None]), 0, 255).astype(np.uint8)
    return q, s


def encode_pretrain(batch: Dict[str, np.ndarray], *, quantize_target: bool
                    ) -> Dict[str, np.ndarray]:
    """image_feat (and, with `quantize_target`, image_target) replaced by
    their wire forms."""
    out = dict(batch)
    if "image_feat" in out:
        out[FEAT_Q], out[FEAT_S] = encode_feat(out.pop("image_feat"))
    if quantize_target and "image_target" in out:
        out[TGT_Q], out[TGT_S] = encode_probs(out.pop("image_target"))
    return out


def decode(batch: Dict, dtype: torch.dtype) -> Dict:
    """Inverse of encode_* on staged tensors: image_feat in `dtype`, the
    soft labels fp32 renormalized per row (k3m_tpu/train/wire.py:89-108).
    A batch without wire forms passes through."""
    if FEAT_Q not in batch and TGT_Q not in batch:
        return batch
    out = dict(batch)
    if FEAT_Q in out:
        q, s = out.pop(FEAT_Q), out.pop(FEAT_S)
        out["image_feat"] = q.to(dtype) * s[..., None].to(dtype)
    if TGT_Q in out:
        q, s = out.pop(TGT_Q), out.pop(TGT_S)
        t = q.float() * s[..., None]
        # true soft-label rows sum to 1; renormalizing removes the
        # quantization's bias from the KL target
        out["image_target"] = t / t.sum(-1, keepdim=True).clamp_min(1e-12)
    return out


def wire_bytes(batch: Dict) -> int:
    """Bytes of a batch's arrays or tensors (nested dicts), what crosses the
    wire for a staged batch."""
    total = 0
    for v in batch.values():
        if isinstance(v, dict):
            total += wire_bytes(v)
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif hasattr(v, "nbytes"):
            total += v.nbytes
    return total
