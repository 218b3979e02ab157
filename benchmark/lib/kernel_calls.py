"""The shapes of the port's kernel-function calls, recorded where the model
calls them: while `record()` is active, each of the five functions is
wrapped at the module attribute its callers read, and every call adds
(function, bound seconds) to a list. The wrappers cost host time only, so
they are on in the traced steps alone. A function that is not where the
wrapper looks for it is left out (`missing`)."""

from __future__ import annotations

import contextlib
import importlib
from typing import List, Tuple

import torch

from benchmark.lib import bounds

# (module, attribute, function): where the model's code reads each function
SITES = (
    ("k3m_tpu_torch.model.layers", "fused_layernorm", "fused_layernorm"),
    ("k3m_tpu_torch.model.layers", "fused_attention", "fused_attention"),
    ("k3m_tpu_torch.model.coattention", "fused_biattention", "fused_biattention"),
    ("k3m_tpu_torch.kernels.layernorm", "layernorm_bwd", "layernorm_bwd"),
    ("k3m_tpu_torch.kernels.attention", "attention_bwd", "attention_bwd"),
    ("k3m_tpu_torch.kernels.coattn", "attention_bwd", "attention_bwd"),
)


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _bound(function, args, kwargs) -> float:
    if function == "fused_layernorm":
        x, scale, bias = args[:3]
        residual = args[3] if len(args) > 3 else kwargs.get("residual")
        return bounds.layernorm_fwd(x, scale, bias, residual, kwargs.get("out_dtype"),
                                    _grad(x, residual, scale, bias))
    if function == "fused_attention":
        q, k, v, bias = args[:4]
        return bounds.attention_fwd(q, k, v, bias, kwargs.get("dropout_rate", 0.0),
                                    _grad(q, k, v))
    if function == "fused_biattention":
        q1, k1, v1, bias1, q2, k2, v2, bias2 = args[:8]
        return bounds.biattention_fwd(q1, k1, v1, bias1, q2, k2, v2, bias2,
                                      kwargs.get("dropout1", 0.0), kwargs.get("dropout2", 0.0),
                                      _grad(q1, k1, v1, q2, k2, v2))
    if function == "layernorm_bwd":
        return bounds.layernorm_bwd(*args[:6])
    if function == "attention_bwd":
        return bounds.attention_bwd(*args[:8])
    raise KeyError(function)


class Recorder:
    def __init__(self):
        self.calls: List[Tuple[str, float]] = []
        self.missing: List[str] = []


@contextlib.contextmanager
def record():
    rec = Recorder()
    saved = []
    for mod_name, attr, function in SITES:
        try:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
        except (ImportError, AttributeError):
            rec.missing.append(f"{mod_name}.{attr}")
            continue

        def wrapper(*args, _orig=orig, _fn=function, **kwargs):
            rec.calls.append((_fn, _bound(_fn, args, kwargs)))
            return _orig(*args, **kwargs)

        # the function's own attributes (its launch counters, which its body
        # increments through the module global this wrapper replaces)
        wrapper.__dict__ = orig.__dict__
        setattr(mod, attr, wrapper)
        saved.append((mod, attr, orig))
    try:
        yield rec
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
